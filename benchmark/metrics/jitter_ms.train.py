"""Host ms of the train step's preprocess (span ``train_step`` › ``jitter``),
the median over the timed window's steps."""

from benchmark.metrics import _window


def read(records):
    return _window.span_ms(records, "train", "train_step", "jitter")
