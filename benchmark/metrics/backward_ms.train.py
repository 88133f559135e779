"""Host ms of the train step's backward (span ``train_step`` › ``backward``:
``surrogate.backward()``), the median over the timed window's steps."""

from benchmark.metrics import _window


def read(records):
    return _window.span_ms(records, "train", "train_step", "backward")
