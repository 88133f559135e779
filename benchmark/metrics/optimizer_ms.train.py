"""Host ms of the train step's optimizer work (span ``train_step`` ›
``optimizer``: zero_grad, the four updates, the batch-stat commit), the
median over the timed window's steps."""

from benchmark.metrics import _window


def read(records):
    return _window.span_ms(records, "train", "train_step", "optimizer")
