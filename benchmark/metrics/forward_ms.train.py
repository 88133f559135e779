"""Host ms of the train step's forward (span ``train_step`` › ``forward``:
6 generator and 6 discriminator applications and the losses), the median
over the timed window's steps."""

from benchmark.metrics import _window


def read(records):
    return _window.span_ms(records, "train", "train_step", "forward")
