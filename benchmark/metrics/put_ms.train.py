"""Host ms of the trainer's ``_put`` (root ``put``: the batch pair's two
copies from pageable host memory to the card, each waiting for the
stream), the median over the timed window's steps."""

from benchmark.metrics import _window


def read(records):
    return _window.root_ms(records, "train", "put")
