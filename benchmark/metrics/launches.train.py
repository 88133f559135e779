"""Hand-written kernel launches a train step (``kernels.launched()`` over
root ``train_step``), the median over the timed window's steps."""

from benchmark.metrics import _window


def read(records):
    steps = _window.entries(records, "train", "train_step")
    return _window.median(e["launches"] for e in steps) if steps else None
