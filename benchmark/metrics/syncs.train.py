"""Host waits for the card a train step: counter ``sync`` of a ``put`` and
its ``train_step`` together, the median over the timed window's steps."""

from benchmark.metrics import _window


def read(records):
    puts = _window.entries(records, "train", "put")
    steps = _window.entries(records, "train", "train_step")
    if not puts or not steps:
        return None
    return _window.median(p["counters"].get("sync", 0)
                          + s["counters"].get("sync", 0)
                          for p, s in zip(puts, steps))
