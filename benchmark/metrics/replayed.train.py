"""Share of the timed window's train steps that replayed the step's CUDA
graph (counter ``graph_replay`` of root ``train_step``), in %. Nothing
where no root in the program's ring captured or replayed a graph (a
program without the graph)."""

import sys

from benchmark.metrics import _window

COUNTERS = ("graph_replay", "graph_capture")


def read(records):
    steps = _window.entries(records, "train", "train_step")
    if not steps:
        return None
    ring = sys.modules[_window.PROGRAM_TRACING].entries()
    if not any(c in e["counters"] for e in ring for c in COUNTERS):
        return None
    replayed = sum(1 for e in steps if e["counters"].get("graph_replay"))
    return 100.0 * replayed / len(steps)
