"""Not a metric: what the readers of the program's own spans and counters
share. The program (``cyclegan_tpu_torch.tracing``) keeps a ring of its
last roots, one entry each: the root's host ns, its spans' ns by path,
its counters and its kernel launches, and whether a profiler was
recording. A reader takes the entries of one root from the timed window:
the unprofiled ones, less the issue steps that ``drivers/train.py``
times after the window (the last ``len(host_issue_ms)``), the last
``steps`` (``calls``) of them, as many as the ring holds. Nothing where the program has no such module loaded
(a program without the spans) or the run is of another kind."""

import statistics
import sys

PROGRAM_TRACING = "cyclegan_tpu_torch.tracing"


def entries(records, kind, root):
    """The window's entries of root ``root``; None where there are none."""
    tracing = sys.modules.get(PROGRAM_TRACING)
    if tracing is None or records.get("kind") != kind:
        return None
    found = [e for e in tracing.entries()
             if e["name"] == root and not e["profiled"]]
    if kind == "train":
        found = found[:len(found) - len(records.get("host_issue_ms") or ())]
    n = records["steps" if kind == "train" else "calls"]
    return found[max(len(found) - n, 0):] or None


def median(values):
    values = list(values)
    return statistics.median(values) if values else None


def root_ms(records, kind, root):
    """The median host ms of the root over the window."""
    found = entries(records, kind, root)
    return median(e["ns"] / 1e6 for e in found) if found else None


def span_ms(records, kind, root, path):
    """The median host ms of span ``path`` under the root over the
    window."""
    found = entries(records, kind, root)
    return median(e["spans"][path] / 1e6 for e in found
                  if path in e["spans"]) if found else None
