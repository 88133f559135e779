"""Spans and counters at the port's layer boundaries, kept in memory.

``span(name)`` times a block on the host clock (``time.perf_counter_ns``).
Spans nest on a per-thread stack; a span opened with none open is a
**root**, and every span under it belongs to its root. When a root closes,
one entry goes into a ring of the last ``RING`` roots (``entries()``):

- ``id``: the root's number, shared by every span under it;
- ``name``, ``ns``: the root's name and host nanoseconds;
- ``spans``: host nanoseconds of each span under the root, summed by its
  path below the root (``"forward"``, or ``"stylize/h2d"`` two levels
  down);
- ``counters``: what ``count(name, n)`` added while the root was open;
- ``launches``: the hand-written kernel launches made while it was open
  (``kernels.launched()``);
- ``profiled``: whether a torch profiler was recording when it opened.

The ring is always on and touches no device: no tensor, no CUDA call, no
synchronize; a span costs a few microseconds of host time. While a torch
profiler records, each span also opens ``torch.profiler.record_function``
of its name, so it lands in the profiler's Chrome trace as a
``user_annotation`` event on the kernels' timeline; with the profiler off
nothing of the profiler is called (``record_function`` costs microseconds
even then).

Spans and what reads them (the benchmark's per-layer metrics, PERF.md §3):
root ``put`` (``trainer.py``, counter ``sync``); root ``train_step``
(``steps.py``) with ``jitter`` and ``optimizer``, and ``forward`` and
``backward`` where it runs eager, ``replay`` (counter ``graph_replay``)
where it replays its CUDA graph and ``capture`` (counter
``graph_capture``, and ``sync`` for its wait) where it captures it (its
``forward`` and ``backward`` under it); root ``stylize``
(``apps/inference.py``, counter ``sync``) with ``h2d``, ``forward``,
``d2h``; root ``request`` (``apps/server.py``) with ``decode``,
``resize``, ``stylize``, ``encode``, its ``Server-Timing``.
"""

from __future__ import annotations

import collections
import itertools
import threading
import time
from typing import Dict, List

import torch

from cyclegan_tpu_torch import kernels

RING = 2048

_ring: collections.deque = collections.deque(maxlen=RING)
_ids = itertools.count(1)


class _Stack(threading.local):
    def __init__(self):
        self.open: List["_Span"] = []


_STACK = _Stack()


class _Span:
    __slots__ = ("name", "path", "entry", "start", "launches", "record")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self) -> dict:
        stack = _STACK.open
        profiling = torch._C._autograd._profiler_enabled()
        if stack:
            parent = stack[-1]
            self.entry = parent.entry
            self.path = (self.name if parent.path is None
                         else f"{parent.path}/{self.name}")
        else:
            self.path = None
            self.entry = {"id": next(_ids), "name": self.name,
                          "spans": {}, "counters": {}, "profiled": profiling}
            self.launches = kernels.launched()
        self.record = None
        if profiling:
            self.record = torch.profiler.record_function(self.name)
            self.record.__enter__()
        stack.append(self)
        self.start = time.perf_counter_ns()
        return self.entry

    def __exit__(self, *exc) -> None:
        ns = time.perf_counter_ns() - self.start
        _STACK.open.pop()
        if self.record is not None:
            self.record.__exit__(*exc)
        entry = self.entry
        if self.path is not None:
            entry["spans"][self.path] = entry["spans"].get(self.path, 0) + ns
        else:
            entry["ns"] = ns
            entry["launches"] = kernels.launched() - self.launches
            _ring.append(entry)


def span(name: str) -> _Span:
    """A context manager timing its block as span ``name``; it gives the
    root's entry, complete once the root has closed."""
    return _Span(name)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to counter ``name`` of the open root (nothing where no
    span is open on this thread)."""
    stack = _STACK.open
    if stack:
        counters = stack[0].entry["counters"]
        counters[name] = counters.get(name, 0) + n


def entries() -> List[Dict]:
    """The ring's entries, oldest first."""
    return list(_ring)


def reset() -> None:
    """Empty the ring."""
    _ring.clear()


__all__ = ["RING", "span", "count", "entries", "reset"]
