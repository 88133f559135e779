"""The reader of ``replayed.train`` on synthetic ring entries: the share
of the timed window's ``train_step`` roots that carry ``graph_replay``,
without the profiled entries and the issue steps timed after the window,
and nothing where no root of the ring captured or replayed a graph (a
program without the graph) or the program's tracing module is not
loaded."""

import sys
import types

import pytest

from benchmark import spec

MODULE = "cyclegan_tpu_torch.tracing"
BEFORE, STEPS, ISSUE, TRACED = 3, 8, 5, 3


def _entry(name, counters=None, profiled=False):
    return {"name": name, "ns": 1000, "profiled": profiled, "spans": {},
            "counters": dict(counters or {}), "launches": 0}


def _ring(window_counters):
    """A train run's ring: the first steps (eager, then the capture), the
    window's steps with ``window_counters`` in turn, the issue steps and
    the traced ones (each a replay, outside the window), each after its
    ``put``."""
    firsts = [{}, {"graph_capture": 1}, {"graph_replay": 1}][:BEFORE]
    outside = [{"graph_replay": 1}] * (ISSUE + TRACED)
    ring = []
    for i, counters in enumerate(firsts + window_counters + outside):
        profiled = i >= BEFORE + STEPS + ISSUE
        ring.append(_entry("put", {"sync": 2}, profiled))
        ring.append(_entry("train_step", counters, profiled))
    return ring


@pytest.fixture
def program(monkeypatch):
    """A stand-in for the program's tracing module holding a given ring."""
    module = types.ModuleType(MODULE)

    def load(ring):
        module.entries = lambda: list(ring)
        monkeypatch.setitem(sys.modules, MODULE, module)

    return load


def _records():
    return {"kind": "train", "steps": STEPS, "window_s": 1.0,
            "host_issue_ms": [5.0] * ISSUE}


READ = spec.metric_reader("replayed.train")


@pytest.mark.parametrize("replays,want", [(STEPS, 100.0), (6, 75.0),
                                          (0, 0.0)])
def test_share_of_the_windows_steps_that_replayed(program, replays, want):
    """The window's steps alone: every step outside it replays."""
    window = ([{"graph_replay": 1}] * replays
              + [{"graph_capture": 1}] * (STEPS - replays))
    program(_ring(window))
    assert READ(_records()) == pytest.approx(want)


def test_nothing_from_a_program_without_the_graph(program):
    """No root of the ring captured or replayed: the parent's program."""
    ring = [dict(e, counters={k: v for k, v in e["counters"].items()
                              if not k.startswith("graph_")})
            for e in _ring([{}] * STEPS)]
    program(ring)
    assert READ(_records()) is None


def test_nothing_without_the_programs_tracing(monkeypatch):
    monkeypatch.delitem(sys.modules, MODULE, raising=False)
    assert READ(_records()) is None


def test_nothing_from_an_empty_ring_or_a_stylize_run(program):
    program([])
    assert READ(_records()) is None
    program(_ring([{"graph_replay": 1}] * STEPS))
    assert READ({"kind": "stylize", "calls": 4, "window_s": 1.0}) is None
