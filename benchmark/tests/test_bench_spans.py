"""The readers of the program's spans and counters (``metrics/_window.py``
and the ten metrics on it), on synthetic ring entries: each returns the
timed window's median, without the profiled entries and the issue steps
timed after the window, and nothing where the program's tracing module is
not loaded. And the trace reader is blind to the spans: ``trace.read``
gives the same busy time and idle gaps with and without their
``user_annotation`` and ``gpu_user_annotation`` events. On the card
(marked ``card``): the ``sync`` counters of a train step and a stylize
call equal the synchronizing operations torch's sync debug mode reports.

    python3 -m pytest benchmark/tests/test_bench_spans.py -m card -s
"""

import statistics
import sys
import types

import pytest

from benchmark import spec, trace

MODULE = "cyclegan_tpu_torch.tracing"
TRAIN_SPANS = {"jitter_ms.train": "jitter", "forward_ms.train": "forward",
               "backward_ms.train": "backward",
               "optimizer_ms.train": "optimizer"}
STYLIZE_SPANS = {"h2d_ms.stylize": "h2d", "forward_ms.stylize": "forward",
                 "d2h_ms.stylize": "d2h"}
BEFORE, STEPS, ISSUE, TRACED = 3, 7, 5, 3
OUTSIDE = 1e9  # every entry outside the window reads this


def _entry(name, ms, spans=(), sync=0, launches=0, profiled=False):
    return {"name": name, "ns": int(ms * 1e6), "profiled": profiled,
            "spans": {s: int(ms * 1e6) // 8 for s in spans},
            "counters": {"sync": sync} if sync else {},
            "launches": launches}


def _train_ring():
    """A train run's ring: the first steps, the window's, the issue steps
    (unprofiled) and the traced ones (profiled); (ring, the window's
    put ms, step ms, syncs, launches)."""
    ring, window = [], {"put": [], "step": [], "syncs": [], "launches": []}
    for i in range(BEFORE + STEPS + ISSUE + TRACED):
        inside = BEFORE <= i < BEFORE + STEPS
        put_ms, step_ms = (1.0 + i, 100.0 + 3 * i) if inside else (
            OUTSIDE, OUTSIDE)
        put_sync, step_sync = (2, i % 2) if inside else (50, 50)
        launches = 800 + i if inside else 10 ** 6
        profiled = i >= BEFORE + STEPS + ISSUE
        ring.append(_entry("put", put_ms, sync=put_sync, profiled=profiled))
        ring.append(_entry("train_step", step_ms, TRAIN_SPANS.values(),
                           step_sync, launches, profiled))
        if inside:
            window["put"].append(put_ms)
            window["step"].append(step_ms)
            window["syncs"].append(put_sync + step_sync)
            window["launches"].append(launches)
    return ring, window


def _stylize_ring(calls):
    ring, window = [], []
    for i in range(2 + calls + 10):  # warm-up, window, traced
        inside = 2 <= i < 2 + calls
        ms = 20.0 + i if inside else OUTSIDE
        ring.append(_entry("stylize", ms, STYLIZE_SPANS.values(), sync=2,
                           profiled=i >= 2 + calls))
        if inside:
            window.append(ms)
    return ring, window


@pytest.fixture
def program(monkeypatch):
    """A stand-in for the program's tracing module holding a given ring."""
    module = types.ModuleType(MODULE)

    def load(ring):
        module.entries = lambda: list(ring)
        monkeypatch.setitem(sys.modules, MODULE, module)

    return load


def _train_records():
    return {"kind": "train", "steps": STEPS, "window_s": 1.0,
            "host_issue_ms": [50.0] * ISSUE}


def test_train_readers_read_the_window(program):
    ring, window = _train_ring()
    program(ring)
    records = _train_records()
    read = lambda name: spec.metric_reader(name)(records)  # noqa: E731
    assert read("put_ms.train") == pytest.approx(
        statistics.median(window["put"]))
    for name in TRAIN_SPANS:
        assert read(name) == pytest.approx(
            statistics.median(int(ms * 1e6) // 8 for ms in window["step"])
            / 1e6)
    assert read("syncs.train") == statistics.median(window["syncs"])
    assert read("launches.train") == statistics.median(window["launches"])
    for name in ("h2d_ms.stylize", "forward_ms.stylize", "d2h_ms.stylize"):
        assert read(name) is None  # a train run has no stylize root


@pytest.mark.parametrize("calls", [5, 3000])
def test_stylize_readers_read_the_window(program, calls):
    """With more calls than the ring holds, the window's last ones."""
    ring, window = _stylize_ring(calls)
    ring = ring[-2048:]
    program(ring)
    records = {"kind": "stylize", "calls": calls, "window_s": 1.0}
    kept = window[-(2048 - 10):]
    for name in STYLIZE_SPANS:
        got = spec.metric_reader(name)(records)
        assert got == pytest.approx(
            statistics.median(int(ms * 1e6) // 8 for ms in kept) / 1e6)
    assert spec.metric_reader("put_ms.train")(records) is None


@pytest.mark.parametrize("name", ["put_ms.train", "syncs.train",
                                  "launches.train", *TRAIN_SPANS,
                                  *STYLIZE_SPANS])
def test_nothing_without_the_programs_tracing(monkeypatch, name):
    monkeypatch.delitem(sys.modules, MODULE, raising=False)
    records = (_train_records() if name.endswith(".train") else
               {"kind": "stylize", "calls": 4, "window_s": 1.0})
    assert spec.metric_reader(name)(records) is None


def test_nothing_from_an_empty_ring(program):
    program([])
    assert spec.metric_reader("syncs.train")(_train_records()) is None
    assert spec.metric_reader("forward_ms.train")(_train_records()) is None


def _events(with_spans: bool):
    """A traced window of two steps: kernels, a copy, host ops, the
    window's mark, and with ``with_spans`` the program's spans on host and
    device."""
    x = lambda cat, name, ts, dur, **kw: dict(  # noqa: E731
        ph="X", cat=cat, name=name, ts=ts, dur=dur, **kw)
    events = [x("user_annotation", trace.WINDOW_MARK, 0, 1000),
              x("cpu_op", "aten::empty", 0, 40),
              x("cpu_op", "ConvSameBackward", 300, 200),
              x("python_function", "train.py(1): step", 0, 990),
              x("kernel", "conv_same_tc_kernel<bf16>", 50, 150),
              x("kernel", "instance_norm_act_kernel", 260, 30),
              x("gpu_memcpy", "Memcpy HtoD", 600, 20),
              x("kernel", "conv_dw_tma_kernel", 700, 250)]
    if with_spans:
        for name, ts, dur in (("train_step", 10, 900), ("forward", 20, 280),
                              ("backward", 310, 580), ("put", 590, 15)):
            events.append(x("user_annotation", name, ts, dur))
            events.append(x("gpu_user_annotation", name, ts + 30, dur))
    return events


def test_trace_read_is_blind_to_the_spans():
    plain = trace.read(_events(False), 1e-3)
    spanned = trace.read(_events(True), 1e-3)
    assert plain["busy_s"] > 0 and plain["idle_gaps"]
    for key in ("busy_s", "idle_gaps", "kernels", "conv_s", "families"):
        assert spanned[key] == plain[key], key


def _synced(work):
    """(what ``work`` returns, the synchronizing CUDA operations torch
    warned of while it ran): sync debug mode on for ``work`` alone."""
    import warnings

    import torch

    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = work()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    return out, sum("synchronizing CUDA operation" in str(w.message)
                    for w in caught)


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")


@pytest.mark.card
def test_counted_syncs_are_torchs(card, tmp_path):
    """One U-Net train step after ``_put`` and one 512² stylize call on the
    card: the ``sync`` counters of their roots equal the synchronizing
    operations torch's sync debug mode warns of, and a step's kernel
    launches equal the change of ``kernels.launches``."""
    from cyclegan_tpu_torch import kernels, tracing

    from benchmark.drivers import stylize, train

    cell = spec.cell("unet256.train.b8")
    cfg, bsz = cell.config, int(cell.config["batch_size"])
    recs = train.records(cfg, cell.traffic, 2**31 + 5, "cuda")
    trainer = train.build_trainer(cfg, 2**31 + 5, "cuda", str(tmp_path))
    step, state = trainer.train_step_fn, trainer.state
    step(state, *trainer._put(*train.batch(recs, 0, bsz)))  # builds, warms
    tracing.reset()
    before = kernels.launched()
    _, warned = _synced(lambda: step(state, *trainer._put(
        *train.batch(recs, 1, bsz))))
    put, done = tracing.entries()
    counted = put["counters"].get("sync", 0) + done["counters"].get("sync", 0)
    print(f"train step: counted {counted}, torch warned {warned}, "
          f"launches {done['launches']}")
    assert counted == warned
    assert done["launches"] == kernels.launched() - before > 0
    del trainer, step, state

    cell = spec.cell("resnet9.stylize512.b8")
    cfg, traffic = cell.config, cell.traffic
    images = stylize.pool(traffic, 2**31 + 6, "cuda")
    stylize.write_model_folder(cfg, 2**31 + 6, "cuda", tmp_path)
    session = stylize.open_session(cfg, tmp_path, "cuda")
    first = stylize.batch(images, 0, int(traffic["batch"]))
    session.stylize(first, traffic["direction"])  # builds, warms
    tracing.reset()
    _, warned = _synced(lambda: session.stylize(first, traffic["direction"]))
    (call,) = tracing.entries()
    counted = call["counters"].get("sync", 0)
    print(f"stylize call: counted {counted}, torch warned {warned}")
    assert counted == warned
