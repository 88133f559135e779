"""The port's spans and counters (``cyclegan_tpu_torch/tracing.py``) on the
CPU: nesting, root ids and the per-thread stack, the bounded ring, the
profiler flag and ``record_function`` only under a profiler; the spans of a
train step after ``_put`` (the kernels' launches counted through counting
dispatchers), of a multi step, of a ``stylize`` call; and the spans as
``user_annotation`` events in the profiler's Chrome trace, around the aten
ops they issued."""

import json
import threading
import urllib.request
from http.server import ThreadingHTTPServer

import numpy as np
import pytest
import torch

from cyclegan_tpu_torch import kernels, tracing
from cyclegan_tpu_torch.apps import server
from cyclegan_tpu_torch.apps.inference import InferenceSession
from cyclegan_tpu_torch.config import Namespace
from cyclegan_tpu_torch.data import png
from cyclegan_tpu_torch.ops import cuda_conv, cuda_norm_act
from cyclegan_tpu_torch.trainer import CycleGan

SIZE = 32
STEP_SPANS = {"jitter", "forward", "backward", "optimizer"}
STYLIZE_SPANS = {"h2d", "forward", "d2h"}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in several worker processes."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _empty_ring():
    tracing.reset()
    yield
    tracing.reset()


def _gan(tmp_path, tpu_layout=True, **extra):
    unet = dict(type="unet_generator", filters=[4, 4], kernels=[3, 3],
                expansion="upsample", normalization="instancenorm",
                dropout=False)
    model = Namespace(dict(
        name="tiny", new=True, location=str(tmp_path), seed=0,
        generator=dict(unet, output_channels=3, final_activation="tanh"),
        discriminator=dict(unet, output_channels=1,
                           final_activation="sigmoid"),
        loss="mse", loss_weights=dict(cycle=2.0, identity=0.5, generator=1.0,
                                      discriminator=0.5)))
    adam = dict(name="adam", learning_rate=2e-4, beta_1=0.5)
    train = Namespace(dict(epochs=1, batch_size=2, image_size=SIZE,
                           g_opt=adam, d_opt=adam, tpu_layout=tpu_layout,
                           **extra))
    return CycleGan(model, train, device="cpu")


def _images(n=2, size=SIZE, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 256, (n, size, size, 3), dtype=np.uint8),
            rng.integers(0, 256, (n, size, size, 3), dtype=np.uint8))


def test_nested_spans_share_their_root_and_sum_by_path():
    with tracing.span("root") as entry:
        with tracing.span("a"):
            with tracing.span("b"):
                tracing.count("hits")
        with tracing.span("a"):
            tracing.count("hits", 2)
    with tracing.span("other"):
        pass
    first, second = tracing.entries()
    assert first is entry and first["name"] == "root"
    assert set(first["spans"]) == {"a", "a/b"}
    assert first["spans"]["a/b"] <= first["spans"]["a"] <= first["ns"]
    assert first["counters"] == {"hits": 3}
    assert first["launches"] == 0 and first["profiled"] is False
    assert second["name"] == "other" and second["spans"] == {}
    assert second["id"] > first["id"]


def test_count_outside_a_span_is_dropped():
    tracing.count("sync")
    assert tracing.entries() == []


def test_each_thread_has_its_own_stack_and_roots():
    both_open = threading.Barrier(2, timeout=30)

    def work(name):
        with tracing.span(name):
            with tracing.span("child"):
                both_open.wait()
                tracing.count(name)

    threads = [threading.Thread(target=work, args=(n,)) for n in ("x", "y")]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
        assert not t.is_alive()
    got = {e["name"]: e for e in tracing.entries()}
    assert set(got) == {"x", "y"}
    assert got["x"]["id"] != got["y"]["id"]
    for name, e in got.items():
        assert set(e["spans"]) == {"child"}
        assert e["counters"] == {name: 1}


def test_ring_keeps_the_last_roots():
    for _ in range(tracing.RING + 5):
        with tracing.span("r"):
            pass
    kept = tracing.entries()
    assert len(kept) == tracing.RING
    ids = [e["id"] for e in kept]
    assert ids == list(range(ids[0], ids[0] + tracing.RING))


def test_profiled_only_under_the_profiler_and_record_function_only_there(
        monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) with the "
                             f"profiler off")

    original = torch.profiler.record_function
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    with tracing.span("off"):
        with tracing.span("child"):
            pass
    monkeypatch.setattr(torch.profiler, "record_function", original)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        with tracing.span("on"):
            pass
    off, on = tracing.entries()
    assert off["profiled"] is False and on["profiled"] is True


def _counting_dispatchers(monkeypatch):
    """K1 and K2's dispatchers at their plain versions, each call counted
    in ``kernels.launches`` as on the card and in the returned dict."""
    calls = {"n": 0}
    for module, name, key in ((cuda_conv, "_conv_same", "conv_same"),
                              (cuda_norm_act, "_instance_norm_act",
                               "instance_norm_act")):
        def counted(*args, _plain=getattr(module, name), _key=key,
                    **kwargs):
            kernels.launches[_key] += 1
            calls["n"] += 1
            return _plain(*args, **kwargs)

        monkeypatch.setattr(module, name, counted)
    return calls


def test_put_and_train_step_leave_their_entries(tmp_path, monkeypatch):
    gan = _gan(tmp_path)
    calls = _counting_dispatchers(monkeypatch)
    before = kernels.launched()
    gan.train_step_fn(gan.state, *gan._put(*_images()))
    put, step = tracing.entries()
    assert put["name"] == "put" and put["spans"] == {}
    assert put["counters"] == {}  # no copy to a card on the CPU
    assert step["name"] == "train_step"
    assert set(step["spans"]) == STEP_SPANS
    assert sum(step["spans"].values()) <= step["ns"]
    assert step["launches"] == calls["n"] == kernels.launched() - before
    assert step["launches"] > 0


def test_multi_step_is_a_root_per_inner_step(tmp_path):
    gan = _gan(tmp_path, tpu_layout=False, steps_per_call=2)
    a, b = _images(4)
    gan.multi_step_fn(gan.state, *gan._put(a.reshape(2, 2, SIZE, SIZE, 3),
                                           b.reshape(2, 2, SIZE, SIZE, 3)))
    names = [e["name"] for e in tracing.entries()]
    assert names == ["put", "train_step", "train_step"]
    for e in tracing.entries()[1:]:
        assert set(e["spans"]) == STEP_SPANS


def test_stylize_leaves_h2d_forward_d2h():
    session = InferenceSession("model_instances/demo", device="cpu")
    out = session.stylize(_images(2, 16)[0])
    assert out.shape == (2, 16, 16, 3) and out.dtype == np.uint8
    (entry,) = tracing.entries()
    assert entry["name"] == "stylize"
    assert set(entry["spans"]) == STYLIZE_SPANS
    assert entry["counters"] == {}
    assert sum(entry["spans"].values()) <= entry["ns"]


def test_server_timing_is_the_request_spans():
    session = InferenceSession("model_instances/demo", device="cpu")
    httpd = ThreadingHTTPServer(("127.0.0.1", 0),
                                server.make_handler(session, 16))
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    try:
        request = urllib.request.Request(
            f"http://127.0.0.1:{httpd.server_address[1]}/stylize",
            data=png.encode_png(_images(1, 20)[0][0]), method="POST")
        with urllib.request.urlopen(request, timeout=60) as response:
            assert response.status == 200
            timing = response.headers["Server-Timing"]
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=30)
    assert not thread.is_alive()
    (entry,) = tracing.entries()
    assert entry["name"] == "request"
    assert set(entry["spans"]) == set(server.TIMED_STAGES) | {
        "stylize/stylize"} | {f"stylize/stylize/{s}" for s in STYLIZE_SPANS}
    header = dict(part.split(";dur=") for part in timing.split(", "))
    assert list(header) == list(server.TIMED_STAGES)
    for stage, ms in header.items():
        assert float(ms) == pytest.approx(entry["spans"][stage] / 1e6,
                                          abs=5e-4)


def test_spans_are_user_annotations_around_their_ops(tmp_path):
    gan = _gan(tmp_path)
    gan.train_step_fn(gan.state, *gan._put(*_images()))  # warm
    tracing.reset()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        gan.train_step_fn(gan.state, *gan._put(*_images(seed=1)))
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = [e for e in json.loads(path.read_text())["traceEvents"]
              if e.get("ph") == "X"]
    opened = {"put": 1, "train_step": 1, "jitter": 1, "forward": 1,
              "backward": 1, "optimizer": 2}
    # torch's optimizers annotate their own calls beside the spans
    notes = [e for e in events if e.get("cat") == "user_annotation"
             and e["name"] in opened]
    assert sorted(e["name"] for e in notes) == sorted(
        name for name, n in opened.items() for _ in range(n))
    assert all(e["profiled"] for e in tracing.entries())
    (forward,) = [e for e in notes if e["name"] == "forward"]
    lo, hi = forward["ts"], forward["ts"] + forward["dur"]
    ops = [e for e in events if e.get("cat") == "cpu_op"
           and e["tid"] == forward["tid"] and e["ts"] < hi
           and e["ts"] + e["dur"] > lo]
    assert any("conv" in e["name"] for e in ops)
    for e in ops:  # nested: no op straddles the span's edges
        assert lo <= e["ts"] and e["ts"] + e["dur"] <= hi, e["name"]
