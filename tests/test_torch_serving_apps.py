"""The port's serving apps against the JAX package's, on the CPU:
``InferenceSession`` in both layouts, ``prediction_triple`` and its resize,
the HTTP server, the ``predict`` CLI and the TFRecord -> PNG export.

``model_instances/demo`` (U-Net filters 8/16/32) at 16x16, seeded uint8
images. Tolerances: f32 outputs are uint8, and two f32 paths may round a
pixel on either side of a half, so they may differ by 1; the four networks'
restored parameters are equal exactly; the threaded sessions' outputs
equal their serial outputs bit for bit.
"""

import sys
import threading
import urllib.error
import urllib.request
from http.server import ThreadingHTTPServer

import numpy as np
import pytest
import torch

import cv2
from PIL import Image
from cyclegan_tpu.apps.export import export_records as jax_export_records
from cyclegan_tpu.apps.inference import InferenceSession as JaxSession
from cyclegan_tpu_torch import predict
from cyclegan_tpu_torch.apps import server
from cyclegan_tpu_torch.apps.export import export_records
from cyclegan_tpu_torch.apps.inference import InferenceSession
from cyclegan_tpu_torch.data import codec, png
from cyclegan_tpu_torch.data.tfrecord import tfrecord_writer
from cyclegan_tpu_torch.ops import conv
from cyclegan_tpu_torch.weights import module_to_jax_params

MODEL_DIR = "model_instances/demo"
SIZE = 16


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in several worker processes."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def images():
    rng = np.random.default_rng(0)
    return rng.integers(0, 256, (2, SIZE, SIZE, 3), dtype=np.uint8)


@pytest.fixture(scope="module")
def jax_sessions():
    return {layout: JaxSession(MODEL_DIR, "float32", tpu_layout=layout)
            for layout in ("auto", True, False)}


@pytest.fixture(scope="module")
def port_session():
    return InferenceSession(MODEL_DIR, device="cpu")


def _far(got, want):
    return int(np.abs(got.astype(int) - want.astype(int)).max())


@pytest.mark.parametrize("layout", ["auto", True, False])
def test_session_layouts_match_jax(jax_sessions, images, layout):
    port = InferenceSession(MODEL_DIR, "float32", tpu_layout=layout,
                            device="cpu")
    ref = jax_sessions[layout]
    assert port.tpu_layout == ref.tpu_layout == (layout is True)
    for direction in ("a2b", "b2a"):
        got = port.stylize(images, direction)
        assert got.dtype == np.uint8 and got.shape == images.shape
        assert _far(got, ref.stylize(images, direction)) <= 1


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_auto_layout_is_nhwc_off_the_card(dtype):
    """"auto" is NHCW only on a CUDA device in bf16 (chip_smoke.py phase
    20 checks the card's side)."""
    assert not InferenceSession(MODEL_DIR, dtype, device="cpu").tpu_layout
    assert InferenceSession(MODEL_DIR, dtype, tpu_layout=True,
                            device="cpu").tpu_layout


def test_four_networks_restored_exactly(port_session, jax_sessions):
    ref = jax_sessions[False].state.params
    assert sorted(port_session.models) == sorted(ref)
    for name, model in port_session.models.items():
        got = module_to_jax_params(model)

        def walk(a, b, path):
            if isinstance(b, dict):
                assert sorted(a) == sorted(b), path
                for k in b:
                    walk(a[k], b[k], path + [k])
            elif isinstance(b, (list, tuple)):
                assert len(a) == len(b), path
                for i, (x, y) in enumerate(zip(a, b)):
                    walk(x, y, path + [i])
            else:
                np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                              err_msg=str(path))

        walk(got, ref[name], [name])
    assert port_session.state.models is port_session.models


def test_spatial_devices_raise():
    """Spatial serving needs a process group of that many ranks
    (``tests/test_torch_multiprocess.py`` serves with one, and
    ``tests/test_torch_server_spatial.py`` runs the HTTP server on one);
    outside one, the session and the HTTP server both refuse it."""
    with pytest.raises(RuntimeError, match="process group of 2 ranks"):
        InferenceSession(MODEL_DIR, spatial_devices=2, device="cpu")
    from cyclegan_tpu_torch.apps.server import serve

    with pytest.raises(RuntimeError, match="process group of 2 ranks"):
        serve(MODEL_DIR, "127.0.0.1", 0, 32, spatial_devices=2,
              device="cpu")


def test_concurrent_sessions_give_serial_outputs(images):
    """An NHCW and an NHWC session stylizing on two threads at once give
    their serial outputs bit for bit: the layout scope is per thread. With
    one process-wide scope a thread leaving NHCW switched the other's
    forward to NHWC mid-way."""
    sessions = [InferenceSession(MODEL_DIR, tpu_layout=t, device="cpu")
                for t in (True, False)]
    serial = [s.stylize(images[:1], "a2b") for s in sessions]
    outputs, errors = [[], []], []

    def run(i):
        try:
            for _ in range(20):
                outputs[i].append(sessions[i].stylize(images[:1], "a2b"))
        except Exception as exc:  # noqa: BLE001 - reported below
            errors.append(exc)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=run, args=(i,)) for i in (0, 1)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors
    for i in (0, 1):
        assert len(outputs[i]) == 20
        for out in outputs[i]:
            np.testing.assert_array_equal(out, serial[i])


def test_tf32_stays_off_until_the_last_f32_call_leaves(monkeypatch):
    """cuDNN's TF32 switch is one flag per process: a thread leaving its
    f32 library call must not turn it back on while another thread's f32
    call is still running."""
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    entered, release = threading.Event(), threading.Event()
    seen = []

    def other():
        with conv._full_f32(torch.float32):
            entered.set()
            release.wait(timeout=30)
            seen.append(torch.backends.cudnn.allow_tf32)

    thread = threading.Thread(target=other)
    thread.start()
    assert entered.wait(timeout=30)
    with conv._full_f32(torch.float32):
        assert torch.backends.cudnn.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False  # the other call runs
    with conv._full_f32(torch.bfloat16):
        assert torch.backends.cudnn.allow_tf32 is False
    release.set()
    thread.join(timeout=30)
    assert not thread.is_alive()
    assert seen == [False]
    assert torch.backends.cudnn.allow_tf32 is True


def test_prediction_triple_matches_jax(port_session, jax_sessions):
    rng = np.random.default_rng(2)
    bgr = rng.integers(0, 256, (20, 30, 3), dtype=np.uint8)
    got = port_session.prediction_triple(bgr, size=(SIZE, 12))
    want = jax_sessions["auto"].prediction_triple(bgr, size=(SIZE, 12))
    np.testing.assert_array_equal(got[0], want[0])
    assert got[0].shape == (12, SIZE, 3)
    for g, w in zip(got[1:], want[1:]):
        assert g.dtype == np.uint8 and g.shape == (12, SIZE, 3)
        assert _far(g, w) <= 1


def _cv2_linear(img, width, height):
    """cv2's INTER_LINEAR in floating point: half-pixel centres, source
    coordinates clamped to the image, no antialiasing."""
    def axis(n_out, n_in):
        s = np.clip((np.arange(n_out) + 0.5) * n_in / n_out - 0.5, 0,
                    n_in - 1)
        i0 = np.floor(s).astype(int)
        i1 = np.minimum(i0 + 1, n_in - 1)
        return i0, i1, s - i0

    y0, y1, fy = axis(height, img.shape[0])
    x0, x1, fx = axis(width, img.shape[1])
    f = img.astype(np.float64)
    top = f[y0][:, x0] * (1 - fx)[None, :, None] + f[y0][:, x1] * fx[
        None, :, None]
    bottom = f[y1][:, x0] * (1 - fx)[None, :, None] + f[y1][:, x1] * fx[
        None, :, None]
    return top * (1 - fy)[:, None, None] + bottom * fy[:, None, None]


@pytest.mark.parametrize("branch", ["cv2", "pil", "torch"])
@pytest.mark.parametrize("size", [(16, 16), (40, 24), (7, 9)])
def test_resize_rgb_branches(monkeypatch, branch, size):
    """Each branch of the one host resize against what it stands for:
    cv2 and PIL exactly, torch's bilinear within one step of cv2's
    formula (the branch that serves on a machine without either)."""
    rng = np.random.default_rng(3)
    img = rng.integers(0, 256, (20, 30, 3), dtype=np.uint8)
    if branch != "cv2":
        monkeypatch.setattr(codec, "cv2", None)
    if branch == "torch":
        monkeypatch.setattr(codec, "Image", None)
    got = codec.resize_rgb(img, size)
    assert got.dtype == np.uint8 and got.shape == (size[1], size[0], 3)
    if branch == "cv2":
        want = cv2.resize(img, size, interpolation=cv2.INTER_LINEAR)
        np.testing.assert_array_equal(got, want)
    elif branch == "pil":
        want = np.asarray(Image.fromarray(img).resize(size, Image.BILINEAR))
        np.testing.assert_array_equal(got, want)
    else:
        want = _cv2_linear(img, *size)
        assert np.abs(got.astype(float) - want).max() <= 1.0
        # and the formula is cv2's, within its fixed-point rounding
        assert _far(cv2.resize(img, size), np.round(want)) <= 1


@pytest.fixture(scope="module")
def running_server(port_session):
    httpd = ThreadingHTTPServer(("127.0.0.1", 0),
                                server.make_handler(port_session, SIZE))
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    yield f"http://127.0.0.1:{httpd.server_address[1]}"
    httpd.shutdown()
    httpd.server_close()
    thread.join(timeout=30)


def _post(url, body, headers=None):
    request = urllib.request.Request(url, data=body, method="POST",
                                     headers=headers or {})
    try:
        with urllib.request.urlopen(request, timeout=60) as response:
            return response.status, dict(response.headers), response.read()
    except urllib.error.HTTPError as err:
        return err.code, dict(err.headers), err.read()


def test_server_healthz_and_unknown_paths(running_server):
    with urllib.request.urlopen(f"{running_server}/healthz",
                                timeout=60) as response:
        assert response.status == 200 and response.read() == b"ok"
    with pytest.raises(urllib.error.HTTPError) as err:
        urllib.request.urlopen(f"{running_server}/nope", timeout=60)
    assert err.value.code == 404
    code, _, _ = _post(f"{running_server}/other", b"x")
    assert code == 404


@pytest.mark.parametrize("direction", ["a2b", "b2a"])
def test_server_png_reply_is_the_sessions_stylize(running_server,
                                                  port_session, direction):
    rng = np.random.default_rng(6)
    rgb = rng.integers(0, 256, (20, 24, 3), dtype=np.uint8)
    code, headers, body = _post(
        f"{running_server}/stylize?direction={direction}",
        png.encode_png(rgb))
    assert code == 200 and headers["Content-Type"] == "image/png"
    stages = [part.split(";")[0] for part in
              headers["Server-Timing"].split(", ")]
    assert stages == list(server.TIMED_STAGES)
    want = port_session.stylize(codec.resize_rgb(rgb, (SIZE, SIZE))[None],
                                direction)[0]
    np.testing.assert_array_equal(png.decode_png(body), want)


def test_server_rejects_bad_requests(running_server):
    body = png.encode_png(np.zeros((8, 8, 3), np.uint8))
    code, _, text = _post(f"{running_server}/stylize?direction=x2y", body)
    assert code == 400 and b"direction" in text
    code, _, text = _post(f"{running_server}/stylize", b"")
    assert code == 400 and text == b"bad content length"
    code, _, text = _post(f"{running_server}/stylize", b"not an image")
    assert code == 400 and text.startswith(b"error:")


def test_server_jpeg_without_a_decoder_is_400(running_server, monkeypatch):
    """Where neither cv2 nor PIL imports, a JPEG cannot be decoded: 400
    with the codec's reason, not 500 or a dropped connection."""
    ok, jpeg = cv2.imencode(".jpg", np.full((16, 16, 3), 99, np.uint8))
    assert ok
    monkeypatch.setattr(codec, "cv2", None)
    monkeypatch.setattr(codec, "Image", None)
    code, _, text = _post(f"{running_server}/stylize?direction=a2b",
                          jpeg.tobytes())
    assert code == 400 and b"needs cv2 or PIL" in text


def test_predict_cli_writes_the_triple(tmp_path, port_session, capsys):
    rng = np.random.default_rng(7)
    bgr = rng.integers(0, 256, (20, 30, 3), dtype=np.uint8)
    image = tmp_path / "cat.png"
    image.write_bytes(codec.encode_png_bgr(bgr))
    predict.main(["--image", str(image), "--model_dir", MODEL_DIR,
                  "--out", str(tmp_path / "out"), "--size", str(SIZE),
                  "--device", "cpu"])
    printed = capsys.readouterr().out.split()
    want = port_session.prediction_triple(bgr, (SIZE, SIZE))
    assert [p.rsplit("/", 1)[1] for p in printed] == [
        "cat_original.png", "cat_a2b.png", "cat_b2a.png"]
    for path, rgb in zip(printed, want):
        decoded = codec.decode_image_rgb(open(path, "rb").read())
        np.testing.assert_array_equal(decoded, rgb)


def test_export_matches_jax(tmp_path):
    """Five images at batch 2: two full batches and a padded tail, one PNG
    each named ``{index:06d}_{direction}.png``, within one step of the JAX
    export's (both in f32). The records hold the export's size: the JAX
    loader resizes others in its native library, by its own rule."""
    rng = np.random.default_rng(4)
    src = tmp_path / "imgs"
    src.mkdir()
    for i in range(5):
        (src / f"{i}.png").write_bytes(png.encode_png(
            rng.integers(0, 256, (24, 24, 3), dtype=np.uint8)))
    shards = [str(p) for p in tfrecord_writer(src, tmp_path / "records",
                                              image_size=SIZE, shard_size=3,
                                              seed=0)]
    got = export_records(shards, MODEL_DIR, tmp_path / "port", "b2a",
                         size=SIZE, batch=2, compute_dtype="float32",
                         device="cpu")
    want = jax_export_records(shards, MODEL_DIR, tmp_path / "jax", "b2a",
                              size=SIZE, batch=2, compute_dtype="float32")
    assert [p.name for p in got] == [p.name for p in want] == [
        f"{i:06d}_b2a.png" for i in range(5)]
    for g, w in zip(got, want):
        a = codec.decode_image_rgb(g.read_bytes())
        b = codec.decode_image_rgb(w.read_bytes())
        assert a.shape == (SIZE, SIZE, 3) and _far(a, b) <= 1
