"""The port's native loader and writer (``data/csrc/loader.cc``, bound in
``data/native.py``) against the JAX package's, on the CPU.

Both build the same C++ source, so on the same shards the decode must be
identical, and the writer's shards byte-identical; against the Python
path the decode agrees within JAX's own bound for its native loader (2
uint8 steps of resize rounding, ``tests/test_native_loader.py``). The
build runs at first use under a file lock; where it fails the Python
path decodes and the failure is kept in ``native.build_error``.
"""

import threading

import cv2
import numpy as np
import pytest

from cyclegan_tpu.data import native as jax_native
from cyclegan_tpu_torch.data import codec, host_build, manifest, native
from cyclegan_tpu_torch.data import pipeline
from cyclegan_tpu_torch.data.example_proto import decode_example
from cyclegan_tpu_torch.data.tfrecord import (
    read_tfrecord_file,
    tfrecord_writer,
    write_tfrecord_file,
)

SIZES = [(32, 32), (40, 24), (17, 33), (64, 64), (8, 8)]


@pytest.fixture(scope="module")
def shards(tmp_path_factory):
    root = tmp_path_factory.mktemp("native")
    rng = np.random.default_rng(21)
    images = [rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
              for h, w in SIZES]
    paths = []
    for start in range(0, len(images), 2):
        path = root / f"{start:05d}.tfrecords"
        write_tfrecord_file(path, [codec.image2example(im)
                                   for im in images[start:start + 2]])
        paths.append(str(path))
    return paths, images


def test_library_builds_here():
    assert native.available(), native.build_error
    assert native.build_error is None


@pytest.mark.parametrize("width", [16, 32])
def test_decode_matches_jax_native_exactly(shards, width):
    paths, _ = shards
    if not jax_native.available():
        pytest.skip("the JAX package's native loader does not build here")
    got = native.load_domain_native(paths, width)
    want = jax_native.load_domain_native(paths, width)
    assert got.shape == (len(SIZES), width, width, 3)
    np.testing.assert_array_equal(got, want)


def test_decode_within_two_steps_of_the_python_path(shards):
    paths, images = shards
    got = native.load_domain_native(paths, 32)
    for i, bgr in enumerate(images):
        ref = cv2.resize(bgr[..., ::-1], (32, 32),
                         interpolation=cv2.INTER_LINEAR)
        assert np.abs(got[i].astype(int) - ref).max() <= 2, i


def test_crc_corruption_is_detected(tmp_path):
    image = np.random.default_rng(1).integers(0, 256, (16, 16, 3),
                                              dtype=np.uint8)
    path = tmp_path / "c.tfrecords"
    write_tfrecord_file(path, [codec.image2example(image)])
    data = bytearray(path.read_bytes())
    data[len(data) // 2] ^= 0xFF
    path.write_bytes(bytes(data))
    assert native.load_domain_native([str(path)], 16, verify_crc=True) is None


@pytest.fixture(scope="module")
def image_dir(tmp_path_factory):
    src = tmp_path_factory.mktemp("native_images")
    rng = np.random.default_rng(3)
    for i in range(5):
        side = 20 if i % 2 else 24
        (src / f"{i}.png").write_bytes(codec.encode_png_bgr(
            rng.integers(0, 256, (side, side, 3), dtype=np.uint8)))
    return src


@pytest.mark.parametrize("image_size", [None, 16])
def test_writer_matches_jax_and_round_trips(tmp_path, image_dir, image_size):
    files = sorted(str(p) for p in image_dir.iterdir())
    (tmp_path / "port").mkdir()
    assert native.write_domain_native(files, tmp_path / "port", image_size,
                                      shard_size=2) == 5
    shards = sorted((tmp_path / "port").glob("*.tfrecords"))
    assert [p.name for p in shards] == [
        "00000.tfrecords", "00001.tfrecords", "00002.tfrecords"]
    if jax_native.available():
        (tmp_path / "jax").mkdir()
        jax_native.write_domain_native(files, tmp_path / "jax", image_size,
                                       shard_size=2)
        for p in shards:
            assert p.read_bytes() == (tmp_path / "jax" / p.name).read_bytes()
    records = [r for p in shards for r in read_tfrecord_file(p,
                                                             verify_crc=True)]
    for record, path in zip(records, files):
        got = codec.decode_image_rgb(decode_example(record)["image_raw"][0])
        want = cv2.imread(path)[..., ::-1]
        if image_size:
            want = cv2.resize(want, (image_size, image_size),
                              interpolation=cv2.INTER_LINEAR)
            assert np.abs(got.astype(int) - want).max() <= 2
        else:
            np.testing.assert_array_equal(got, want)


def test_pipeline_and_writer_take_the_native_path(tmp_path, image_dir):
    shards = tfrecord_writer(image_dir, tmp_path / "records", 16,
                             shard_size=2, seed=1)
    assert manifest.load_manifest(tmp_path / "records")["extra"][
        "writer"] == "native"
    before = dict(native.decoded)
    images = pipeline._load_domain([str(p) for p in shards], 16)
    assert images.shape == (5, 16, 16, 3)
    assert native.decoded["native"] - before.get("native", 0) == 5
    assert native.decoded["python"] == before.get("python", 0)


def test_failed_build_falls_back_visibly(monkeypatch, shards):
    """The compiler's error is kept and the Python path decodes, counted."""
    def broken(*args, **kwargs):
        raise RuntimeError("building loader.cc failed:\nno png.h")

    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_attempted", False)
    monkeypatch.setattr(native, "build_error", None)
    monkeypatch.setattr(host_build, "load", broken)
    before = native.decoded["python"]
    images = pipeline._load_domain(shards[0], 32)
    assert images.shape == (len(SIZES), 32, 32, 3)
    assert native.decoded["python"] - before == len(SIZES)
    assert "no png.h" in native.build_error


def test_concurrent_builds_share_one_library(monkeypatch, tmp_path):
    """Four threads build one source into an empty build directory at
    once: one compile, one library, the same path for all."""
    monkeypatch.setattr(host_build, "BUILD_ROOT", tmp_path)
    paths = []

    def build():
        paths.append(host_build.library_path("png_unfilter.c",
                                             ("-O3", "-std=c99")))

    threads = [threading.Thread(target=build) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert len(set(paths)) == 1 and len(paths) == 4
    assert [p.name for p in tmp_path.glob("*.so*")] == [paths[0].name]


def test_failed_unfilter_build_raises_with_the_compiler_output(
        monkeypatch, tmp_path):
    monkeypatch.setattr(host_build, "BUILD_ROOT", tmp_path)
    monkeypatch.setenv("CC", "cc")
    with pytest.raises(RuntimeError, match="unrecognized|error"):
        host_build.library_path("png_unfilter.c", ("-fno-such-flag",))
