"""The port's TFRecord writer, dataset manifests and data flows against
the JAX package's, on the CPU.

Shards written from the same folder of images with the same seed and the
same PNG encoder (cv2's here) must be byte-identical to the JAX writer's
Python path, with the same manifest; ``imread_bgr`` must give the JAX
reader's pixels exactly. Nothing reaches the network: the download flow's
``urllib`` calls are replaced, and the remote of ``fetch`` is a local
directory.
"""

import io
import json
import urllib.request
from pathlib import Path

import numpy as np
import pytest

from cyclegan_tpu.data import codec as jax_codec
from cyclegan_tpu.data import manifest as jax_manifest
from cyclegan_tpu.data.tfrecord import tfrecord_writer as jax_writer
from cyclegan_tpu_torch.apps import flows
from cyclegan_tpu_torch.data import codec, manifest, png
from cyclegan_tpu_torch.data.tfrecord import (
    read_tfrecord_file,
    tfrecord_writer,
)


@pytest.fixture(scope="module")
def image_dir(tmp_path_factory):
    """Seven seeded images of two sizes, one unreadable file among them."""
    src = tmp_path_factory.mktemp("imgs")
    rng = np.random.default_rng(3)
    for i in range(7):
        side = 20 if i % 2 else 24
        (src / f"{i}.png").write_bytes(codec.encode_png_bgr(
            rng.integers(0, 256, (side, side, 3), dtype=np.uint8)))
    (src / "notes.txt").write_text("not an image")
    return src


@pytest.mark.parametrize("image_size,seed", [(16, 0), (None, 5)])
def test_shards_byte_identical_to_jax(tmp_path, image_dir, image_size, seed):
    got = tfrecord_writer(image_dir, tmp_path / "port", image_size,
                          shard_size=3, seed=seed, use_native=False)
    want = jax_writer(image_dir, tmp_path / "jax", image_size, shard_size=3,
                      seed=seed, use_native=False)
    assert [p.name for p in got] == [p.name for p in want] == [
        "00000.tfrecords", "00001.tfrecords", "00002.tfrecords"]
    for g, w in zip(got, want):
        assert g.read_bytes() == w.read_bytes()
    mine = manifest.load_manifest(tmp_path / "port")
    theirs = jax_manifest.load_manifest(tmp_path / "jax")
    assert mine == theirs
    assert mine["total_records"] == 7  # the text file skipped
    assert mine["extra"] == {"image_size": image_size, "shard_size": 3,
                             "seed": seed, "writer": "python"}


def test_verify_manifest_catches_drift(tmp_path, image_dir):
    records = tmp_path / "records"
    shards = tfrecord_writer(image_dir, records, 16, shard_size=4, seed=1)
    assert manifest.verify_manifest(records)["total_records"] == 7
    jax_manifest.verify_manifest(records)  # the JAX reader agrees
    data = bytearray(shards[0].read_bytes())
    data[-5] ^= 1
    shards[0].write_bytes(bytes(data))
    with pytest.raises(manifest.ManifestMismatch, match="content drift"):
        manifest.verify_manifest(records)
    shards[0].unlink()
    with pytest.raises(manifest.ManifestMismatch, match="shard set drift"):
        manifest.verify_manifest(records)


def test_fetch_from_a_local_remote(tmp_path, image_dir):
    remote = tmp_path / "remote"
    tfrecord_writer(image_dir, remote, 16, shard_size=3, seed=2)
    local = tmp_path / "local"
    first = manifest.fetch_from_remote(local, str(remote))
    assert first == {"fetched": ["00000.tfrecords", "00001.tfrecords",
                                 "00002.tfrecords"], "cached": []}
    manifest.verify_manifest(local)
    (local / "00001.tfrecords").write_bytes(b"corrupt")
    again = manifest.fetch_from_remote(local, remote.as_uri())
    assert again == {"fetched": ["00001.tfrecords"],
                     "cached": ["00000.tfrecords", "00002.tfrecords"]}
    (remote / "00002.tfrecords").write_bytes(b"tampered")
    with pytest.raises(manifest.ManifestMismatch, match="00002"):
        manifest.fetch_from_remote(tmp_path / "fresh", str(remote))
    assert not list((tmp_path / "fresh").glob("*.fetch"))


@pytest.mark.parametrize("decoder", ["cv2", "stdlib"])
def test_imread_bgr_matches_jax(tmp_path, monkeypatch, decoder):
    rng = np.random.default_rng(4)
    bgr = rng.integers(0, 256, (20, 30, 3), dtype=np.uint8)
    path = tmp_path / "x.png"
    path.write_bytes(png.encode_png(bgr[..., ::-1].copy(), row_filter=4))
    want = jax_codec.imread_bgr(path)
    want16 = jax_codec.imread_bgr(path, 16)
    if decoder == "stdlib":
        monkeypatch.setattr(codec, "cv2", None)
        monkeypatch.setattr(codec, "Image", None)
    np.testing.assert_array_equal(codec.imread_bgr(path), want)
    np.testing.assert_array_equal(want, bgr)
    got16 = codec.imread_bgr(path, 16)
    assert got16.shape == (16, 16, 3)
    # cv2 exactly; torch's bilinear within one step of cv2's
    assert np.abs(got16.astype(int) - want16.astype(int)).max() <= (
        0 if decoder == "cv2" else 1)
    (tmp_path / "bad.png").write_bytes(b"nope")
    assert codec.imread_bgr(tmp_path / "bad.png") is None


def test_flows_tfrecords_and_fetch(tmp_path, image_dir):
    dest = tmp_path / "records"
    flows.main(["tfrecords", "--images", str(image_dir), "--destination",
                str(dest), "--size", "16"])
    shards = sorted(dest.glob("*.tfrecords"))
    assert len(shards) == 1  # 7 images, shard size 800
    images = [codec.example2image(r) for r in read_tfrecord_file(shards[0])]
    assert len(images) == 7 and images[0].shape == (16, 16, 3)
    local = tmp_path / "local"
    flows.main(["fetch", "--records_dir", str(local), "--remote", str(dest)])
    assert (local / shards[0].name).read_bytes() == shards[0].read_bytes()
    assert manifest.verify_manifest(local)["total_records"] == 7


def test_download_parses_pages_and_skips_failures(monkeypatch, tmp_path):
    """The Petfinder flow on a replaced ``urllib``: pagination, the large
    photo URLs, a failed download skipped, the token request."""
    pages = {
        1: {"animals": [{"photos": [{"large": "http://x/1.jpg"},
                                    {"medium": "http://x/skip.jpg"}]},
                        {"photos": [{"large": "http://x/bad.jpg"}]}],
            "pagination": {"_links": {"next": "/v2/animals?page=2"}}},
        2: {"animals": [{"photos": [{"large": "http://x/3.jpg"}]}],
            "pagination": {"_links": {}}},
    }

    def fake_urlopen(request, *args, **kwargs):
        url = request.full_url
        if url == flows.PETFINDER_TOKEN_URL:
            assert b"client_id=key" in request.data
            return io.BytesIO(json.dumps({"access_token": "tok"}).encode())
        assert request.headers["Authorization"] == "Bearer tok"
        page = int(url.split("page=")[1].split("&")[0])
        return io.BytesIO(json.dumps(pages[page]).encode())

    def fake_retrieve(url, path):
        if "bad" in url:
            raise OSError("boom")
        Path(path).write_bytes(b"img")

    monkeypatch.setattr(urllib.request, "urlopen", fake_urlopen)
    monkeypatch.setattr(urllib.request, "urlretrieve", fake_retrieve)
    assert flows.get_photo_urls("tok", "Tabby", pages=5) == [
        "http://x/1.jpg", "http://x/bad.jpg", "http://x/3.jpg"]
    monkeypatch.setenv("PETFINDER_KEY", "key")
    monkeypatch.setenv("PETFINDER_SECRET", "secret")
    flows.main(["download", "--breeds", "Tabby", "--destination",
                str(tmp_path), "--pages", "3"])
    assert sorted(p.name for p in (tmp_path / "Tabby").iterdir()) == [
        "00000.png", "00002.png"]
    monkeypatch.delenv("PETFINDER_KEY")
    with pytest.raises(SystemExit, match="PETFINDER_KEY"):
        flows.main(["download", "--breeds", "Tabby"])
