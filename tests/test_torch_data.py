"""The port's data layer against the JAX package's, on the CPU: CRC32C,
TFRecord framing both ways with the checksums verified, the Example proto
both ways, the standard-library PNG codec against cv2, and the pipeline's
split and batch order. Everything here is exact: integer data."""

import numpy as np
import pytest

import cv2
import google_crc32c
from cyclegan_tpu.data import codec as jax_codec
from cyclegan_tpu.data import example_proto as jax_proto
from cyclegan_tpu.data import pipeline as jax_pipeline
from cyclegan_tpu.data import tfrecord as jax_tfrecord
from cyclegan_tpu_torch.data import codec, example_proto, pipeline, png
from cyclegan_tpu_torch.data import tfrecord


def _images(n, size, seed):
    return np.random.default_rng(seed).integers(
        0, 256, (n, size, size, 3), dtype=np.uint8)


def _filters_of(blob):
    """The row filter types of a PNG, read off its decompressed rows."""
    import struct
    import zlib
    pos, idat = 8, []
    while pos < len(blob):
        length, kind = struct.unpack(">I4s", blob[pos:pos + 8])
        body = blob[pos + 8:pos + 8 + length]
        if kind == b"IHDR":
            width, height, _, colour = struct.unpack(">IIBB", body[:10])
        elif kind == b"IDAT":
            idat.append(body)
        pos += 12 + length
    raw = zlib.decompress(b"".join(idat))
    stride = width * {0: 1, 2: 3, 4: 2, 6: 4}[colour] + 1
    return {raw[i * stride] for i in range(height)}


def _structured_image(channels):
    """Gradients, noise and flat bands: cv2's encoder picks every row
    filter for it."""
    rng = np.random.default_rng(0)
    yy, xx = np.mgrid[:64, :64]
    img = np.zeros((64, 64, channels), np.uint8)
    for c in range(channels):
        img[..., c] = ((xx + (c + 1) * yy) * (c + 2)) % 256
    img[16:32] = rng.integers(0, 256, (16, 64, channels))
    img[32:40] = 100
    return img


@pytest.mark.parametrize("n", [0, 1, 9, 1000, 65537])
def test_crc32c_equals_google_crc32c(n):
    data = np.random.default_rng(n).integers(0, 256, n, np.uint8).tobytes()
    assert tfrecord.crc32c(data) == google_crc32c.value(data)


def test_jax_written_records_read_by_port(tmp_path):
    images = _images(5, 12, 0)
    path = tmp_path / "jax.tfrecords"
    jax_tfrecord.write_tfrecord_file(
        path, (jax_codec.image2example(im) for im in images))
    got = [codec.example2image(r) for r in
           tfrecord.read_tfrecord_file(path, verify_crc=True)]
    want = [im[..., ::-1] for im in images]  # BGR in, RGB out
    assert len(got) == 5
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("stdlib", [False, True])
def test_port_written_records_read_by_jax_with_crc(tmp_path, monkeypatch,
                                                   stdlib):
    """Through cv2 and through the standard library's PNG encoder."""
    if stdlib:
        monkeypatch.setattr(codec, "cv2", None)
        monkeypatch.setattr(codec, "Image", None)
    images = _images(4, 10, 1)
    path = tmp_path / "port.tfrecords"
    assert tfrecord.write_tfrecord_file(
        path, (codec.image2example(im) for im in images)) == 4
    got = [jax_codec.example2image(r) for r in
           jax_tfrecord.read_tfrecord_file(path, verify_crc=True)]
    for g, im in zip(got, images):
        np.testing.assert_array_equal(g, im[..., ::-1])


def test_corrupt_record_fails_verification(tmp_path):
    path = tmp_path / "r.tfrecords"
    tfrecord.write_tfrecord_file(path, [b"abcdef"])
    blob = bytearray(path.read_bytes())
    blob[12 + 2] ^= 1  # the payload's "c"
    path.write_bytes(bytes(blob))
    assert list(tfrecord.read_tfrecord_file(path)) == [b"abbdef"]
    with pytest.raises(IOError, match="corrupt data crc"):
        list(tfrecord.read_tfrecord_file(path, verify_crc=True))


def test_example_proto_round_trips_both_ways():
    features = {"image_raw": b"\x00\x01png", "height": 256, "width": -3,
                "ids": [1, 2, 3 << 40], "scores": [0.5, -2.25],
                "names": [b"a", b"bc"]}
    port = example_proto.encode_example(features)
    assert port == jax_proto.encode_example(features)
    want = jax_proto.decode_example(port)
    assert example_proto.decode_example(port) == want
    assert want["ids"] == [1, 2, 3 << 40] and want["width"] == [-3]


@pytest.mark.parametrize("channels,flag", [(3, cv2.IMREAD_COLOR),
                                           (4, cv2.IMREAD_UNCHANGED),
                                           (1, cv2.IMREAD_GRAYSCALE)])
def test_png_decoder_matches_cv2_on_cv2_pngs(channels, flag):
    """PNGs written by cv2 with all five row filters, RGB, RGBA and gray:
    the decoder gives cv2's RGB image exactly."""
    img = _structured_image(channels)
    ok, buf = cv2.imencode(".png", img if channels != 1 else img[..., 0],
                           [cv2.IMWRITE_PNG_COMPRESSION, 6])
    blob = buf.tobytes()
    assert _filters_of(blob) == {0, 1, 2, 3, 4}
    want = cv2.cvtColor(cv2.imdecode(buf, cv2.IMREAD_COLOR),
                        cv2.COLOR_BGR2RGB)
    np.testing.assert_array_equal(png.decode_png(blob), want)
    assert cv2.imdecode(buf, flag) is not None


@pytest.mark.parametrize("row_filter", range(5))
def test_png_encoder_row_filters_round_trip(row_filter):
    img = _images(1, 33, row_filter)[0]
    blob = png.encode_png(img, row_filter)
    assert _filters_of(blob) == {row_filter}
    np.testing.assert_array_equal(png.decode_png(blob), img)
    np.testing.assert_array_equal(
        cv2.imdecode(np.frombuffer(blob, np.uint8), cv2.IMREAD_COLOR),
        img[..., ::-1])


def test_codec_without_cv2_or_pil(monkeypatch):
    monkeypatch.setattr(codec, "cv2", None)
    monkeypatch.setattr(codec, "Image", None)
    bgr = _images(1, 9, 3)[0]
    np.testing.assert_array_equal(
        codec.example2image(codec.image2example(bgr)), bgr[..., ::-1])
    ok, jpeg = cv2.imencode(".jpg", bgr)
    with pytest.raises(RuntimeError, match="JPEG"):
        codec.decode_image_rgb(jpeg.tobytes())


@pytest.fixture
def shards(tmp_path):
    """Two domains of 13 and 11 images at 16x16, written by JAX."""
    paths = []
    for name, n, seed in (("a", 13, 4), ("b", 11, 5)):
        path = tmp_path / f"{name}.tfrecords"
        jax_tfrecord.write_tfrecord_file(
            path, (jax_codec.image2example(im) for im in _images(n, 16,
                                                                   seed)))
        paths.append([str(path)])
    return paths


def test_create_dataset_matches_jax(shards, monkeypatch):
    # the JAX package's Python decode path (its native loader may be built)
    monkeypatch.setattr("cyclegan_tpu.data.native.load_domain_native",
                        lambda records, width: None)
    got = pipeline.create_dataset(*shards, width=16, seed=5)
    want = jax_pipeline.create_dataset(*shards, width=16, seed=5)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.images_a, w.images_a)
        np.testing.assert_array_equal(g.images_b, w.images_b)
        assert g.num_batches(3) == w.num_batches(3)
        for epoch in (0, 1):
            for (ga, gb), (wa, wb) in zip(g.batches(3, epoch),
                                          w.batches(3, epoch)):
                np.testing.assert_array_equal(ga, wa)
                np.testing.assert_array_equal(gb, wb)
        for ga, wa in zip(g.take_pairs(2), w.take_pairs(2)):
            np.testing.assert_array_equal(ga, wa)
    # int(0.2 * 13) = 2 validation images per domain; 11 and 9 train
    assert len(got[0]) == 9 and len(got[1]) == 2


def test_load_domain_resizes_only_other_sizes(shards, monkeypatch):
    same = pipeline._load_domain(shards[0], 16)
    want = np.stack([im[..., ::-1] for im in _images(13, 16, 4)])
    np.testing.assert_array_equal(same, want)
    assert pipeline._load_domain(shards[0], 8).shape == (13, 8, 8, 3)
    # without cv2 and PIL: torch's bilinear, within one step of cv2's (the
    # resize is codec.resize_rgb, which the pipeline calls)
    monkeypatch.setattr(codec, "cv2", None)
    monkeypatch.setattr(codec, "Image", None)
    small = pipeline._load_domain(shards[0], 8)
    ref = np.stack([cv2.resize(im, (8, 8), interpolation=cv2.INTER_LINEAR)
                    for im in want])
    assert np.abs(small.astype(int) - ref).max() <= 1
