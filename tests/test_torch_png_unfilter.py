"""The C PNG unfilter (``data/csrc/png_unfilter.c``) against the Python
byte loops it replaces, on the CPU: every one of the five row filters at
1 to 4 bytes a pixel, exactly; and the whole decoder on Paeth- and
Average-filtered PNGs that cv2 writes, against cv2's own decode,
exactly."""

import zlib

import cv2
import numpy as np
import pytest

from cyclegan_tpu_torch.data import png


@pytest.mark.parametrize("kind", [0, 1, 2, 3, 4])
@pytest.mark.parametrize("bpp", [1, 2, 3, 4])
def test_unfilter_row_matches_the_byte_loops(kind, bpp):
    rng = np.random.default_rng(10 * kind + bpp)
    for width in (1, 2, 37):
        line = rng.integers(0, 256, width * bpp, dtype=np.uint8)
        prev = rng.integers(0, 256, width * bpp, dtype=np.uint8)
        out = np.empty_like(line)
        png.unfilter_row(kind, line, prev, bpp, out)
        np.testing.assert_array_equal(
            out, png.unfilter_row_plain(kind, line, prev, bpp))


def test_unknown_filter_raises():
    row = np.zeros(6, np.uint8)
    with pytest.raises(ValueError, match="filter 5"):
        png.unfilter_row(5, row, row, 3, np.empty_like(row))


@pytest.mark.parametrize("channels", [1, 3, 4])
def test_decoder_matches_its_encoder_for_every_filter(channels):
    rng = np.random.default_rng(channels)
    image = rng.integers(0, 256, (9, 13, channels), dtype=np.uint8)
    want = (np.repeat(image, 3, axis=2) if channels == 1
            else image[..., :3])
    for kind in range(5):
        np.testing.assert_array_equal(
            png.decode_png(png.encode_png(image, row_filter=kind)), want)


@pytest.mark.parametrize("cv2_filter,kind", [
    (cv2.IMWRITE_PNG_FILTER_PAETH, 4), (cv2.IMWRITE_PNG_FILTER_AVG, 3)])
def test_cv2_png_matches_cv2_decode(cv2_filter, kind):
    """A PNG cv2 writes with every row Paeth (or Average) filtered."""
    rng = np.random.default_rng(kind)
    bgr = rng.integers(0, 256, (64, 48, 3), dtype=np.uint8)
    ok, data = cv2.imencode(".png", bgr, [cv2.IMWRITE_PNG_FILTER,
                                          cv2_filter])
    assert ok
    data = data.tobytes()
    idat = b"".join(body for name, body in png._chunks(data)
                    if name == b"IDAT")
    rows = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(64, -1)
    assert set(rows[:, 0]) == {kind}
    want = cv2.cvtColor(cv2.imdecode(np.frombuffer(data, np.uint8),
                                     cv2.IMREAD_COLOR), cv2.COLOR_BGR2RGB)
    np.testing.assert_array_equal(png.decode_png(data), want)
