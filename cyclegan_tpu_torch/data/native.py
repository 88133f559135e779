"""ctypes binding of the native data loader and writer
(cyclegan_tpu/data/native.py).

``csrc/loader.cc`` (the port's copy of the JAX package's loader): TFRecord
framing with CRC32C verification, Example parsing, PNG/JPEG decoding with
libpng and libjpeg and a bilinear resize, on a C++ thread pool; and the
writer, image files to PNG-encoded Example shards. It builds at first use
with ``g++ -O3 ... -lpng -ljpeg -lz -pthread`` (``host_build.py``).

Where it does not build (no compiler, no libpng or libjpeg headers), the
pipeline and the writer take their Python paths, as the JAX package's do.
The fallback is visible: the compiler's error is logged once and kept in
``build_error``, and ``decoded`` counts the images each path decoded
(``native`` here, ``python`` in ``pipeline._load_domain``).
"""

from __future__ import annotations

import collections
import ctypes
import logging
from typing import Optional, Sequence

import numpy as np

from cyclegan_tpu_torch.data import host_build

logger = logging.getLogger(__name__)

SOURCE = "loader.cc"
FLAGS = ("-O3", "-std=c++17", "-Wall", "-Wextra")
LIBS = ("-lpng", "-ljpeg", "-lz", "-pthread")

# images decoded per path since the process started (or ``reset``)
decoded = collections.Counter()
build_error: Optional[str] = None
_lib: Optional[ctypes.CDLL] = None
_attempted = False


def get_lib() -> Optional[ctypes.CDLL]:
    """The loader library, built at the first call; None where it does not
    build (the error is logged once, and kept in ``build_error``)."""
    global _lib, _attempted, build_error
    if _lib is not None or _attempted:
        return _lib
    _attempted = True
    try:
        lib = host_build.load(SOURCE, FLAGS, LIBS)
    except (RuntimeError, OSError) as exc:
        build_error = str(exc)
        logger.warning("native loader unavailable, the Python path decodes: "
                       "%s", build_error)
        return None
    paths = ctypes.POINTER(ctypes.c_char_p)
    lib.tfr_count_records.restype = ctypes.c_long
    lib.tfr_count_records.argtypes = [paths, ctypes.c_int, ctypes.c_int]
    lib.tfr_decode_domain.restype = ctypes.c_long
    lib.tfr_decode_domain.argtypes = [
        paths, ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_uint8),
        ctypes.c_long, ctypes.c_int, ctypes.c_int]
    lib.tfr_write_domain.restype = ctypes.c_long
    lib.tfr_write_domain.argtypes = [
        paths, ctypes.c_int, ctypes.c_char_p, ctypes.c_int, ctypes.c_int,
        ctypes.c_int]
    _lib = lib
    return _lib


def available() -> bool:
    return get_lib() is not None


def _paths_array(paths: Sequence[str]):
    encoded = [str(p).encode() for p in paths]
    return (ctypes.c_char_p * len(encoded))(*encoded)


def load_domain_native(records: Sequence[str], width: int,
                       verify_crc: bool = True,
                       n_threads: int = 0) -> Optional[np.ndarray]:
    """Every example of the shard list decoded and resized to an (N, width,
    width, 3) uint8 RGB array by the C++ loader; None where the library is
    unavailable or the decode fails (a CRC mismatch among them), and the
    caller decodes in Python."""
    lib = get_lib()
    if lib is None or not records:
        return None
    paths = _paths_array(records)
    count = lib.tfr_count_records(paths, len(records), int(verify_crc))
    if count < 0:
        logger.warning("native record count failed; the Python path decodes")
        return None
    out = np.empty((count, width, width, 3), np.uint8)
    n = lib.tfr_decode_domain(
        paths, len(records), width,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), count,
        int(verify_crc), n_threads)
    if n < 0:
        logger.warning("native decode failed; the Python path decodes")
        return None
    decoded["native"] += n
    return out[:n]


def write_domain_native(image_paths: Sequence[str], out_dir,
                        image_size: Optional[int] = None,
                        shard_size: int = 800,
                        n_threads: int = 0) -> Optional[int]:
    """Image files -> ``NNNNN.tfrecords`` shards of PNG-encoded Examples
    by the C++ writer (decode, optional resize, PNG encode, in parallel per
    image; shards in input order). Returns the number of images written,
    or None where the library is unavailable or the write fails."""
    lib = get_lib()
    if lib is None or not image_paths:
        return None
    written = lib.tfr_write_domain(
        _paths_array(image_paths), len(image_paths), str(out_dir).encode(),
        int(image_size or 0), int(shard_size), int(n_threads))
    if written < 0:
        logger.warning("native writer failed; the Python path writes")
        return None
    return int(written)
