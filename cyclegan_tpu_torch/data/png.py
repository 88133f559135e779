"""PNG encode and decode with the standard library (zlib) and numpy, for
machines without cv2 or PIL.

The decoder reads what the training records hold: 8-bit gray, gray with
alpha, RGB and RGBA, not interlaced, every one of the five row filters.
Each row is unfiltered by ``csrc/png_unfilter.c`` (one C call a row,
built with the host's compiler at first use, ``host_build.py``; a build
that fails raises with the compiler's output). Average and Paeth depend
on the byte just decoded to their left, which numpy cannot vectorize; the
plain version (``unfilter_row_plain``: Sub and Up vectorized, Average and
Paeth byte by byte in Python) is what the C function is tested against.
The encoder writes 8-bit RGB (or gray, or RGBA) rows, all with one filter,
None (0) unless asked.
"""

from __future__ import annotations

import ctypes
import struct
import zlib

import numpy as np

from cyclegan_tpu_torch.data import host_build

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}   # PNG colour type -> samples/pixel
_COLOUR_TYPE = {1: 0, 3: 2, 4: 6}


def _chunks(data: bytes):
    pos = len(_SIGNATURE)
    while pos + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        yield kind, data[pos + 8:pos + 8 + length]
        pos += 12 + length


def _average(line: np.ndarray, prev: np.ndarray, bpp: int) -> np.ndarray:
    cur = bytearray(line.tobytes())
    up = prev.tobytes()
    for i in range(len(cur)):
        left = cur[i - bpp] if i >= bpp else 0
        cur[i] = (cur[i] + ((left + up[i]) >> 1)) & 0xFF
    return np.frombuffer(bytes(cur), np.uint8)


def _paeth(line: np.ndarray, prev: np.ndarray, bpp: int) -> np.ndarray:
    cur = bytearray(line.tobytes())
    up = prev.tobytes()
    for i in range(len(cur)):
        a = cur[i - bpp] if i >= bpp else 0
        b = up[i]
        c = up[i - bpp] if i >= bpp else 0
        p = a + b - c
        pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
        pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
        cur[i] = (cur[i] + pred) & 0xFF
    return np.frombuffer(bytes(cur), np.uint8)


def unfilter_row_plain(kind: int, line: np.ndarray, prev: np.ndarray,
                       bpp: int) -> np.ndarray:
    """One row's filter undone in numpy and Python: the plain version of
    ``png_unfilter_row``."""
    if kind == 0:
        return line.copy()
    if kind == 1:  # Sub: a running sum of each sample along the row
        return np.cumsum(line.reshape(-1, bpp), axis=0,
                         dtype=np.uint8).reshape(-1)
    if kind == 2:  # Up
        return line + prev
    if kind == 3:
        return _average(line, prev, bpp)
    if kind == 4:
        return _paeth(line, prev, bpp)
    raise ValueError(f"PNG row filter {kind} unknown")


_unfilter = None


def _unfilter_fn():
    global _unfilter
    if _unfilter is None:
        lib = host_build.load("png_unfilter.c", ("-O3", "-std=c99"))
        fn = lib.png_unfilter_row
        fn.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_void_p, ctypes.c_long, ctypes.c_int]
        fn.restype = ctypes.c_int
        _unfilter = fn
    return _unfilter


def unfilter_row(kind: int, line: np.ndarray, prev: np.ndarray, bpp: int,
                 out: np.ndarray) -> None:
    """One row's filter undone into ``out`` (contiguous uint8 arrays of
    one length) by ``png_unfilter_row``."""
    if _unfilter_fn()(int(kind), line.ctypes.data, prev.ctypes.data,
                      out.ctypes.data, line.size, bpp):
        raise ValueError(f"PNG row filter {kind} unknown")


def decode_png(data: bytes) -> np.ndarray:
    """PNG bytes -> HxWx3 uint8 RGB (gray replicated, alpha dropped, as
    ``tf.image.decode_image(channels=3)``)."""
    if data[:len(_SIGNATURE)] != _SIGNATURE:
        raise ValueError("not a PNG")
    header, idat = None, []
    for kind, body in _chunks(data):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body[:13])
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None:
        raise ValueError("PNG without IHDR")
    width, height, depth, colour, compression, filtering, interlace = header
    if depth != 8 or colour not in _CHANNELS or interlace or compression \
            or filtering:
        raise ValueError(f"PNG not supported without cv2 or PIL: bit depth "
                         f"{depth}, colour type {colour}, interlace "
                         f"{interlace} (8-bit gray, RGB, RGBA, not "
                         f"interlaced, are)")
    bpp = _CHANNELS[colour]
    stride = width * bpp
    rows = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    rows = rows[:height * (stride + 1)].reshape(height, stride + 1)
    lines = np.ascontiguousarray(rows[:, 1:])
    out = np.empty((height, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(height):
        unfilter_row(rows[y, 0], lines[y], prev, bpp, out[y])
        prev = out[y]
    image = out.reshape(height, width, bpp)
    if bpp <= 2:
        return np.repeat(image[..., :1], 3, axis=2)
    return np.ascontiguousarray(image[..., :3])


def _chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))


def _filter_rows(rows: np.ndarray, bpp: int, kind: int) -> np.ndarray:
    """Filter every row of ``rows`` (H x stride uint8) with filter
    ``kind``, from the unfiltered neighbours (vectorized)."""
    x = rows.astype(np.int16)
    left = np.zeros_like(x)
    left[:, bpp:] = x[:, :-bpp]
    up = np.zeros_like(x)
    up[1:] = x[:-1]
    if kind == 0:
        pred = np.zeros_like(x)
    elif kind == 1:
        pred = left
    elif kind == 2:
        pred = up
    elif kind == 3:
        pred = (left + up) >> 1
    elif kind == 4:
        upleft = np.zeros_like(x)
        upleft[1:, bpp:] = x[:-1, :-bpp]
        p = left + up - upleft
        pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - upleft)
        pred = np.where((pa <= pb) & (pa <= pc), left,
                        np.where(pb <= pc, up, upleft))
    else:
        raise ValueError(f"PNG row filter {kind} unknown")
    return ((x - pred) & 0xFF).astype(np.uint8)


def encode_png(image: np.ndarray, row_filter: int = 0) -> bytes:
    """HxWxC uint8 (C = 1 gray, 3 RGB, 4 RGBA) -> PNG bytes, every row
    filtered with ``row_filter`` (0 None ... 4 Paeth)."""
    image = np.asarray(image, np.uint8)
    if image.ndim == 2:
        image = image[..., None]
    height, width, channels = image.shape
    if channels not in _COLOUR_TYPE:
        raise ValueError(f"PNG of {channels} channels")
    filtered = _filter_rows(image.reshape(height, width * channels),
                            channels, row_filter)
    rows = np.concatenate([np.full((height, 1), row_filter, np.uint8),
                           filtered], axis=1)
    header = struct.pack(">IIBBBBB", width, height, 8,
                         _COLOUR_TYPE[channels], 0, 0, 0)
    return (_SIGNATURE + _chunk(b"IHDR", header)
            + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
            + _chunk(b"IEND", b""))
