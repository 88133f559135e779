"""``jax.random``'s default generator in numpy: ``PRNGKey``, ``split``,
``bits`` and ``normal`` for JAX's defaults (threefry2x32 with
``jax_threefry_partitionable`` on, the default since JAX 0.5), so that the
port draws the same seeded weights as the JAX package
(``utils/quality.py``'s random-feature extractor).

Keys and raw bits are bit-exact. ``normal`` is
sqrt(2) * erfinv(u) with u uniform in (-1, 1), as ``jax.random.normal``;
erfinv is XLA's f32 polynomial (M. Giles, "Approximating the erfinv
function"), evaluated here in f32 numpy: XLA may fuse or order a step
differently, so a normal can differ from JAX's in its last bits.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = np.uint32(0x1BD11BDA)
# erfinv's coefficients for w = -log1p(-x^2) < 5 and >= 5 (Horner order)
_ERFINV_SMALL = np.array([2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
                          -4.39150654e-06, 0.00021858087, -0.00125372503,
                          -0.00417768164, 0.246640727, 1.50140941],
                         np.float32)
_ERFINV_LARGE = np.array([-0.000200214257, 0.000100950558, 0.00134934322,
                          -0.00367342844, 0.00573950773, -0.0076224613,
                          0.00943887047, 1.00167406, 2.83297682], np.float32)


def _rotl(x: np.ndarray, d: int) -> np.ndarray:
    return (x << np.uint32(d)) | (x >> np.uint32(32 - d))


def threefry2x32(key: np.ndarray, x0: np.ndarray,
                 x1: np.ndarray) -> tuple:
    """The Threefry-2x32 hash (20 rounds) of the counter pairs (x0, x1)
    under ``key`` (two uint32), as XLA lowers ``threefry2x32_p``."""
    k = np.asarray(key, np.uint32)
    ks = (k[0], k[1], k[0] ^ k[1] ^ _PARITY)
    x0 = np.asarray(x0, np.uint32) + ks[0]
    x1 = np.asarray(x1, np.uint32) + ks[1]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = x0 + x1
            x1 = _rotl(x1, r) ^ x0
        x0 = x0 + ks[(i + 1) % 3]
        x1 = x1 + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x0, x1


def prng_key(seed: int) -> np.ndarray:
    """``jax.random.PRNGKey(seed)`` for a 32-bit seed: [0, seed]."""
    return np.array([0, int(seed) & 0xFFFFFFFF], np.uint32)


def _counters(shape: Sequence[int]):
    """The flat index of each element as (high, low) uint32 halves."""
    n = int(np.prod(shape, dtype=np.int64))
    index = np.arange(n, dtype=np.uint64).reshape(tuple(shape))
    return ((index >> np.uint64(32)).astype(np.uint32),
            (index & np.uint64(0xFFFFFFFF)).astype(np.uint32))


def split(key: np.ndarray, num: int = 2) -> np.ndarray:
    """``jax.random.split(key, num)``: uint32 [num, 2]."""
    hi, lo = _counters((num,))
    b0, b1 = threefry2x32(key, hi, lo)
    return np.stack([b0, b1], axis=-1)


def bits(key: np.ndarray, shape: Sequence[int]) -> np.ndarray:
    """``jax.random.bits(key, shape)``, uint32."""
    hi, lo = _counters(shape)
    b0, b1 = threefry2x32(key, hi, lo)
    return b0 ^ b1


def erfinv_f32(x: np.ndarray) -> np.ndarray:
    """XLA's f32 erfinv polynomial, in f32."""
    x = np.asarray(x, np.float32)
    with np.errstate(divide="ignore", invalid="ignore"):
        w = -np.log1p(-x * x)
        small = w < np.float32(5.0)
        w = np.where(small, w - np.float32(2.5),
                     np.sqrt(w) - np.float32(3.0)).astype(np.float32)
        p = np.where(small, _ERFINV_SMALL[0], _ERFINV_LARGE[0])
        for cs, cl in zip(_ERFINV_SMALL[1:], _ERFINV_LARGE[1:]):
            p = (np.where(small, cs, cl) + p * w).astype(np.float32)
        out = (p * x).astype(np.float32)
        return np.where(np.abs(x) == 1, x * np.float32(np.inf), out)


def normal(key: np.ndarray, shape: Sequence[int]) -> np.ndarray:
    """``jax.random.normal(key, shape)`` in float32."""
    lo = np.nextafter(np.float32(-1.0), np.float32(0.0))
    hi = np.float32(1.0)
    mantissa = (bits(key, shape) >> np.uint32(9)) | np.uint32(0x3F800000)
    floats = mantissa.view(np.float32) - np.float32(1.0)
    u = np.maximum(lo, floats * (hi - lo) + lo).astype(np.float32)
    return (np.float32(np.sqrt(2)) * erfinv_f32(u)).astype(np.float32)
