"""K10's launch (kernels/csrc/reflect_fold.cu), emulated in torch ops on the
CPU, against the plain version and the JAX package.

No CPU runs the kernel, so this holds its geometry and index map: the rule
``cuda_reflect.reflect_fold_geometry`` at every K10 launch of chip_smoke.py's
ResNet train plan and at its edge shapes, in bf16 and f32 (every recipe
launch but the stem's C = 3 on the vector path, the grid covering each
row's units once, every unaligned source offset reached); then the kernel,
emulated unit by unit: the split of a unit's index into channel and column,
the two aligned 16-byte loads of each source row around the unit's offset
(aligned to dxp, not to the row) and the kernel's shift of their 32-bit
words (selects, then ``__byte_perm`` for an odd bf16 offset), the f32 row
sums, the halo columns of a channel's first and last unit, read one
element at a time, and the rounded store into an output that starts as
NaN.
The emulation must write every element once and equal
``reflect_fold_plain`` bit for bit; against the VJP of the JAX package's
reflect pad (``jax.vjp`` of ``cyclegan_tpu.ops.pad.reflection_pad2d``, f32,
NHCW), which sums in another order, it must agree within 1e-6 of the sum of
its terms' magnitudes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from cyclegan_tpu.ops import layout as jax_layout
from cyclegan_tpu.ops.pad import reflection_pad2d as jax_reflection_pad2d
from cyclegan_tpu_torch.config import yaml2namespace
from cyclegan_tpu_torch.ops import cuda_reflect
from cyclegan_tpu_torch.ops.cuda_reflect import (FOLD_THREADS,
                                                 reflect_fold_geometry)

ESIZE = {torch.bfloat16: 2, torch.float32: 4}
WORD = {torch.bfloat16: torch.int16, torch.float32: torch.int32}
# the JAX fold adds the same terms in another order: each output within
# this share of the sum of its terms' magnitudes
JAX_RTOL = 1e-6


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in several worker processes."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# --- the geometry -----------------------------------------------------------

PLAN_SHAPES = sorted(set(chip_smoke.resnet_train_launches(
    yaml2namespace(chip_smoke.RESNET_CONFIG), 8, 256)["reflect_fold"]))
EDGES = chip_smoke.EDGE_FOLD_SHAPES["reflect_fold"]


def _check_geometry(b, h, c, p, esize, aligned=True):
    w = h
    geo = reflect_fold_geometry(b, h, c, w, p, esize, aligned)
    v = geo["v"]
    if geo["vec"]:
        assert v * esize == 16 and aligned
        assert w % v == 0 and p < v
        assert (b * (h + 2 * p) * c * (w + 2 * p)) % v == 0
    else:
        assert v == 1
    assert geo["units"] * v == c * w
    gx, gy = geo["grid"]
    assert (gx - 1) * FOLD_THREADS < geo["units"] <= gx * FOLD_THREADS
    assert gy == min(b * h, 65535)
    return geo


def _offsets(h, c, w, p, v):
    """The element offsets m of the vector path's source reads: (R c
    (w+2p) + c (w+2p) + w0 + p) mod v over every unit of every dxp row R
    of an image."""
    wp = w + 2 * p
    rr = torch.arange(h + 2 * p)[:, None, None]
    cc = torch.arange(c)[None, :, None]
    w0 = torch.arange(0, w, v)[None, None, :]
    return set(((rr * c * wp + cc * wp + w0 + p) % v).reshape(-1).tolist())


@pytest.mark.parametrize("esize", [2, 4])
def test_geometry_covers_every_train_launch(esize):
    """Every K10 launch of the ResNet step takes the vector path: the
    trunk (64x64, 128 channels, p 1), the head (256x256, 32 channels, p 3)
    and the stem (3 channels, p 3), whose dxp rows of 1,572 bf16 bytes
    start off 16-byte units (the windows are aligned to dxp, not to a
    row)."""
    assert PLAN_SHAPES == [(8, 64, 128, 1), (8, 256, 3, 3), (8, 256, 32, 3)]
    for b, h, c, p in PLAN_SHAPES:
        assert _check_geometry(b, h, c, p, esize)["vec"], (b, h, c, p)


@pytest.mark.parametrize("esize", [2, 4])
def test_geometry_of_the_edge_shapes(esize):
    """chip_smoke.py's EDGE_FOLD_SHAPES take the paths they are there for,
    and with the recipes' launches the vector path meets every unaligned
    source offset."""
    dtype = torch.bfloat16 if esize == 2 else torch.float32
    vecs = [esize == 4, esize == 2, True, esize == 2, False, True, False]
    seen = set()
    for shape, vec in zip(EDGES, vecs):
        b, h, c, p, off = shape
        geo = _check_geometry(b, h, c, p, esize, not off)
        assert geo["vec"] == vec, shape
        assert chip_smoke.expected_path("reflect_fold", shape, dtype) == (
            "vector" if vec else "element")
        if vec:
            seen |= _offsets(h, c, h, p, geo["v"])
    plan = set()
    for b, h, c, p in PLAN_SHAPES:
        geo = reflect_fold_geometry(b, h, c, h, p, esize)
        if geo["vec"]:
            plan |= _offsets(h, c, h, p, geo["v"])
    assert seen | plan == set(range(16 // esize))


def test_unaligned_pointers_take_the_element_path():
    assert reflect_fold_geometry(8, 64, 128, 64, 1, 2)["vec"]
    geo = reflect_fold_geometry(8, 64, 128, 64, 1, 2, aligned=False)
    assert not geo["vec"] and geo["v"] == 1 and geo["units"] == 128 * 64


# --- the emulated kernel ----------------------------------------------------

def _unsigned(t):
    return t.long() & 0xFFFFFFFF


def _signed(t):
    return torch.where(t >= 2 ** 31, t - 2 ** 32, t).to(torch.int32)


def _shifted_words(words, m, esize):
    """The kernel's ``shifted``: words [..., 8] of two aligned units,
    offsets m [...] -> the 4 words at element offset m."""
    epw = 4 // esize
    s = m // epw
    v = _unsigned(words)
    t1 = torch.where(((s & 2) != 0)[..., None], v[..., 2:8], v[..., 0:6])
    t2 = torch.where(((s & 1) != 0)[..., None], t1[..., 1:6], t1[..., 0:5])
    half = ((m & 1) != 0) & (epw == 2)
    perm = (t2[..., :4] >> 16) | ((t2[..., 1:5] & 0xFFFF) << 16)
    return torch.where(half[..., None], perm, t2[..., :4])


def _unit_values(words, esize):
    """f32 values of the elements of 4-word units: [..., 4] -> [..., V]"""
    u = _unsigned(words)
    if esize == 4:
        return _signed(u).view(torch.float32)
    pair = torch.stack([(u << 16) & 0xFFFFFFFF, u & 0xFFFF0000], dim=-1)
    return _signed(pair.reshape(*u.shape[:-1], 8)).view(torch.float32)


def _window(flat_words, row, q, v, esize):
    """``window_values``' two aligned loads and ``shifted``: the 4 words
    of dxp's elements [row + q, row + q + v) at each (row start, offset):
    [R, U, 4]."""
    off = row[:, None] + q[None, :]
    m = off % v
    idx = ((off - m) * esize // 4)[..., None] + torch.arange(8)
    # the second unit, read where m > 0, stays inside dxp
    assert bool((idx[m > 0] < flat_words.numel()).all())
    words = flat_words[idx.clamp(max=flat_words.numel() - 1)]
    return _shifted_words(words, m, esize)


def emulate(dxp, p, aligned=True):
    """K10's output as its units write it: (dx, writes per element)."""
    b, hp, c, wp = dxp.shape
    h, w = hp - 2 * p, wp - 2 * p
    esize = ESIZE[dxp.dtype]
    geo = reflect_fold_geometry(b, h, c, w, p, esize, aligned)
    v = geo["v"]
    src = dxp.float().reshape(-1)
    flat_words = dxp.reshape(-1).view(torch.int32) if v > 1 else None
    out = torch.full((b * h * c * w,), float("nan"), dtype=dxp.dtype)
    writes = torch.zeros(out.numel(), dtype=torch.int64)
    gx, gy = geo["grid"]
    u = torch.arange(gx * FOLD_THREADS)
    u = u[u < geo["units"]]
    per_c = w // v
    cu = u // per_c                  # channel and column order
    w0 = (u - cu * per_c) * v
    rows = torch.cat([torch.arange(by, b * h, gy) for by in range(gy)])
    bb, hh = rows // h, rows % h
    plane = c * wp
    has_top = (hh >= 1) & (hh <= p)
    has_bot = (hh >= h - 1 - p) & (hh <= h - 2)
    irow = (bb * hp + hh + p) * plane
    trow = (bb * hp + torch.where(has_top, p - hh, 0)) * plane
    brow = (bb * hp + torch.where(has_bot, 2 * h + p - 2 - hh, 0)) * plane
    c0 = cu * wp
    q = c0 + w0 + p

    def window(row):
        if v == 1:
            return src[row[:, None] + q[None, :]][..., None]
        return _unit_values(_window(flat_words, row, q, v, esize), esize)

    s = window(irow)                                 # [R, U, v]
    s = torch.where(has_top[:, None, None], s + window(trow), s)
    s = torch.where(has_bot[:, None, None], s + window(brow), s)
    # the halo columns, one element at a time: on the vector path the
    # first and the last unit of a channel (p < v), at fixed elements
    col = w0[:, None] + torch.arange(v)              # [U, v]
    left = (col >= 1) & (col <= p)
    right = (col >= w - 1 - p) & (col <= w - 2)
    if v > 1:
        assert bool((left.any(1) <= (w0 == 0)).all())
        assert bool((right.any(1) <= (w0 == w - v)).all())
    for has, at in ((left, p - col), (right, 2 * w + p - 2 - col)):
        at = c0[:, None] + torch.where(has, at, 0)
        t = src[irow[:, None, None] + at]
        t = torch.where(has_top[:, None, None],
                        t + src[trow[:, None, None] + at], t)
        t = torch.where(has_bot[:, None, None],
                        t + src[brow[:, None, None] + at], t)
        s = torch.where(has, s + t, s)
    dst = ((rows[:, None] * c + cu[None, :]) * w + w0[None, :])[..., None] + \
        torch.arange(v)
    out[dst.reshape(-1)] = s.to(dxp.dtype).reshape(-1)
    writes.index_add_(0, dst.reshape(-1),
                      torch.ones(dst.numel(), dtype=torch.int64))
    return out.view(b, h, c, w), writes


# (B, H, C, p, aligned): the trunk's p = 1, the head's p = 3 and the
# stem's C = 3 (dxp rows off 16-byte units) at 32x32, the edge shapes (both
# halos everywhere, offsets 2, 4 and 6, an odd C, p = 0), and the element
# path at an aligned shape, as a view off alignment takes it
EMULATED = [(2, 32, 32, 1, True), (2, 32, 16, 3, True),
            (2, 32, 3, 3, True)] + [
    (b, h, c, p, not off) for b, h, c, p, off in EDGES]


def _dxp(b, h, c, p, dtype, seed):
    a = np.random.default_rng(seed).normal(
        size=(b, h + 2 * p, c, h + 2 * p)).astype(np.float32)
    return torch.from_numpy(a).to(dtype)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", EMULATED)
def test_emulated_kernel_equals_plain(shape, dtype):
    b, h, c, p, aligned = shape
    dxp = _dxp(b, h, c, p, dtype, EMULATED.index(shape))
    out, writes = emulate(dxp, p, aligned)
    assert bool((writes == 1).all())      # every element written once
    want = cuda_reflect.reflect_fold_plain(dxp, p)
    assert out.shape == want.shape
    assert torch.equal(out.view(WORD[dtype]), want.view(WORD[dtype]))


@pytest.mark.parametrize("shape", EMULATED[:-1])
def test_emulated_kernel_matches_the_vjp_of_jax_reflect_pad(shape):
    b, h, c, p, _ = shape
    dxp = _dxp(b, h, c, p, torch.float32, 7 + EMULATED.index(shape))
    out, _ = emulate(dxp, p)
    with jax_layout.nhcw():
        _, vjp = jax.vjp(lambda a: jax_reflection_pad2d(a, (p, p)),
                         jnp.zeros((b, h, c, h), jnp.float32))
        (want,) = vjp(jnp.asarray(dxp.numpy()))
    want = np.asarray(want)
    scale = cuda_reflect.reflect_fold_plain(dxp.abs(), p).numpy()
    err = np.abs(out.numpy() - want)
    assert (err <= JAX_RTOL * scale).all(), float((err / scale).max())
