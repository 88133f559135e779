"""K8's launch (kernels/csrc/split_pool2.cu), emulated in torch ops on the
CPU, against the plain version and the JAX package.

No CPU runs the kernel, so this holds its geometry and index map: K4's
rule ``cuda_concat.concat_up2_geometry``, which K8 takes, at every K8
launch of chip_smoke.py's train plans and at its edge shapes, in bf16 and
f32 (every recipe launch on the vector path, the grid covering each row
pair's units once); then the kernel's per-unit map, emulated: a skip
unit's 16-byte copy from its g row into dskip, a pooled unit's two 16-byte
loads from the pair's rows summed in the kernel's order, (a[2j] + b[2j]) +
(a[2j+1] + b[2j+1]) in f32 from the words' halves (bf16), and rounded once
into 8 bytes of dx, or the element path's copies and sums, scattered into
outputs that start as NaN. The emulation must write every element once and
equal ``split_pool2_plain`` bit for bit, and the JAX package's junction
gradient: the VJP of ``pallas_concat.concat_up2_nhcw`` in interpret mode
(bf16) and of the XLA ``upsample_concat`` (f32), as
``tests/test_torch_kernels_bwd.py`` runs them.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from cyclegan_tpu.ops import layout as jax_layout
from cyclegan_tpu.ops import packctx, pallas_concat
from cyclegan_tpu.ops.resize import upsample_concat as jax_upsample_concat
from cyclegan_tpu_torch.config import yaml2namespace
from cyclegan_tpu_torch.ops import cuda_concat
from cyclegan_tpu_torch.ops.cuda_concat import (JUNCTION_THREADS,
                                                concat_up2_geometry)

ESIZE = {torch.bfloat16: 2, torch.float32: 4}
WORD = {torch.bfloat16: torch.int16, torch.float32: torch.int32}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in several worker processes."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# --- the geometry -----------------------------------------------------------

def _plan_shapes():
    """{(B, H, C1, C2)} of every K8 launch of chip_smoke.py's four train
    plans (batch 8, 256x256; W = H). Serving runs no K8."""
    cfgs = {"unet": chip_smoke.MODEL_DIR / "model_config.yaml",
            "resnet": chip_smoke.RESNET_CONFIG,
            "unet_transpose": chip_smoke.TRANSPOSE_CONFIG,
            "strided": chip_smoke.STRIDED_CONFIG}
    shapes = set()
    for name, path in cfgs.items():
        cfg = yaml2namespace(path)
        plan = (chip_smoke.resnet_train_launches if name == "resnet"
                else chip_smoke.train_launches)(cfg, 8, 256)
        shapes.update(plan.get("split_pool2", []))
    return sorted(shapes)


PLAN_SHAPES = _plan_shapes()


def _check_geometry(b, h, c1, c2, esize, aligned=True):
    w = h
    geo = concat_up2_geometry(b, h, c1, c2, w, esize, aligned)
    vs, vx = geo["vs"], geo["vx"]
    if geo["vec"]:
        # a skip unit: 16 bytes; a pooled unit: 16 bytes of each g row in,
        # 8 bytes of dx out
        assert vs * esize == 16 and vx * esize == 8 and 2 * vx == vs
    else:
        assert vs == vx == 1
    assert geo["skip_units"] * vs == c1 * w
    assert geo["x_units"] * vx == c2 * (w // 2)
    units = 2 * geo["skip_units"] + geo["x_units"]
    gx, gy = geo["grid"]
    assert (gx - 1) * JUNCTION_THREADS < units <= gx * JUNCTION_THREADS
    assert geo["pairs"] == b * h // 2 and gy == min(geo["pairs"], 65535)
    return geo


@pytest.mark.parametrize("esize", [2, 4])
def test_geometry_covers_every_plan_launch(esize):
    """Every K8 launch of the recipes' train steps (the default U-Net's
    and the strided U-Net's discriminator junctions) takes the vector
    path, in bf16 and f32, its grid covering each row pair's units."""
    assert PLAN_SHAPES == [(8, 64, 64, 128), (8, 128, 32, 64),
                           (8, 128, 32, 128), (8, 256, 16, 64)]
    for b, h, c1, c2 in PLAN_SHAPES:
        assert _check_geometry(b, h, c1, c2, esize)["vec"], (b, h, c1, c2)


@pytest.mark.parametrize("esize", [2, 4])
def test_geometry_of_the_edge_shapes(esize):
    """chip_smoke.py's EDGE_JUNCTION_SHAPES for K8: W/2 = 18 keeps the
    vector path; odd C1 and C2 at W = 34, and g one element off alignment,
    take the element path."""
    dtype = torch.bfloat16 if esize == 2 else torch.float32
    edges = chip_smoke.EDGE_JUNCTION_SHAPES["split_pool2"]
    for shape, vec in zip(edges, [True, False, False]):
        b, h, c1, c2, off = shape
        assert _check_geometry(b, h, c1, c2, esize, not off)["vec"] == vec
        assert chip_smoke.expected_path("split_pool2", shape, dtype) == (
            "vector" if vec else "element")


# --- the emulated kernel ----------------------------------------------------

def _f32_halves(words):
    """32-bit words of two bf16 -> their f32 values (low, high): the low
    half shifted up 16 bits and the high half masked, as ``pool_bf16x2``
    reads them."""
    u = words.long() & 0xFFFFFFFF
    lo = ((u & 0xFFFF) << 16).to(torch.int32).view(torch.float32)
    hi = (u & 0xFFFF0000).to(torch.int32).view(torch.float32)
    return lo, hi


def _pool_words(a, b, esize):
    """Two 16-byte units' 32-bit words (..., 4), of g rows 2k and 2k + 1,
    -> the 8-byte dx unit the kernel stores, as dtype-sized words (bf16:
    (..., 4) of int16; f32: (..., 2) of int32)."""
    if esize == 4:
        p, q = a.view(torch.float32), b.view(torch.float32)
        out = (p[..., 0::2] + q[..., 0::2]) + (p[..., 1::2] + q[..., 1::2])
        return out.view(torch.int32)
    (plo, phi), (qlo, qhi) = _f32_halves(a), _f32_halves(b)
    out = (plo + qlo) + (phi + qhi)     # one sum per word pair
    return out.to(torch.bfloat16).view(torch.int16)


def emulate(g, c1, aligned=True):
    """K8's outputs as its units write them: (dskip, dx, writes per
    element of dskip, of dx)."""
    b, h, c, w = g.shape
    c2 = c - c1
    esize = ESIZE[g.dtype]
    geo = concat_up2_geometry(b, h, c1, c2, w, esize, aligned)
    n1, m = c1 * w, c2 * (w // 2)
    row = n1 + 2 * m
    ms, mx, vs, vx = geo["skip_units"], geo["x_units"], geo["vs"], geo["vx"]
    bits = WORD[g.dtype]
    dskip = torch.full((b * h * n1,), float("nan"), dtype=g.dtype)
    dx = torch.full((b * (h // 2) * m,), float("nan"), dtype=g.dtype)
    dskip_bits, dx_bits = dskip.view(bits), dx.view(bits)
    skip_writes = torch.zeros(dskip.numel(), dtype=torch.int64)
    dx_writes = torch.zeros(dx.numel(), dtype=torch.int64)
    g_bits = g.reshape(-1).view(bits)
    gx, gy = geo["grid"]
    # thread u of block (bx, by): unit bx T + tx of the pairs by, by + gy..
    u = torch.arange(gx * JUNCTION_THREADS)
    u = u[u < 2 * ms + mx]
    k = torch.cat([torch.arange(by, geo["pairs"], gy) for by in range(gy)])
    pair = (k * 2 * row)[:, None]
    # skip units: 16 bytes (or one element) of g row 2k + r into dskip
    us = u[u < 2 * ms]
    r = (us >= ms).long()
    e = torch.arange(vs)
    src = pair[..., None] + (r * row + (us - r * ms) * vs)[None, :, None] + e
    dst = (k * 2 * n1)[:, None, None] + (us * vs)[None, :, None] + e
    dskip_bits[dst.reshape(-1)] = g_bits[src.reshape(-1)]
    skip_writes.index_add_(0, dst.reshape(-1),
                           torch.ones(dst.numel(), dtype=torch.int64))
    # pooled units: 2 vx elements of each g row of the pair -> vx of dx
    ex = (u[u >= 2 * ms] - 2 * ms) * vx
    top = pair + n1 + 2 * ex[None, :]       # element n1 + 2e of row 2k
    if vx == 1:
        a = g.reshape(-1)[top[..., None] + torch.arange(2)].float()
        bb = g.reshape(-1)[top[..., None] + row + torch.arange(2)].float()
        vals = ((a[..., 0] + bb[..., 0]) + (a[..., 1] + bb[..., 1])).to(
            g.dtype).view(bits)[..., None]
    else:
        words = g.reshape(-1).view(torch.int32)
        w0 = (top * esize // 4)[..., None] + torch.arange(4)
        vals = _pool_words(words[w0], words[w0 + row * esize // 4], esize)
    dst = ((k * m)[:, None] + ex[None, :])[..., None] + torch.arange(vx)
    dx_bits[dst.reshape(-1)] = vals.reshape(-1)
    dx_writes.index_add_(0, dst.reshape(-1),
                         torch.ones(dst.numel(), dtype=torch.int64))
    return (dskip.view(b, h, c1, w), dx.view(b, h // 2, c2, w // 2),
            skip_writes, dx_writes)


# (B, H, C1, C2, aligned): the vector path at 32x32; W/2 = 18 on the
# vector path; odd C1 and C2 at W = 34 (the element path); the element
# path at an aligned shape, as g off alignment takes it
EMULATED = [(2, 32, 16, 32, True), (2, 36, 8, 16, True), (2, 34, 3, 5, True),
            (2, 64, 16, 32, False)]


def _grad(b, h, c1, c2, dtype, seed):
    rng = np.random.default_rng(seed)
    g = rng.normal(size=(b, h, c1 + c2, h)).astype(np.float32)
    return torch.from_numpy(g).to(dtype)


def _same_bits(a, b):
    assert a.shape == b.shape and a.dtype == b.dtype
    assert torch.equal(a.view(WORD[a.dtype]), b.view(WORD[b.dtype]))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", EMULATED)
def test_emulated_kernel_equals_plain(shape, dtype):
    b, h, c1, c2, aligned = shape
    g = _grad(b, h, c1, c2, dtype, EMULATED.index(shape))
    geo = concat_up2_geometry(b, h, c1, c2, h, ESIZE[dtype], aligned)
    assert geo["vec"] == (aligned and c1 % 2 == 0)
    dskip, dx, skip_writes, dx_writes = emulate(g, c1, aligned)
    assert bool((skip_writes == 1).all())    # every element written once
    assert bool((dx_writes == 1).all())
    want_skip, want_dx = cuda_concat.split_pool2_plain(g, c1)
    _same_bits(dskip, want_skip)
    _same_bits(dx, want_dx)


def _jnp(t):
    return jnp.asarray(t.float().numpy(),
                       jnp.bfloat16 if t.dtype == torch.bfloat16
                       else jnp.float32)


# (B, H, C1, C2): the junction at 64x64 and at 32x32 (W = H)
JAX_SHAPES = [(2, 64, 16, 64), (2, 32, 64, 128)]


def _primals(b, h, c1, c2, dtype):
    rng = np.random.default_rng(7)
    skip = rng.normal(size=(b, h, c1, h)).astype(np.float32)
    x = rng.normal(size=(b, h // 2, c2, h // 2)).astype(np.float32)
    return (_jnp(torch.from_numpy(skip).to(dtype)),
            _jnp(torch.from_numpy(x).to(dtype)))


@pytest.mark.parametrize("shape", JAX_SHAPES)
def test_emulated_kernel_equals_pallas_bf16(shape):
    b, h, c1, c2 = shape
    g = _grad(b, h, c1, c2, torch.bfloat16, 51)
    dskip, dx, _, _ = emulate(g, c1)
    with packctx.scope(True, interpret=True):
        _, vjp = jax.vjp(pallas_concat.concat_up2_nhcw,
                         *_primals(b, h, c1, c2, torch.bfloat16))
        ref_dskip, ref_dx = vjp(_jnp(g))
    np.testing.assert_array_equal(dskip.float().numpy(),
                                  np.asarray(ref_dskip, np.float32))
    np.testing.assert_array_equal(dx.float().numpy(),
                                  np.asarray(ref_dx, np.float32))


@pytest.mark.parametrize("shape", JAX_SHAPES + [(2, 34, 3, 5)])
def test_emulated_kernel_equals_xla_f32(shape):
    b, h, c1, c2 = shape
    g = _grad(b, h, c1, c2, torch.float32, 53)
    dskip, dx, _, _ = emulate(g, c1)
    with jax_layout.nhcw():
        _, vjp = jax.vjp(jax_upsample_concat,
                         *_primals(b, h, c1, c2, torch.float32))
        ref_dskip, ref_dx = vjp(_jnp(g))
    np.testing.assert_array_equal(dskip.numpy(), np.asarray(ref_dskip))
    # XLA's VJP adds the four terms in another order: f32 rounding of a
    # sum of four, as tests/test_torch_kernels_bwd.py holds the junction
    np.testing.assert_allclose(dx.numpy(), np.asarray(ref_dx), rtol=0,
                               atol=1e-5 * 4 * float(g.abs().max()))
