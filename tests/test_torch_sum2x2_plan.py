"""K3's launch (kernels/csrc/sum2x2.cu), emulated in torch ops on the
CPU, against the plain version and the JAX package.

No CPU runs the kernel, so this holds its geometry and index map: the rule
``cuda_resize.sum2x2_geometry`` at every K3 launch of chip_smoke.py's
train and serving plans and at its edge shapes, in bf16 and f32 (every
recipe launch on the vector path, the grid covering each row's units
once); then the kernel's per-unit map, emulated: 16 bytes of each x row of
a pair read as 32-bit words, each bf16 half made f32 by a shift or a mask
as ``pool_bf16x2`` does, the row pair added, then the column pair, then
the scale, rounded once and stored as 8 bytes of the output row, or the
element path's one element a unit, scattered into an output that starts
as NaN. The emulation must write every element once and equal
``sum2x2_plain`` bit for bit at scales 1/4, 1 and 0.3, the JAX package's
bf16 Pallas pool (``pallas_resize.avg_pool2x2_nhcw`` in interpret mode)
bit for bit, and the XLA ``avg_pool2x2`` in f32 within ``F32_TOL``, as
``tests/test_torch_kernels.py`` runs them.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from cyclegan_tpu.ops import layout as jax_layout
from cyclegan_tpu.ops import packctx, pallas_resize
from cyclegan_tpu.ops.pool import avg_pool2x2 as jax_avg_pool2x2
from cyclegan_tpu_torch.config import yaml2namespace
from cyclegan_tpu_torch.ops import cuda_resize
from cyclegan_tpu_torch.ops.cuda_resize import POOL_THREADS, sum2x2_geometry

ESIZE = {torch.bfloat16: 2, torch.float32: 4}
WORD = {torch.bfloat16: torch.int16, torch.float32: torch.int32}
F32_TOL = dict(rtol=0, atol=1e-5)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in several worker processes."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# --- the geometry -----------------------------------------------------------

def _plan_shapes():
    """{(B, H, C)} of every K3 launch of chip_smoke.py's four train plans
    and serving forwards (batch 8, 256x256; W = H, the input side). The
    NHWC steps run no K3."""
    cfgs = {"unet": chip_smoke.MODEL_DIR / "model_config.yaml",
            "resnet": chip_smoke.RESNET_CONFIG,
            "unet_transpose": chip_smoke.TRANSPOSE_CONFIG,
            "strided": chip_smoke.STRIDED_CONFIG}
    shapes = set()
    for name, path in cfgs.items():
        cfg = yaml2namespace(path)
        train = (chip_smoke.resnet_train_launches if name == "resnet"
                 else chip_smoke.train_launches)(cfg, 8, 256)
        serve = (chip_smoke.resnet_generator_launches if name == "resnet"
                 else chip_smoke.serve_launches)(cfg.generator, 8, 256)
        nhwc = chip_smoke.nhwc_train_launches(cfg, 8, 256)
        assert "sum2x2" not in nhwc
        shapes.update(train.get("sum2x2", []))
        shapes.update(serve.get("sum2x2", []))
    return sorted(shapes)


PLAN_SHAPES = _plan_shapes()


def _check_geometry(b, h, c, esize, aligned=True):
    w = h
    geo = sum2x2_geometry(b, h, c, w, esize, aligned)
    vx = geo["vx"]
    assert vx * esize == 8 if geo["vec"] else vx == 1
    assert geo["units"] * vx == c * (w // 2)
    gx, gy = geo["grid"]
    assert (gx - 1) * POOL_THREADS < geo["units"] <= gx * POOL_THREADS
    assert geo["rows"] == b * (h // 2) and gy == min(b * (h // 2), 65535)
    return geo


@pytest.mark.parametrize("esize", [2, 4])
def test_geometry_covers_every_plan_launch(esize):
    """Every K3 launch of the recipes' train steps and serving forwards
    (the default U-Net's, T's and S's pools) takes the vector path, in
    bf16 and f32, its grid covering each row's units."""
    assert PLAN_SHAPES == [(8, 64, 64), (8, 128, 32), (8, 256, 16)]
    for b, h, c in PLAN_SHAPES:
        assert _check_geometry(b, h, c, esize)["vec"], (b, h, c)


@pytest.mark.parametrize("esize", [2, 4])
def test_geometry_of_the_edge_shapes(esize):
    """chip_smoke.py's EDGE_POOL_SHAPES: an odd C with an odd W/2 takes the
    element path; an odd C with whole-unit rows and W/2 = 10 at C = 8 keep
    the vector path (the map needs whole rows, not whole channels); x one
    element off alignment takes the element path."""
    dtype = torch.bfloat16 if esize == 2 else torch.float32
    edges = chip_smoke.EDGE_POOL_SHAPES["sum2x2"]
    for shape, vec in zip(edges, [False, True, True, False]):
        b, h, c, off = shape
        assert _check_geometry(b, h, c, esize, not off)["vec"] == vec
        assert chip_smoke.expected_path("sum2x2", shape, dtype) == (
            "vector" if vec else "element")


def test_unaligned_pointers_take_the_element_path():
    assert sum2x2_geometry(8, 256, 16, 256, 2)["vec"]
    assert not sum2x2_geometry(8, 256, 16, 256, 2, False)["vec"]


def test_the_grid_loops_past_the_row_limit():
    """More than 65535 output rows: grid y stops at the limit and each
    block walks rows by, by + 65535, ..."""
    geo = sum2x2_geometry(600, 256, 2, 8, 2)
    assert geo["rows"] == 76800 and geo["grid"] == (1, 65535)


# --- the emulated kernel ----------------------------------------------------

def _as_f32(bits):
    """int64 bit patterns (0..2^32) -> f32 values."""
    bits = torch.where(bits >= 2 ** 31, bits - 2 ** 32, bits)
    return bits.to(torch.int32).view(torch.float32)


def _pool_words(p, q, esize, scale):
    """The 8 bytes one vector unit stores, as 16-bit (bf16) or 32-bit
    (f32) words (..., 4 or 2), from the 32-bit words p, q (..., 4) of the
    unit's 16 bytes of the two rows: per word pair, (a0 + b0) + (a1 + b1)
    in f32, times scale, rounded once."""
    if esize == 4:
        a, b = p.view(torch.float32), q.view(torch.float32)
        s = ((a[..., 0::2] + b[..., 0::2]) + (a[..., 1::2] + b[..., 1::2]))
        return (s * scale).view(torch.int32)
    u, v = p.long() & 0xFFFFFFFF, q.long() & 0xFFFFFFFF
    left = _as_f32((u & 0xFFFF) << 16) + _as_f32((v & 0xFFFF) << 16)
    right = _as_f32(u & 0xFFFF0000) + _as_f32(v & 0xFFFF0000)
    return ((left + right) * scale).to(torch.bfloat16).view(torch.int16)


def emulate(x, scale, aligned=True):
    """K3's output as its units write it: (out, writes per element)."""
    b, h, c, w = x.shape
    esize = ESIZE[x.dtype]
    geo = sum2x2_geometry(b, h, c, w, esize, aligned)
    m, vx = c * (w // 2), geo["vx"]
    bits = WORD[x.dtype]
    out = torch.full((b * (h // 2) * m,), float("nan"), dtype=x.dtype)
    out_bits = out.view(bits)
    writes = torch.zeros(out.numel(), dtype=torch.int64)
    gx, gy = geo["grid"]
    # thread u of block (bx, by): unit bx T + tx of the rows by, by + gy..
    u = torch.arange(gx * POOL_THREADS)
    u = u[u < geo["units"]]
    i = torch.cat([torch.arange(by, geo["rows"], gy) for by in range(gy)])
    e = u * vx
    a = (i * 4 * m)[:, None] + 2 * e[None, :]       # row 2i, element 2e
    flat = x.reshape(-1)
    if vx == 1:
        f = flat.float()
        s = (f[a] + f[a + 2 * m]) + (f[a + 1] + f[a + 2 * m + 1])
        vals = (s * scale).to(x.dtype).view(bits)[..., None]
    else:
        words = flat.view(torch.int32)
        w0 = (a * esize // 4)[..., None] + torch.arange(4)
        vals = _pool_words(words[w0], words[w0 + 2 * m * esize // 4], esize,
                           scale)
    dst = ((i * m)[:, None] + e[None, :])[..., None] + torch.arange(vx)
    out_bits[dst.reshape(-1)] = vals.reshape(-1)
    writes.index_add_(0, dst.reshape(-1),
                      torch.ones(dst.numel(), dtype=torch.int64))
    return out.view(b, h // 2, c, w // 2), writes


# (B, H, C, aligned): the vector path at 32x32; an odd C with whole-unit
# rows and W/2 = 10 at C = 8 on the vector path; an odd C with an odd W/2
# (the element path); the element path at an aligned shape, as x off
# alignment takes it
EMULATED = [(2, 32, 16, True), (2, 16, 3, True), (2, 20, 8, True),
            (2, 18, 3, True), (2, 32, 8, False)]


def _inputs(b, h, c, dtype, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, h, c, h)).astype(np.float32)
    return torch.from_numpy(x).to(dtype)


def _same_bits(a, b):
    assert a.shape == b.shape and a.dtype == b.dtype
    assert torch.equal(a.view(WORD[a.dtype]), b.view(WORD[b.dtype]))


@pytest.mark.parametrize("scale", [0.25, 1.0, 0.3])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", EMULATED)
def test_emulated_kernel_equals_plain(shape, dtype, scale):
    """At the pool's 1/4, at 1 (a plain block sum) and at 0.3, whose
    products round."""
    b, h, c, aligned = shape
    x = _inputs(b, h, c, dtype, EMULATED.index(shape))
    geo = sum2x2_geometry(b, h, c, h, ESIZE[dtype], aligned)
    assert geo["vec"] == (aligned and c * (h // 2) % (8 // ESIZE[dtype])
                          == 0)
    out, writes = emulate(x, scale, aligned)
    assert bool((writes == 1).all())      # every element written once
    _same_bits(out, cuda_resize.sum2x2_plain(x, scale))


def _jnp(t):
    return jnp.asarray(t.float().numpy(),
                       jnp.bfloat16 if t.dtype == torch.bfloat16
                       else jnp.float32)


# (B, H, C): H = W of 32 and 64
JAX_SHAPES = [(2, 64, 16), (2, 32, 64)]


@pytest.mark.parametrize("shape", JAX_SHAPES)
def test_emulated_kernel_equals_pallas_bf16(shape):
    b, h, c = shape
    x = _inputs(b, h, c, torch.bfloat16, 55)
    out, _ = emulate(x, 0.25)
    with packctx.scope(True, interpret=True):
        ref = pallas_resize.avg_pool2x2_nhcw(_jnp(x))
    np.testing.assert_array_equal(out.float().numpy(),
                                  np.asarray(ref, np.float32))


@pytest.mark.parametrize("shape", JAX_SHAPES + [(2, 18, 3)])
def test_emulated_kernel_matches_xla_f32(shape):
    b, h, c = shape
    x = _inputs(b, h, c, torch.float32, 56)
    out, _ = emulate(x, 0.25)
    with jax_layout.nhcw():
        ref = jax_avg_pool2x2(_jnp(x))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **F32_TOL)
