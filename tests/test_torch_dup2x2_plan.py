"""K7's launch (kernels/csrc/dup2x2.cu), emulated in torch ops on the
CPU, against the plain version and the JAX package.

No CPU runs the kernel, so this holds its geometry and index map: the rule
``cuda_resize.dup2x2_geometry`` at every K7 launch of chip_smoke.py's
train plans and at its edge shapes, in bf16 and f32 (every recipe launch
on the vector path, the grid covering each row's units once); then the
kernel's per-unit map, emulated: a unit's 8-byte load, each element
multiplied by the scale in f32 and rounded once, the words widened as
``__byte_perm`` widens them (bf16) and stored into both output rows, or
the element path's copies, scattered into an output that starts as NaN.
The emulation must write every element once and equal ``dup2x2_plain``
bit for bit, and the JAX package's pool gradient: the VJP of
``pallas_resize.avg_pool2x2_nhcw`` in interpret mode (bf16) and of the XLA
``avg_pool2x2`` (f32), as ``tests/test_torch_kernels_bwd.py`` runs them.
"""

import jax
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
from cyclegan_tpu_torch.ops.cuda_resize import DUP_THREADS, dup2x2_geometry

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
    """{(B, h, C)} of every K7 launch of chip_smoke.py's four train plans
    (batch 8, 256x256; w = h, the pooled side). Serving runs no K7."""
    cfgs = {"unet": chip_smoke.MODEL_DIR / "model_config.yaml",
            "resnet": chip_smoke.RESNET_CONFIG,
            "unet_transpose": chip_smoke.TRANSPOSE_CONFIG,
            "strided": chip_smoke.STRIDED_CONFIG}
    shapes = set()
    for name, path in cfgs.items():
        cfg = yaml2namespace(path)
        plan = (chip_smoke.resnet_train_launches if name == "resnet"
                else chip_smoke.train_launches)(cfg, 8, 256)
        shapes.update(plan.get("dup2x2", []))
    return sorted(shapes)


PLAN_SHAPES = _plan_shapes()


def _check_geometry(b, h, c, esize, aligned=True):
    w = h
    geo = dup2x2_geometry(b, h, c, w, esize, aligned)
    vx = geo["vx"]
    assert vx * esize == 8 if geo["vec"] else vx == 1
    assert geo["units"] * vx == c * w
    gx, gy = geo["grid"]
    assert (gx - 1) * DUP_THREADS < geo["units"] <= gx * DUP_THREADS
    assert geo["rows"] == b * h and gy == min(b * h, 65535)
    return geo


@pytest.mark.parametrize("esize", [2, 4])
def test_geometry_covers_every_plan_launch(esize):
    """Every K7 launch of the recipes' train steps (the default U-Net's,
    T's and S's pools) takes the vector path, in bf16 and f32, its grid
    covering each row's units."""
    assert PLAN_SHAPES == [(8, 32, 64), (8, 64, 32), (8, 128, 16)]
    for b, h, c in PLAN_SHAPES:
        assert _check_geometry(b, h, c, esize)["vec"], (b, h, c)


@pytest.mark.parametrize("esize", [2, 4])
def test_geometry_of_the_edge_shapes(esize):
    """chip_smoke.py's EDGE_DUP_SHAPES: an odd C w takes the element path;
    w = 9 at C = 8 keeps the vector path (the map needs whole rows, not
    whole channels); x one element off alignment takes the element path."""
    dtype = torch.bfloat16 if esize == 2 else torch.float32
    edges = chip_smoke.EDGE_DUP_SHAPES["dup2x2"]
    for shape, vec in zip(edges, [False, True, False]):
        b, h, c, off = shape
        assert _check_geometry(b, h, c, esize, not off)["vec"] == vec
        assert chip_smoke.expected_path("dup2x2", shape, dtype) == (
            "vector" if vec else "element")


def test_unaligned_pointers_take_the_element_path():
    assert dup2x2_geometry(8, 128, 16, 128, 2)["vec"]
    assert not dup2x2_geometry(8, 128, 16, 128, 2, False)["vec"]


def test_the_grid_loops_past_the_row_limit():
    """More than 65535 rows of x: grid y stops at the limit and each
    block walks rows by, by + 65535, ..."""
    geo = dup2x2_geometry(600, 128, 2, 4, 2)
    assert geo["rows"] == 76800 and geo["grid"] == (1, 65535)


# --- the emulated kernel ----------------------------------------------------

def _round_bf16_bits(v):
    """f32 values -> bf16 bits (int64, 0..0xFFFF), rounded to nearest even
    as ``__float2bfloat16_rn``."""
    return v.to(torch.bfloat16).view(torch.int16).long() & 0xFFFF


def _scale_words(words, esize, scale):
    """An 8-byte unit's 32-bit words (..., 2), each element times scale in
    f32 and rounded once: per bf16 word, the low half shifted up 16 bits
    and the high half masked are its two f32 values, as in
    ``scale_bf16x2``."""
    if esize == 4:
        return (words.view(torch.float32) * scale).view(torch.int32)
    u = words.long() & 0xFFFFFFFF
    lo = ((u & 0xFFFF) << 16).to(torch.int32).view(torch.float32)
    hi = (u & 0xFFFF0000).to(torch.int32).view(torch.float32)
    out = _round_bf16_bits(lo * scale) | (_round_bf16_bits(hi * scale) << 16)
    return torch.where(out >= 2 ** 31, out - 2 ** 32, out).to(torch.int32)


def _widen_words(words, esize):
    """An 8-byte unit's 32-bit words (..., 2) -> the 16-byte unit the
    kernel stores (..., 4): __byte_perm(w, 0, 0x1010) and (w, 0, 0x3232)
    of each word for bf16, (a, a, b, b) for f32."""
    if esize == 4:
        return words.repeat_interleave(2, dim=-1)
    u = words.long() & 0xFFFFFFFF
    lo, hi = u & 0xFFFF, u >> 16
    out = torch.stack([lo | (lo << 16), hi | (hi << 16)], dim=-1)
    out = out.reshape(*words.shape[:-1], 4)
    return torch.where(out >= 2 ** 31, out - 2 ** 32, out).to(torch.int32)


def emulate(x, scale, aligned=True):
    """K7's output as its units write it: (out, writes per element)."""
    b, h, c, w = x.shape
    esize = ESIZE[x.dtype]
    geo = dup2x2_geometry(b, h, c, w, esize, aligned)
    m, vx = c * w, geo["vx"]
    bits = WORD[x.dtype]
    out = torch.full((b * 2 * h * 2 * m,), float("nan"), dtype=x.dtype)
    out_bits = out.view(bits)
    writes = torch.zeros(out.numel(), dtype=torch.int64)
    gx, gy = geo["grid"]
    # thread u of block (bx, by): unit bx T + tx of the rows by, by + gy..
    u = torch.arange(gx * DUP_THREADS)
    u = u[u < geo["units"]]
    i = torch.cat([torch.arange(by, geo["rows"], gy) for by in range(gy)])
    e = u * vx
    base = (i * m)[:, None] + e[None, :]
    if vx == 1:
        v = (x.reshape(-1)[base].float() * scale).to(x.dtype)
        vals = v.view(bits)[..., None].expand(*base.shape, 2)
        span = 2
    else:
        words = x.reshape(-1).view(torch.int32)
        w0 = (base * esize // 4)[..., None] + torch.arange(2)
        vals = _widen_words(_scale_words(words[w0], esize, scale),
                            esize).view(bits)
        span = 2 * vx
    for r in (0, 1):
        dst = ((i * 4 * m)[:, None] + r * 2 * m + 2 * e[None, :])[..., None] \
            + torch.arange(span)
        out_bits[dst.reshape(-1)] = vals.reshape(-1)
        writes.index_add_(0, dst.reshape(-1),
                          torch.ones(dst.numel(), dtype=torch.int64))
    return out.view(b, 2 * h, c, 2 * w), writes


# (B, h, C, aligned): the vector path at 32x32 out; w = 9 at C = 8 on the
# vector path; an odd C w (the element path); the element path at an
# aligned shape, as x off alignment takes it
EMULATED = [(2, 16, 16, True), (2, 9, 8, True), (2, 17, 3, True),
            (2, 32, 8, False)]


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
    """At the pool's 1/4, at 1 (the JAX package's upsample) and at 0.3,
    whose products round."""
    b, h, c, aligned = shape
    x = _inputs(b, h, c, dtype, EMULATED.index(shape))
    geo = dup2x2_geometry(b, h, c, h, ESIZE[dtype], aligned)
    assert geo["vec"] == (aligned and c * h % 2 == 0)
    out, writes = emulate(x, scale, aligned)
    assert bool((writes == 1).all())      # every element written once
    _same_bits(out, cuda_resize.dup2x2_plain(x, scale))


def _jnp(t):
    return jnp.asarray(t.float().numpy(),
                       jnp.bfloat16 if t.dtype == torch.bfloat16
                       else jnp.float32)


# (B, H, C): the pool's input, H = W of 32 and 64; K7 runs on its
# gradient [B, H/2, C, W/2]
JAX_SHAPES = [(2, 64, 16), (2, 32, 64)]


@pytest.mark.parametrize("shape", JAX_SHAPES)
def test_emulated_kernel_equals_pallas_bf16(shape):
    b, hh, c = shape
    x = _inputs(b, hh, c, torch.bfloat16, 45)
    g = _inputs(b, hh // 2, c, torch.bfloat16, 46)
    out, _ = emulate(g, 0.25)
    with packctx.scope(True, interpret=True):
        _, vjp = jax.vjp(pallas_resize.avg_pool2x2_nhcw, _jnp(x))
        (ref,) = vjp(_jnp(g))
    np.testing.assert_array_equal(out.float().numpy(),
                                  np.asarray(ref, np.float32))


@pytest.mark.parametrize("shape", JAX_SHAPES + [(2, 34, 3)])
def test_emulated_kernel_equals_xla_f32(shape):
    b, hh, c = shape
    x = _inputs(b, hh, c, torch.float32, 47)
    g = _inputs(b, hh // 2, c, torch.float32, 48)
    out, _ = emulate(g, 0.25)
    with jax_layout.nhcw():
        _, vjp = jax.vjp(jax_avg_pool2x2, _jnp(x))
        (ref,) = vjp(_jnp(g))
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
