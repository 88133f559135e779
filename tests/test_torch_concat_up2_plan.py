"""K4's launch (kernels/csrc/concat_up2.cu), emulated in torch ops on the
CPU, against the plain version and the JAX package.

No CPU runs the kernel, so this holds its geometry and index map: the rule
``cuda_concat.concat_up2_geometry`` at every K4 launch of chip_smoke.py's
train and serving plans and at its edge shapes, in bf16 and f32 (every
recipe launch on the vector path, the grid covering each row pair's units
once); then the kernel's per-unit map, emulated: a skip unit's 16-byte copy
into its row, an x unit's 8-byte load widened word by word as ``__byte_perm``
widens it (bf16) and stored into both rows, or the element path's copies,
scattered into an output that starts as NaN. The emulation must write every
element once and equal ``concat_up2_plain`` bit for bit, and the JAX
package's junction: ``pallas_concat.concat_up2_nhcw`` in interpret mode
(bf16) and the XLA ``upsample_concat`` (f32), as
``tests/test_torch_kernels.py`` runs them.
"""

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
    """{(B, H, C1, C2)} of every K4 launch of chip_smoke.py's four train
    plans and serving plans (batch 8, 256x256; W = H)."""
    cfgs = {"unet": chip_smoke.MODEL_DIR / "model_config.yaml",
            "resnet": chip_smoke.RESNET_CONFIG,
            "unet_transpose": chip_smoke.TRANSPOSE_CONFIG,
            "strided": chip_smoke.STRIDED_CONFIG}
    shapes = set()
    for name, path in cfgs.items():
        cfg = yaml2namespace(path)
        if name == "resnet":
            plans = [chip_smoke.resnet_train_launches(cfg, 8, 256),
                     chip_smoke.resnet_generator_launches(cfg.generator, 8,
                                                          256)]
        else:
            plans = [chip_smoke.train_launches(cfg, 8, 256),
                     chip_smoke.serve_launches(cfg.generator, 8, 256)]
        for plan in plans:
            shapes.update(plan.get("concat_up2", []))
    return sorted(shapes)


PLAN_SHAPES = _plan_shapes()


def _check_geometry(b, h, c1, c2, esize, aligned=True):
    w = h
    geo = concat_up2_geometry(b, h, c1, c2, w, esize, aligned)
    vs, vx = geo["vs"], geo["vx"]
    if geo["vec"]:
        assert vs * esize == 16 and vx * esize == 8
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
    """Every K4 launch of the recipes' train steps and serving forwards
    (the default U-Net's and the strided U-Net's) takes the vector path,
    in bf16 and f32, its grid covering each row pair's units."""
    assert len(PLAN_SHAPES) == 4
    for b, h, c1, c2 in PLAN_SHAPES:
        assert _check_geometry(b, h, c1, c2, esize)["vec"], (b, h, c1, c2)


@pytest.mark.parametrize("esize", [2, 4])
def test_geometry_of_the_edge_shapes(esize):
    """chip_smoke.py's EDGE_JUNCTION_SHAPES: W/2 = 18 keeps the vector
    path (the map needs whole rows, not whole channels); odd C1 and C2 at
    W = 34, and inputs one element off alignment, take the element path."""
    dtype = torch.bfloat16 if esize == 2 else torch.float32
    edges = chip_smoke.EDGE_JUNCTION_SHAPES["concat_up2"]
    for shape, vec in zip(edges, [True, False, False]):
        b, h, c1, c2, off = shape
        assert _check_geometry(b, h, c1, c2, esize, not off)["vec"] == vec
        assert chip_smoke.expected_path("concat_up2", shape, dtype) == (
            "vector" if vec else "element")


def test_unaligned_pointers_take_the_element_path():
    assert concat_up2_geometry(8, 64, 64, 128, 64, 2)["vec"]
    assert not concat_up2_geometry(8, 64, 64, 128, 64, 2, False)["vec"]


# --- the emulated kernel ----------------------------------------------------

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


def emulate(skip, x, aligned=True):
    """K4's output as its units write it: (out, writes per element)."""
    b, h, c1, w = skip.shape
    c2 = x.shape[2]
    esize = ESIZE[skip.dtype]
    geo = concat_up2_geometry(b, h, c1, c2, w, esize, aligned)
    n1, m = c1 * w, c2 * (w // 2)
    row = n1 + 2 * m
    ms, mx, vs, vx = geo["skip_units"], geo["x_units"], geo["vs"], geo["vx"]
    bits = WORD[skip.dtype]
    out = torch.full((b * h * row,), float("nan"), dtype=skip.dtype)
    out_bits = out.view(bits)
    writes = torch.zeros(out.numel(), dtype=torch.int64)
    skip_bits = skip.reshape(-1).view(bits)
    x_bits = x.reshape(-1).view(bits)
    gx, gy = geo["grid"]
    # thread u of block (bx, by): unit bx T + tx of the pairs by, by + gy..
    u = torch.arange(gx * JUNCTION_THREADS)
    u = u[u < 2 * ms + mx]
    k = torch.cat([torch.arange(by, geo["pairs"], gy) for by in range(gy)])
    pair = (k * 2 * row)[:, None]
    # skip units: 16 bytes (or one element) from skip row pair k
    us = u[u < 2 * ms]
    r = (us >= ms).long()
    e = torch.arange(vs)
    dst = pair[..., None] + (r * row + (us - r * ms) * vs)[None, :, None] + e
    src = (k * 2 * n1)[:, None, None] + (us * vs)[None, :, None] + e
    out_bits[dst.reshape(-1)] = skip_bits[src.reshape(-1)]
    writes.index_add_(0, dst.reshape(-1), torch.ones(dst.numel(),
                                                     dtype=torch.int64))
    # x units: vx elements of x row k widened into both rows
    ex = (u[u >= 2 * ms] - 2 * ms) * vx
    base = (k * m)[:, None] + ex[None, :]
    if vx == 1:
        vals = x_bits[base][..., None].expand(*base.shape, 2)
        span = 2
    else:
        words = x.reshape(-1).view(torch.int32)
        w0 = (base * esize // 4)[..., None] + torch.arange(2)
        vals = _widen_words(words[w0], esize).view(bits)
        span = 2 * vx
    for rr in (0, 1):
        dst = (pair + rr * row + n1 + 2 * ex[None, :])[..., None] + \
            torch.arange(span)
        out_bits[dst.reshape(-1)] = vals.reshape(-1)
        writes.index_add_(0, dst.reshape(-1),
                          torch.ones(dst.numel(), dtype=torch.int64))
    return out.view(b, h, c1 + c2, w), writes


# (B, H, C1, C2, aligned): the vector path at 32x32; W/2 = 18 on the
# vector path; odd C1 and C2 at W = 34 (the element path); the element
# path at an aligned shape, as inputs off alignment take it
EMULATED = [(2, 32, 16, 32, True), (2, 36, 8, 16, True), (2, 34, 3, 5, True),
            (2, 64, 16, 32, False)]


def _inputs(b, h, c1, c2, dtype, seed):
    rng = np.random.default_rng(seed)
    skip = rng.normal(size=(b, h, c1, h)).astype(np.float32)
    x = rng.normal(size=(b, h // 2, c2, h // 2)).astype(np.float32)
    return torch.from_numpy(skip).to(dtype), torch.from_numpy(x).to(dtype)


def _same_bits(a, b):
    assert a.shape == b.shape and a.dtype == b.dtype
    assert torch.equal(a.view(WORD[a.dtype]), b.view(WORD[b.dtype]))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", EMULATED)
def test_emulated_kernel_equals_plain(shape, dtype):
    b, h, c1, c2, aligned = shape
    skip, x = _inputs(b, h, c1, c2, dtype, EMULATED.index(shape))
    geo = concat_up2_geometry(b, h, c1, c2, h, ESIZE[dtype], aligned)
    assert geo["vec"] == (aligned and c1 % 2 == 0)
    out, writes = emulate(skip, x, aligned)
    assert bool((writes == 1).all())      # every element written once
    _same_bits(out, cuda_concat.concat_up2_plain(skip, x))


def _jnp(t):
    return jnp.asarray(t.float().numpy(),
                       jnp.bfloat16 if t.dtype == torch.bfloat16
                       else jnp.float32)


# (B, H, C1, C2): the shapes of tests/test_torch_kernels.py's junction
# tests, 64x64 and 128x128 at W = 2w
JAX_SHAPES = [(2, 64, 16, 64), (2, 32, 64, 128)]


@pytest.mark.parametrize("shape", JAX_SHAPES)
def test_emulated_kernel_equals_pallas_bf16(shape):
    b, h, c1, c2 = shape
    skip, x = _inputs(b, h, c1, c2, torch.bfloat16, 41)
    out, _ = emulate(skip, x)
    with packctx.scope(True, interpret=True):
        ref = pallas_concat.concat_up2_nhcw(_jnp(skip), _jnp(x))
    np.testing.assert_array_equal(out.float().numpy(),
                                  np.asarray(ref, np.float32))


@pytest.mark.parametrize("shape", JAX_SHAPES + [(2, 34, 3, 5)])
def test_emulated_kernel_equals_xla_f32(shape):
    b, h, c1, c2 = shape
    skip, x = _inputs(b, h, c1, c2, torch.float32, 43)
    out, _ = emulate(skip, x)
    with jax_layout.nhcw():
        ref = jax_upsample_concat(_jnp(skip), _jnp(x))
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
