"""The port's kernel modules against the JAX package, on the CPU.

On a CPU tensor each wrapper of ``cyclegan_tpu_torch.ops.cuda_*`` runs the
plain PyTorch version of its kernel, which repeats the kernel's arithmetic.
Here each one is held against:

- its Pallas counterpart in interpret mode, in bf16 (the serving type), at
  the small shapes of ``tests/test_pallas_*.py`` (W = 128, H <= 8, B = 2).
  Both sum in f32 and round once to bf16, in other orders, so the two may
  differ by a bf16 rounding step: rtol 2e-2, and atol 1e-2 for values that
  are sums cancelling near zero (inputs are O(1));
- the JAX f32 XLA ops (``ops.conv2d``, ``instance_norm``, ``avg_pool2x2``,
  ``upsample_concat``) under the NHCW layout, in f32: atol 1e-5, room for
  f32 sums taken in another order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cyclegan_tpu.ops import conv2d as jax_conv2d
from cyclegan_tpu.ops import layout as jax_layout
from cyclegan_tpu.ops import packctx
from cyclegan_tpu.ops import pallas_concat, pallas_conv, pallas_norm_act
from cyclegan_tpu.ops import pallas_resize
from cyclegan_tpu.ops.norm import instance_norm as jax_instance_norm
from cyclegan_tpu.ops.pool import avg_pool2x2 as jax_avg_pool2x2
from cyclegan_tpu.ops.resize import upsample_concat as jax_upsample_concat
from cyclegan_tpu_torch.ops import cuda_concat, cuda_conv, cuda_norm_act
from cyclegan_tpu_torch.ops import cuda_resize

BF16_TOL = dict(rtol=2e-2, atol=1e-2)
F32_TOL = dict(rtol=0, atol=1e-5)


def _np(shape, seed, scale=1.0, offset=0.0):
    rng = np.random.default_rng(seed)
    return (offset + scale * rng.normal(size=shape)).astype(np.float32)


def _bf16_pair(a):
    """The same bf16 values as a JAX array and a torch tensor."""
    t = torch.from_numpy(a).to(torch.bfloat16)
    return jnp.asarray(t.float().numpy(), jnp.bfloat16), t


def _f32(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) else \
        np.asarray(t, np.float32)


def _act(y, act):
    if act == "relu":
        return jax.nn.relu(y)
    if act == "leaky_relu":
        return jax.nn.leaky_relu(y, negative_slope=0.2)
    return y


# --- K1: the KxK and 1x1 stride-1 SAME conv -------------------------------

CONV_CASES = [(k, cin, cout) for k in (3, 4, 5, 7)
              for cin, cout in ((3, 16), (80, 32))]


@pytest.mark.parametrize("k,cin,cout", CONV_CASES)
def test_conv_same_bf16_matches_pallas(k, cin, cout):
    x, tx = _bf16_pair(_np((2, 8, cin, 128), seed=1))
    w, tw = _bf16_pair(_np((k, k, cin, cout), seed=2, scale=0.05))
    with packctx.scope(True, interpret=True):
        ref = pallas_conv.conv2d_same_nhcw(x, w)
    got = cuda_conv.conv_same(tx, tw)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == ref.shape
    np.testing.assert_allclose(_f32(got), _f32(ref), **BF16_TOL)


def test_conv1x1_head_bf16_matches_pallas():
    """The head: 32 -> 3 with bias. JAX adds the bias in bf16 after the
    kernel; K1 adds it to the f32 sum."""
    x, tx = _bf16_pair(_np((2, 8, 32, 128), seed=3))
    w, tw = _bf16_pair(_np((1, 1, 32, 3), seed=4, scale=0.2))
    b, tb = _bf16_pair(_np((3,), seed=5, scale=0.5))
    with packctx.scope(True, interpret=True):
        ref = pallas_conv.conv1x1_nhcw(x, w) + b[:, None]
    got = cuda_conv.conv_same(tx, tw, tb)
    np.testing.assert_allclose(_f32(got), _f32(ref), **BF16_TOL)


@pytest.mark.parametrize("k,cin,cout,bias", [
    (k, cin, cout, False) for k, cin, cout in CONV_CASES
] + [(1, 32, 3, True)])
def test_conv_same_f32_matches_xla(k, cin, cout, bias):
    x = _np((2, 8, cin, 128), seed=6)
    w = _np((k, k, cin, cout), seed=7, scale=0.05)
    b = _np((cout,), seed=8) if bias else None
    with jax_layout.nhcw():
        ref = jax_conv2d(jnp.asarray(x), jnp.asarray(w),
                         None if b is None else jnp.asarray(b))
    got = cuda_conv.conv_same(torch.from_numpy(x), torch.from_numpy(w),
                              None if b is None else torch.from_numpy(b))
    np.testing.assert_allclose(_f32(got), _f32(ref), **F32_TOL)


def test_tf_same_pad_is_asymmetric_for_even_k():
    assert cuda_conv.tf_same_pad(4) == (1, 2)
    assert cuda_conv.tf_same_pad(1) == (0, 0)
    assert cuda_conv.tf_same_pad(7) == (3, 3)


# --- K2: instance norm + activation ---------------------------------------

def _norm_inputs(shape, seed):
    c = shape[2]
    # an offset mean makes the one-sweep variance's cancellation visible
    x = _np(shape, seed, scale=1.5, offset=0.5)
    gamma = _np((c,), seed + 1, scale=0.1, offset=1.0)
    beta = _np((c,), seed + 2, scale=0.1)
    return x, gamma, beta


@pytest.mark.parametrize("streamed", [False, True])
@pytest.mark.parametrize("act", ["relu", "leaky_relu", "none"])
def test_instance_norm_act_bf16_matches_pallas(act, streamed, monkeypatch):
    """Blocked kernel, and the streamed one by lowering its threshold as
    tests/test_pallas_norm_act.py does (12 rows, 3 chunks of 4)."""
    if streamed:
        shape = (2, 12, 16, 128)
        monkeypatch.setattr(pallas_norm_act, "_STREAM_SLAB_BYTES", 16 * 1024)
        monkeypatch.setattr(pallas_norm_act, "_STREAM_CHUNK_BYTES",
                            4 * 16 * 128 * 2)
    else:
        shape = (2, 8, 16, 128)
    xa, ga, ba = _norm_inputs(shape, seed=11)
    x, tx = _bf16_pair(xa)
    g, tg = _bf16_pair(ga)
    b, tb = _bf16_pair(ba)
    with packctx.scope(True, interpret=True):
        ref = pallas_norm_act.instance_norm_act(x, g, b, 1e-3, act)
    got = cuda_norm_act.instance_norm_act(tx, tg, tb, 1e-3, act)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(_f32(got), _f32(ref), **BF16_TOL)


@pytest.mark.parametrize("affine", [True, False])
@pytest.mark.parametrize("act", ["relu", "leaky_relu", "none"])
def test_instance_norm_act_f32_matches_xla(act, affine):
    x, gamma, beta = _norm_inputs((2, 8, 32, 64), seed=21)
    if not affine:
        gamma = beta = None
    with jax_layout.nhcw():
        ref = _act(jax_instance_norm(
            jnp.asarray(x), None if gamma is None else jnp.asarray(gamma),
            None if beta is None else jnp.asarray(beta), eps=1e-3), act)
    got = cuda_norm_act.instance_norm_act(
        torch.from_numpy(x), None if gamma is None else torch.from_numpy(gamma),
        None if beta is None else torch.from_numpy(beta), 1e-3, act)
    np.testing.assert_allclose(_f32(got), _f32(ref), **F32_TOL)


# --- K3: the 2x2 average pool ---------------------------------------------

@pytest.mark.parametrize("c,w", [(16, 256), (32, 128)])
def test_avg_pool_bf16_matches_pallas(c, w):
    x, tx = _bf16_pair(_np((2, 8, c, w), seed=31))
    with packctx.scope(True, interpret=True):
        ref = pallas_resize.avg_pool2x2_nhcw(x)
    got = cuda_resize.avg_pool2x2_nhcw(tx)
    assert tuple(got.shape) == ref.shape
    # the same f32 adds in the same order: equal, not just close
    np.testing.assert_array_equal(_f32(got), _f32(ref))


@pytest.mark.parametrize("c,w", [(16, 256), (64, 64)])
def test_avg_pool_f32_matches_xla(c, w):
    x = _np((2, 8, c, w), seed=32)
    with jax_layout.nhcw():
        ref = jax_avg_pool2x2(jnp.asarray(x))
    got = cuda_resize.avg_pool2x2_nhcw(torch.from_numpy(x))
    np.testing.assert_allclose(_f32(got), _f32(ref), **F32_TOL)


# --- K4: the upsample + concat junction -----------------------------------

@pytest.mark.parametrize("c1,c2,w", [(16, 64, 64), (64, 128, 64)])
def test_concat_up2_bf16_matches_pallas(c1, c2, w):
    skip, tskip = _bf16_pair(_np((2, 8, c1, 2 * w), seed=41))
    x, tx = _bf16_pair(_np((2, 4, c2, w), seed=42))
    with packctx.scope(True, interpret=True):
        ref = pallas_concat.concat_up2_nhcw(skip, x)
    got = cuda_concat.concat_up2_nhcw(tskip, tx)
    np.testing.assert_array_equal(_f32(got), _f32(ref))


@pytest.mark.parametrize("c1,c2,w", [(16, 64, 64), (32, 16, 16)])
def test_upsample_concat_f32_matches_xla(c1, c2, w):
    skip = _np((2, 8, c1, 2 * w), seed=43)
    x = _np((2, 4, c2, w), seed=44)
    with jax_layout.nhcw():
        ref = jax_upsample_concat(jnp.asarray(skip), jnp.asarray(x))
    got = cuda_concat.concat_up2_nhcw(torch.from_numpy(skip),
                                      torch.from_numpy(x))
    np.testing.assert_array_equal(_f32(got), _f32(ref))


# --- the wrappers' checks --------------------------------------------------

def test_wrappers_reject_bad_shapes():
    x = torch.zeros(1, 4, 8, 16)
    with pytest.raises(ValueError):
        cuda_conv.conv_same(x, torch.zeros(3, 3, 5, 16))
    with pytest.raises(ValueError):
        cuda_norm_act.instance_norm_act(x, torch.ones(5), None)
    with pytest.raises(ValueError):
        cuda_norm_act.instance_norm_act(x, None, None, act="gelu")
    with pytest.raises(ValueError):
        cuda_resize.avg_pool2x2_nhcw(torch.zeros(1, 3, 8, 16))
    with pytest.raises(ValueError):
        cuda_concat.concat_up2_nhcw(x, torch.zeros(1, 3, 8, 8))


def test_cuda_wrappers_refuse_cpu_tensors():
    """The kernel entry points never fall back: a CPU tensor is an error."""
    x = torch.zeros(1, 4, 16, 32)
    with pytest.raises(ValueError, match="expected CUDA"):
        cuda_conv.conv_same_cuda(x, torch.zeros(4, 4, 16, 16))
    with pytest.raises(ValueError, match="expected CUDA"):
        cuda_norm_act.instance_norm_act_cuda(x, None, None)
    with pytest.raises(ValueError, match="expected CUDA"):
        cuda_resize.sum2x2_cuda(x, 0.25)
    with pytest.raises(ValueError, match="expected CUDA"):
        cuda_concat.concat_up2_cuda(torch.zeros(1, 8, 16, 64), x)
