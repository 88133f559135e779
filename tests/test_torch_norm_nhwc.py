"""K13, the NHWC instance norm, on the CPU: its plain version and autograd
Function against the Pallas kernel it replaces
(``cyclegan_tpu/ops/pallas_norm.py``, interpret mode, under ``jax.jit``) and
its VJP; the NHWC ``instance_norm`` without ``pallas_norm`` against the JAX
``instance_norm`` (XLA).

Tolerances. f32 forward: 2e-5 absolute, room for the f32 sums of up to 256
terms taken in another order (outputs are O(3)). f32 backward: 1e-4
absolute + 1e-3 relative, for the mean-of-products terms of the VJP. bf16:
0.05 absolute, the JAX package's own bound for its bf16 norm tests (one
bf16 step of an O(4) output is 0.016; the statistics are f32 in both).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cyclegan_tpu.ops import pallas_norm
from cyclegan_tpu.ops.norm import instance_norm as jax_instance_norm
from cyclegan_tpu_torch.ops import cuda_norm, instance_norm, layout

SHAPES = [(2, 8, 8, 16), (1, 16, 16, 4), (3, 4, 4, 3), (2, 8, 8, 128)]


def _inputs(shape, affine, seed=0):
    rng = np.random.default_rng(seed)
    x = (0.5 + 1.5 * rng.normal(size=shape)).astype(np.float32)
    c = shape[-1]
    gamma = (1.0 + 0.1 * rng.normal(size=c)).astype(np.float32) if affine \
        else None
    beta = (0.1 * rng.normal(size=c)).astype(np.float32) if affine else None
    dy = rng.normal(size=shape).astype(np.float32)
    return x, gamma, beta, dy


def _t(a, dtype=torch.float32):
    return None if a is None else torch.from_numpy(a).to(dtype)


def _j(a, dtype=jnp.float32):
    return None if a is None else jnp.asarray(a, dtype)


@jax.jit
def _pallas_forward(x, gamma, beta):
    n, h, w, c = x.shape
    y, mean, rstd = pallas_norm._forward(x.reshape(n, h * w, c), gamma,
                                         beta, 1e-3, True)
    return y.reshape(x.shape), mean, rstd


@jax.jit
def _pallas_vjp(x, gamma, beta, dy):
    if gamma is None:
        _, vjp = jax.vjp(lambda x: pallas_norm.pallas_instance_norm(
            x, None, None, interpret=True), x)
        return vjp(dy) + (None, None)
    _, vjp = jax.vjp(lambda x, g, b: pallas_norm.pallas_instance_norm(
        x, g, b, interpret=True), x, gamma, beta)
    return vjp(dy)


@pytest.mark.parametrize("affine", [True, False])
@pytest.mark.parametrize("shape", SHAPES)
def test_plain_forward_matches_pallas(shape, affine):
    x, gamma, beta, _ = _inputs(shape, affine)
    want = _pallas_forward(_j(x), _j(gamma), _j(beta))
    got = cuda_norm.instance_norm_nhwc_plain(_t(x), _t(gamma), _t(beta))
    for g, w in zip(got, want):
        assert tuple(g.shape) == tuple(w.shape)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=2e-5)


@pytest.mark.parametrize("affine", [True, False])
@pytest.mark.parametrize("shape", SHAPES)
def test_function_gradients_match_pallas_vjp(shape, affine):
    x, gamma, beta, dy = _inputs(shape, affine, seed=1)
    want = _pallas_vjp(_j(x), _j(gamma), _j(beta), _j(dy))
    leaves = [t.requires_grad_(True) for t in (_t(x), _t(gamma), _t(beta))
              if t is not None]
    y = cuda_norm.instance_norm_nhwc(*leaves) if affine else \
        cuda_norm.instance_norm_nhwc(leaves[0])
    assert y.grad_fn is not None and "InstanceNormNHWC" in \
        type(y.grad_fn).__name__
    got = torch.autograd.grad(y, leaves, _t(dy))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-3,
                                   atol=1e-4)


@pytest.mark.parametrize("shape", SHAPES)
def test_bf16_matches_pallas(shape):
    x, gamma, beta, _ = _inputs(shape, True, seed=2)
    want = _pallas_forward(_j(x, jnp.bfloat16), _j(gamma, jnp.bfloat16),
                           _j(beta, jnp.bfloat16))
    got = cuda_norm.instance_norm_nhwc_plain(
        _t(x, torch.bfloat16), _t(gamma, torch.bfloat16),
        _t(beta, torch.bfloat16))
    assert got[0].dtype == torch.bfloat16 and got[1].dtype == torch.float32
    np.testing.assert_allclose(got[0].float().numpy(),
                               np.asarray(want[0], np.float32), rtol=0,
                               atol=0.05)
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("affine", [True, False])
def test_nhwc_instance_norm_without_pallas_matches_jax(affine, dtype):
    """The XLA path's counterpart: two-pass variance in f32, one sweep in
    bf16, f32 statistics; forward and, in f32, gradients."""
    tdt, jdt = ((torch.float32, jnp.float32) if dtype == "float32"
                else (torch.bfloat16, jnp.bfloat16))
    x, gamma, beta, dy = _inputs((2, 8, 8, 16), affine, seed=3)
    want, vjp = jax.vjp(lambda *a: jax_instance_norm(*a),
                        *[_j(a, jdt) for a in (x, gamma, beta)
                          if a is not None])
    leaves = [t.requires_grad_(True) for t in
              (_t(x, tdt), _t(gamma, tdt), _t(beta, tdt)) if t is not None]
    assert not layout.is_nhcw() and not cuda_norm.is_enabled()
    y = instance_norm(*leaves)
    atol = 1e-5 if dtype == "float32" else 0.05
    np.testing.assert_allclose(y.detach().float().numpy(),
                               np.asarray(want, np.float32), rtol=0,
                               atol=atol)
    if dtype == "float32":
        got = torch.autograd.grad(y, leaves, _t(dy))
        for g, w in zip(got, vjp(_j(dy))):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4,
                                       atol=1e-5)


def test_pallas_scope_routes_the_norm_and_restores(monkeypatch):
    calls = []
    plain = cuda_norm.instance_norm_nhwc_plain

    def counting(*args, **kwargs):
        calls.append(args[0].shape)
        return plain(*args, **kwargs)

    monkeypatch.setattr(cuda_norm, "instance_norm_nhwc_plain", counting)
    x = torch.randn(1, 4, 4, 8)
    instance_norm(x)
    assert not calls
    with pytest.raises(RuntimeError):
        with cuda_norm.scope(True):
            y = instance_norm(x, act="relu")
            assert calls and bool((y >= 0).all())
            raise RuntimeError
    assert not cuda_norm.is_enabled()
    with layout.nhcw(), cuda_norm.scope(True):
        instance_norm(torch.randn(1, 4, 8, 4))  # NHCW: K2's plain version
    assert len(calls) == 1


def test_dispatch_is_by_device():
    x = torch.empty((1, 4, 4, 8), device="meta")
    with pytest.raises(ValueError, match="no kernel for device meta"):
        cuda_norm._instance_norm_nhwc(x, None, None, 1e-3)
    with pytest.raises(ValueError, match="together"):
        cuda_norm.instance_norm_nhwc_plain(torch.zeros(1, 2, 2, 3),
                                           torch.ones(3), None)


@pytest.mark.parametrize("shape,dtype,want", [
    ((8, 256, 256, 16), torch.bfloat16, ("resident", 8, 2, 16, 0)),
    ((8, 32, 32, 128), torch.bfloat16, ("resident", 8, 4, 2, 0)),
    ((8, 64, 64, 128), torch.bfloat16, ("resident", 8, 4, 8, 0)),
    ((8, 512, 512, 16), torch.bfloat16, ("streamed", 8, 2, 1, 66)),
    ((8, 64, 64, 256), torch.float32, ("resident", 4, 4, 8, 0)),
    ((2, 8, 8, 3), torch.float32, ("element", 1, 3, 1, 1)),
])
def test_launch_plan(shape, dtype, want):
    """(path, channels a slot, tile in slots, cluster, row splits):
    16-byte slots where C allows; resident (one launch) on the widest tile
    of at most 4 vectors whose cluster, grown until a CTA holds ~32 KiB of
    x, leaves each CTA's copy within 160 KiB; else streamed on the
    two-launch design, whose row splits fill ~528 blocks with at least 4
    rows per lane; one element a slot where C is no whole vector."""
    n, h, w, c = shape
    esize = torch.empty((), dtype=dtype).element_size()
    geo = cuda_norm.instance_norm_nhwc_geometry(n, h * w, c, esize)
    assert (geo["path"], geo["vec"], geo["tile"], geo["cluster"],
            geo["splits"]) == want
    # an unaligned pointer takes one element per slot
    assert cuda_norm.instance_norm_nhwc_geometry(
        n, h * w, c, esize, aligned=False)["path"] == "element"
