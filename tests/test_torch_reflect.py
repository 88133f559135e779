"""The port's reflect-padded convolution and the ResNet recipe's other new
ops against the JAX package, on the CPU.

``cuda_reflect.ConvReflect`` runs, on CPU tensors, the plain versions of
its kernels: K9 forward, K1 at grow p on dY (the kernel writes dY's zero
pad itself; held here against the route with a padded copy) then K10 for
dX, K9-dW for dW.
They are held against ``pallas_conv.conv2d_reflect_nhcw`` in interpret mode
and its ``jax.vjp`` at W = 128 and a small H (the shapes of
``tests/test_pallas_conv.py``), in f32, with JAX's own tolerances there:
2e-5 for the output and dX, 2e-4 for dW. The stride-2 conv, the
transposed conv (k3, k4, k5 and k7) and the reflection pad are held against
the JAX ops (XLA, f32 HIGHEST) at 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cyclegan_tpu.ops import conv2d as jax_conv2d
from cyclegan_tpu.ops import conv2d_transpose as jax_conv2d_transpose
from cyclegan_tpu.ops import pallas_conv
from cyclegan_tpu.ops.pad import reflection_pad2d as jax_reflection_pad2d
from cyclegan_tpu_torch.ops import (
    conv2d,
    conv2d_transpose,
    cuda_reflect,
    layout,
    reflection_pad2d,
)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for these small CPU shapes: the suite runs in
    several worker processes at once, and torch's default of one thread
    per core in each of them oversubscribes the cores many times over."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True, scope="module")
def _nhcw_layout():
    """These tests feed the ops and networks NHCW activations, the layout
    of the port's kernels; the default layout scope is NHWC."""
    with layout.nhcw():
        yield


@pytest.fixture
def _interpret():
    pallas_conv.set_interpret(True)
    yield
    pallas_conv.set_interpret(False)


def _np(shape, seed, scale=1.0):
    return (scale * np.random.default_rng(seed).normal(size=shape)).astype(
        np.float32)


def _nhcw(a):
    """NHWC numpy -> NHCW numpy, and back (the same swap)."""
    return np.ascontiguousarray(np.swapaxes(a, 2, 3))


# (B, H, C, Cout, K, W): the ResNet stem (cin 3, k7), head (cout 3, k7) and
# a trunk-like k3, at W = 128 as the Pallas kernel needs
REFLECT_SHAPES = [
    (2, 8, 3, 8, 7, 128),
    (2, 8, 8, 3, 7, 128),
    (2, 8, 16, 16, 3, 128),
]


@pytest.mark.parametrize("b,h,cin,cout,k,w", REFLECT_SHAPES)
def test_reflect_conv_and_vjp_match_pallas(b, h, cin, cout, k, w,
                                           _interpret):
    x = _np((b, h, cin, w), 20)
    wt = _np((k, k, cin, cout), 21, 0.1)
    bias = _np((cout,), 23, 0.5)
    ct = _np((b, h, cout, w), 22)
    want, vjp = jax.vjp(pallas_conv.conv2d_reflect_nhcw, jnp.asarray(x),
                        jnp.asarray(wt))
    want_dx, want_dw = vjp(jnp.asarray(ct))

    xt = torch.from_numpy(x).requires_grad_(True)
    wtt = torch.from_numpy(wt).requires_grad_(True)
    bt = torch.from_numpy(bias).requires_grad_(True)
    y = cuda_reflect.conv_reflect(xt, wtt, bt)
    y.backward(torch.from_numpy(ct))
    np.testing.assert_allclose(y.detach().numpy() - bias[:, None],
                               np.asarray(want), rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want_dx),
                               rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(wtt.grad.numpy(), np.asarray(want_dw),
                               rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(bt.grad.numpy(), ct.sum(axis=(0, 1, 3)),
                               rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_conv_reflect_function_equals_plain_autograd(dtype):
    """The Function's explicit backward (K1 on the padded dY, then K10;
    K9-dW) against autograd of the plain forward: f32 to rounding, bf16 to
    one rounding step of the results (both sum in f32, round once)."""
    x = torch.from_numpy(_np((2, 6, 5, 7), 30)).to(dtype)
    w = torch.from_numpy(_np((5, 5, 5, 4), 31, 0.1)).to(dtype)
    b = torch.from_numpy(_np((4,), 32)).to(dtype)
    g = torch.from_numpy(_np((2, 6, 4, 7), 33)).to(dtype)
    leaves = [t.detach().clone().requires_grad_(True) for t in (x, w, b)]
    y = cuda_reflect.conv_reflect(*leaves)
    assert y.grad_fn is not None
    got = torch.autograd.grad(y, leaves, g)
    ref_leaves = [t.detach().float().requires_grad_(True) for t in (x, w, b)]
    ref = torch.autograd.grad(
        cuda_reflect.conv_reflect_plain(*ref_leaves), ref_leaves, g.float())
    tol = dict(rtol=1e-5, atol=1e-5) if dtype == torch.float32 else \
        dict(rtol=2e-2, atol=2e-2)
    for a, r in zip(got, ref):
        assert a.dtype == dtype
        np.testing.assert_allclose(a.float().numpy(), r.numpy(), **tol)


@pytest.mark.parametrize("k", [3, 7])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_padded_dx_without_the_pad_copy_is_the_same_function(k, dtype):
    """The reflect conv's dXp is K1 at pad p and grow p on dY itself (the
    kernel writes dY's zero pad); its plain version, which ``padded_dx``
    runs on the CPU, equals the route with a copy, K1 at pad p on dY
    zero-padded by p, bit for bit."""
    from cyclegan_tpu_torch.ops import cuda_conv

    p = k // 2
    g = torch.from_numpy(_np((2, 6, 4, 7), 50)).to(dtype)
    w_t = torch.from_numpy(_np((k, k, 4, 5), 51, 0.1)).to(dtype)
    today = cuda_conv.conv_same_plain(
        torch.nn.functional.pad(g, (p, p, 0, 0, p, p)), w_t, pad=p)
    pad_free = cuda_conv.conv_same_plain(g, w_t, pad=p, grow=p)
    assert pad_free.shape == (2, 6 + 2 * p, 5, 7 + 2 * p)
    assert torch.equal(pad_free, today)
    assert torch.equal(cuda_reflect.padded_dx(g, w_t, p), today)


@pytest.mark.parametrize("h,w,p", [(8, 8, 1), (8, 8, 3), (4, 5, 3), (6, 9, 0)])
def test_reflect_fold_is_the_adjoint_of_the_pad(h, w, p):
    """<pad(x), y> = <x, fold(y)>: the fold is the pad's transpose (up to
    its f32 sums)."""
    x = torch.from_numpy(_np((2, h, 3, w), 40)).double()
    y = torch.from_numpy(_np((2, h + 2 * p, 3, w + 2 * p), 41))
    padded = reflection_pad2d(x, (p, p))
    folded = cuda_reflect.reflect_fold_plain(y, p).double()
    assert folded.shape == x.shape
    scale = float((padded.abs() * y.double().abs()).sum())
    assert abs(float((padded * y.double()).sum() - (x * folded).sum())) \
        <= 1e-6 * scale


def test_reflection_pad_matches_jax():
    x = _np((2, 6, 7, 3), 50)  # NHWC
    want = np.asarray(jax_reflection_pad2d(jnp.asarray(x), (2, 3)))
    got = reflection_pad2d(torch.from_numpy(_nhcw(x)), (2, 3)).numpy()
    np.testing.assert_array_equal(_nhcw(got), want)


@pytest.mark.parametrize("k", [3, 4])
def test_stride2_conv_and_vjp_match_jax(k):
    x = _np((2, 8, 10, 5), 60)  # NHWC; TF SAME pads asymmetrically
    w = _np((k, k, 5, 6), 61, 0.2)
    b = _np((6,), 62)
    ct = _np((2, 4, 5, 6), 63)
    want, vjp = jax.vjp(lambda x, w, b: jax_conv2d(x, w, b, stride=2),
                        *map(jnp.asarray, (x, w, b)))
    want_grads = vjp(jnp.asarray(ct))
    leaves = [torch.from_numpy(a).requires_grad_(True)
              for a in (_nhcw(x), w, b)]
    y = conv2d(*leaves, stride=2)
    got_grads = torch.autograd.grad(y, leaves, torch.from_numpy(_nhcw(ct)))
    np.testing.assert_allclose(_nhcw(y.detach().numpy()), np.asarray(want),
                               rtol=1e-5, atol=1e-5)
    for got, ref, nhcw in zip(got_grads, want_grads, (True, False, False)):
        got = got.numpy()
        np.testing.assert_allclose(_nhcw(got) if nhcw else got,
                                   np.asarray(ref), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("k", [3, 4, 5, 7])
def test_conv_transpose_and_vjp_match_jax(k):
    x = _np((2, 5, 6, 4), 70)  # NHWC -> output 10x12
    w = _np((k, k, 3, 4), 71, 0.2)  # HWOI
    b = _np((3,), 72)
    ct = _np((2, 10, 12, 3), 73)
    want, vjp = jax.vjp(
        lambda x, w, b: jax_conv2d_transpose(x, w, b, stride=2),
        *map(jnp.asarray, (x, w, b)))
    want_grads = vjp(jnp.asarray(ct))
    leaves = [torch.from_numpy(a).requires_grad_(True)
              for a in (_nhcw(x), w, b)]
    y = conv2d_transpose(*leaves, stride=2)
    assert y.shape == (2, 10, 3, 12)
    got_grads = torch.autograd.grad(y, leaves, torch.from_numpy(_nhcw(ct)))
    np.testing.assert_allclose(_nhcw(y.detach().numpy()), np.asarray(want),
                               rtol=1e-5, atol=1e-5)
    for got, ref, nhcw in zip(got_grads, want_grads, (True, False, False)):
        got = got.numpy()
        np.testing.assert_allclose(_nhcw(got) if nhcw else got,
                                   np.asarray(ref), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("call", [
    lambda: cuda_reflect.conv_reflect_plain(torch.zeros(1, 8, 2, 8),
                                            torch.zeros(4, 4, 2, 2)),
    lambda: cuda_reflect.conv_reflect_plain(torch.zeros(1, 3, 2, 8),
                                            torch.zeros(7, 7, 2, 2)),
    lambda: cuda_reflect.conv_reflect_dw_plain(torch.zeros(1, 8, 2, 3),
                                               torch.zeros(1, 8, 2, 3), 7),
    lambda: cuda_reflect.reflect_fold_plain(torch.zeros(1, 8, 2, 8), 3),
])
def test_reflect_wrappers_refuse_what_they_do_not_take(call):
    """Even K, and a pad not smaller than the image (reflect needs p < H
    and p < W)."""
    with pytest.raises(ValueError):
        call()

