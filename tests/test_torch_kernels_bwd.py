"""The port's backward kernels against the JAX package, on the CPU.

Each op's autograd Function (``cyclegan_tpu_torch.ops.cuda_*``) runs, on CPU
tensors, the plain PyTorch versions of its kernels: K1 and K5 for the conv,
K6 for instance norm + activation, K7 for the pool, K8 for the junction.
Their gradients are held against:

- ``jax.vjp`` of the Pallas op in interpret mode, in bf16, at the small
  shapes of ``tests/test_pallas_*.py`` (the conv at one sample of four
  rows, as interpret mode is slow). Tolerances are the forward's bf16
  ones (rtol 2e-2 for one bf16 rounding step in results summed in another
  order, atol 1e-2 for sums cancelling near zero), with the absolute part
  scaled by the size of the sum where the gradient is one: for dW by
  S = sum |x| |g| over the same terms, for dgamma and dbeta by the sum of
  |g| (1 + |x̂|) over the planes and the batch;
- ``jax.vjp`` of the JAX XLA ops under the NHCW layout, in f32: atol 1e-5
  times the same scale, room for f32 sums taken in another order;
- autograd of the plain forward versions, in f32: the Functions' explicit
  backward equals what PyTorch derives.
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

BF16 = dict(rtol=2e-2, atol=1e-2)
F32_ATOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for these small CPU shapes: the suite runs in
    several worker processes at once, and torch's default of one thread
    per core in each of them oversubscribes the cores many times over."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


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


def _close(got, want, rtol, atol, scale=1.0):
    """|got - want| <= rtol |want| + atol * scale, elementwise."""
    got, want = _f32(got), _f32(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = np.abs(got - want)
    limit = rtol * np.abs(want) + atol * np.asarray(scale, np.float32)
    assert (err <= limit).all(), (
        f"max excess {float((err - limit).max())}, max err "
        f"{float(err.max())}")


def _grads(fn, inputs, cotangent):
    """Gradients of fn(*inputs) against ``cotangent`` by autograd."""
    leaves = [t.detach().clone().requires_grad_(True) for t in inputs]
    out = fn(*leaves)
    return out, torch.autograd.grad(out, leaves, cotangent)


def _dw_scale(x, g, k):
    """S[dy,dx,c,co] = sum |x_pad| |g| over the dW sum's terms."""
    return cuda_conv.conv_dw_plain(torch.from_numpy(np.abs(_f32(x))),
                                   torch.from_numpy(np.abs(_f32(g))), k,
                                   cuda_conv.tf_same_pad(k)[0]).numpy()


# --- conv: dX by K1 at the transposed pad, dW by K5 -----------------------

CONV_CASES = [(k, cin, cout) for k in (3, 4, 5, 7)
              for cin, cout in ((3, 16), (80, 32))]


@pytest.mark.parametrize("k,cin,cout", CONV_CASES)
def test_conv_bwd_bf16_matches_pallas(k, cin, cout):
    x, tx = _bf16_pair(_np((1, 4, cin, 128), seed=1))
    w, tw = _bf16_pair(_np((k, k, cin, cout), seed=2, scale=0.05))
    g, tg = _bf16_pair(_np((1, 4, cout, 128), seed=3))
    with packctx.scope(True, interpret=True):
        _, vjp = jax.vjp(pallas_conv.conv2d_same_nhcw, x, w)
        ref_dx, ref_dw = vjp(g)
    _, (dx, dw) = _grads(cuda_conv.conv_same, [tx, tw], tg)
    assert dx.dtype == dw.dtype == torch.bfloat16
    _close(dx, ref_dx, **BF16)
    _close(dw, ref_dw, BF16["rtol"], BF16["atol"], _dw_scale(tx, tg, k))


def test_conv1x1_head_bwd_bf16_matches_pallas():
    """The head, 32 -> 3 with bias; JAX adds the bias outside the kernel,
    so its gradient is the sum of g over (B, H, W)."""
    x, tx = _bf16_pair(_np((2, 8, 32, 128), seed=4))
    w, tw = _bf16_pair(_np((1, 1, 32, 3), seed=5, scale=0.2))
    b, tb = _bf16_pair(_np((3,), seed=6, scale=0.5))
    g, tg = _bf16_pair(_np((2, 8, 3, 128), seed=7))
    with packctx.scope(True, interpret=True):
        _, vjp = jax.vjp(
            lambda x, w, b: pallas_conv.conv1x1_nhcw(x, w) + b[:, None],
            x, w, b)
        ref_dx, ref_dw, ref_db = vjp(g)
    _, (dx, dw, db) = _grads(cuda_conv.conv_same, [tx, tw, tb], tg)
    _close(dx, ref_dx, **BF16)
    _close(dw, ref_dw, BF16["rtol"], BF16["atol"], _dw_scale(tx, tg, 1))
    _close(db, ref_db, BF16["rtol"], BF16["atol"],
           np.abs(_f32(tg)).sum(axis=(0, 1, 3)))


@pytest.mark.parametrize("k,cin,cout,bias", [
    (k, cin, cout, False) for k, cin, cout in CONV_CASES
] + [(1, 32, 3, True), (1, 16, 1, True)])
def test_conv_bwd_f32_matches_xla(k, cin, cout, bias):
    x = _np((2, 8, cin, 64), seed=8)
    w = _np((k, k, cin, cout), seed=9, scale=0.05)
    b = _np((cout,), seed=10) if bias else None
    g = _np((2, 8, cout, 64), seed=11)
    args = [x, w] + ([b] if bias else [])
    with jax_layout.nhcw():
        _, vjp = jax.vjp(lambda *a: jax_conv2d(*a), *map(jnp.asarray, args))
        ref = vjp(jnp.asarray(g))
    _, got = _grads(cuda_conv.conv_same, [torch.from_numpy(a) for a in args],
                    torch.from_numpy(g))
    scale_dx = np.abs(g).sum() / g.size * np.abs(w).sum(axis=(0, 1, 3))
    _close(got[0], ref[0], 0, F32_ATOL, scale_dx[None, None, :, None])
    _close(got[1], ref[1], 0, F32_ATOL, _dw_scale(x, g, k))
    if bias:
        _close(got[2], ref[2], 0, F32_ATOL, np.abs(g).sum(axis=(0, 1, 3)))


def test_conv_dx_pad_is_transposed_for_even_k():
    """dX of a k4 SAME conv pads 2 before (K-1-1), not the forward's 1."""
    assert cuda_conv.tf_same_pad(4)[0] == 1
    x = torch.randn(1, 6, 2, 7, dtype=torch.float64).float()
    w = torch.randn(4, 4, 2, 3)
    g = torch.randn(1, 6, 3, 7)
    _, (dx, _) = _grads(cuda_conv.conv_same, [x, w], g)
    w_t = w.flip(0, 1).transpose(2, 3)
    np.testing.assert_allclose(
        dx.numpy(), cuda_conv.conv_same_plain(g, w_t, pad=2).numpy(),
        atol=1e-6)
    assert not np.allclose(
        dx.numpy(), cuda_conv.conv_same_plain(g, w_t, pad=1).numpy(),
        atol=1e-3)


# --- instance norm + activation: K2 keeps mu/rstd, K6 ---------------------

def _norm_inputs(shape, seed):
    c = shape[2]
    x = _np(shape, seed, scale=1.5, offset=0.5)
    gamma = _np((c,), seed + 1, scale=0.1, offset=1.0)
    beta = _np((c,), seed + 2, scale=0.1)
    g = _np(shape, seed + 3)
    return x, gamma, beta, g


def _norm_param_scale(x, g):
    """sum |g| (1 + |xhat|) over (B, H, W): the size of the sums that
    dgamma and dbeta are."""
    xhat = (x - x.mean(axis=(1, 3), keepdims=True)) / (
        x.std(axis=(1, 3), keepdims=True) + 1e-6)
    return (np.abs(g) * (1.0 + np.abs(xhat))).sum(axis=(0, 1, 3))


@pytest.mark.parametrize("streamed", [False, True])
@pytest.mark.parametrize("act", ["relu", "none"])
def test_norm_bwd_bf16_matches_pallas(act, streamed, monkeypatch):
    """Blocked kernel, and the streamed one by lowering its threshold as
    tests/test_pallas_norm_act.py does (12 rows, 3 chunks of 4)."""
    if streamed:
        shape = (2, 12, 16, 128)
        monkeypatch.setattr(pallas_norm_act, "_STREAM_SLAB_BYTES", 16 * 1024)
        monkeypatch.setattr(pallas_norm_act, "_STREAM_CHUNK_BYTES",
                            4 * 16 * 128 * 2)
    else:
        shape = (2, 8, 16, 128)
    xa, ga, ba, gza = _norm_inputs(shape, seed=11)
    (x, tx), (g, tg), (b, tb), (gz, tgz) = map(_bf16_pair, (xa, ga, ba, gza))
    with packctx.scope(True, interpret=True):
        _, vjp = jax.vjp(lambda x, g, b: pallas_norm_act.instance_norm_act(
            x, g, b, 1e-3, act), x, g, b)
        ref = vjp(gz)
    _, got = _grads(lambda x, g, b: cuda_norm_act.instance_norm_act(
        x, g, b, 1e-3, act), [tx, tg, tb], tgz)
    assert all(t.dtype == torch.bfloat16 for t in got)
    _close(got[0], ref[0], **BF16)
    scale = _norm_param_scale(xa, gza)
    _close(got[1], ref[1], BF16["rtol"], BF16["atol"], scale)
    _close(got[2], ref[2], BF16["rtol"], BF16["atol"], scale)


@pytest.mark.parametrize("affine", [True, False])
@pytest.mark.parametrize("act", ["relu", "none"])
def test_norm_bwd_f32_matches_xla(act, affine):
    x, gamma, beta, g = _norm_inputs((2, 8, 32, 64), seed=21)
    args = [x, gamma, beta] if affine else [x]

    def jax_fn(x, gamma=None, beta=None):
        y = jax_instance_norm(x, gamma, beta, eps=1e-3)
        return jax.nn.relu(y) if act == "relu" else y

    def port_fn(x, gamma=None, beta=None):
        return cuda_norm_act.instance_norm_act(x, gamma, beta, 1e-3, act)

    with jax_layout.nhcw():
        _, vjp = jax.vjp(jax_fn, *map(jnp.asarray, args))
        ref = vjp(jnp.asarray(g))
    _, got = _grads(port_fn, [torch.from_numpy(a) for a in args],
                    torch.from_numpy(g))
    # dx = gamma rstd (dv - mean dv - xhat mean(dv xhat)): scale |g| rstd
    rstd = 1.0 / np.sqrt(x.var(axis=(1, 3), keepdims=True) + 1e-3)
    _close(got[0], ref[0], 0, F32_ATOL, 3 * np.abs(g).max() * rstd)
    if affine:
        scale = _norm_param_scale(x, g)
        _close(got[1], ref[1], 0, F32_ATOL, scale)
        _close(got[2], ref[2], 0, F32_ATOL, scale)


def test_norm_relu_gradient_is_zero_at_zero():
    """act'(0) = 0 for relu, as the Pallas ``_act_grad`` (v > 0), where
    autograd of a clamp would pass the gradient at v = 0."""
    x = torch.tensor([-1.0, 1.0, -1.0, 1.0]).reshape(1, 2, 1, 2)
    beta = torch.tensor([1.0])        # v = xhat + 1: exactly 0 at x = -1
    gamma = torch.tensor([1.0])
    _, mu, rstd = cuda_norm_act.instance_norm_act_plain(
        x, gamma, beta, 0.0, "relu", with_stats=True)
    dx, t1, _ = cuda_norm_act.instance_norm_act_bwd_plain(
        x, torch.ones_like(x), gamma, beta, mu, rstd, "relu")
    assert float(t1) == 2.0           # only the two v = 2 elements count


def test_norm_forward_stats_are_the_backward_residuals():
    x, gamma, beta, _ = _norm_inputs((2, 8, 16, 32), seed=31)
    tx = torch.from_numpy(x)
    out, mu, rstd = cuda_norm_act.instance_norm_act_plain(
        tx, torch.from_numpy(gamma), torch.from_numpy(beta), 1e-3, "relu",
        with_stats=True)
    assert mu.shape == rstd.shape == (2, 16) and mu.dtype == torch.float32
    np.testing.assert_allclose(mu.numpy(), x.mean(axis=(1, 3)), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(
        rstd.numpy(), 1 / np.sqrt(x.var(axis=(1, 3)) + 1e-3), rtol=1e-5)
    torch.testing.assert_close(out, cuda_norm_act.instance_norm_act_plain(
        tx, torch.from_numpy(gamma), torch.from_numpy(beta), 1e-3, "relu"))


# --- pool (K7 backward) and junction (K8 backward) ------------------------

@pytest.mark.parametrize("c,w", [(16, 256), (32, 128)])
def test_pool_bwd_bf16_matches_pallas(c, w):
    x, tx = _bf16_pair(_np((2, 8, c, w), seed=41))
    g, tg = _bf16_pair(_np((2, 4, c, w // 2), seed=42))
    with packctx.scope(True, interpret=True):
        _, vjp = jax.vjp(pallas_resize.avg_pool2x2_nhcw, x)
        (ref,) = vjp(g)
    _, (got,) = _grads(cuda_resize.avg_pool2x2_nhcw, [tx], tg)
    # g / 4 is exact in bf16: equal, not just close
    np.testing.assert_array_equal(_f32(got), _f32(ref))


@pytest.mark.parametrize("c,w", [(16, 64), (64, 32)])
def test_pool_bwd_f32_matches_xla(c, w):
    x = _np((2, 8, c, w), seed=43)
    g = _np((2, 4, c, w // 2), seed=44)
    with jax_layout.nhcw():
        _, vjp = jax.vjp(jax_avg_pool2x2, jnp.asarray(x))
        (ref,) = vjp(jnp.asarray(g))
    _, (got,) = _grads(cuda_resize.avg_pool2x2_nhcw, [torch.from_numpy(x)],
                       torch.from_numpy(g))
    _close(got, ref, 0, F32_ATOL)


@pytest.mark.parametrize("c1,c2,w", [(16, 64, 64), (64, 128, 64)])
def test_junction_bwd_bf16_matches_pallas(c1, c2, w):
    skip, tskip = _bf16_pair(_np((2, 8, c1, 2 * w), seed=51))
    x, tx = _bf16_pair(_np((2, 4, c2, w), seed=52))
    g, tg = _bf16_pair(_np((2, 8, c1 + c2, 2 * w), seed=53))
    with packctx.scope(True, interpret=True):
        _, vjp = jax.vjp(pallas_concat.concat_up2_nhcw, skip, x)
        ref_dskip, ref_dx = vjp(g)
    _, (dskip, dx) = _grads(cuda_concat.concat_up2_nhcw, [tskip, tx], tg)
    np.testing.assert_array_equal(_f32(dskip), _f32(ref_dskip))
    # the 2x2 sums: f32 adds of bf16 values, rounded once in both
    _close(dx, ref_dx, **BF16)


@pytest.mark.parametrize("c1,c2,w", [(16, 64, 32), (32, 16, 16)])
def test_junction_bwd_f32_matches_xla(c1, c2, w):
    skip = _np((2, 8, c1, 2 * w), seed=54)
    x = _np((2, 4, c2, w), seed=55)
    g = _np((2, 8, c1 + c2, 2 * w), seed=56)
    with jax_layout.nhcw():
        _, vjp = jax.vjp(jax_upsample_concat, jnp.asarray(skip),
                         jnp.asarray(x))
        ref = vjp(jnp.asarray(g))
    _, got = _grads(cuda_concat.concat_up2_nhcw,
                    [torch.from_numpy(skip), torch.from_numpy(x)],
                    torch.from_numpy(g))
    np.testing.assert_array_equal(_f32(got[0]), _f32(ref[0]))
    _close(got[1], ref[1], 0, F32_ATOL, 4 * np.abs(g).max())


# --- the Functions against autograd of the plain forwards -----------------

def _plain_cases():
    x = torch.from_numpy(_np((2, 8, 5, 12), seed=61))
    cases = []
    for k in (1, 3, 4, 5, 7):
        w = torch.from_numpy(_np((k, k, 5, 6), seed=62 + k, scale=0.1))
        b = torch.from_numpy(_np((6,), seed=70 + k))
        cases.append((f"conv_k{k}", cuda_conv.conv_same,
                      cuda_conv.conv_same_plain, [x, w, b]))
    xn = torch.from_numpy(_np((2, 8, 5, 12), seed=80, scale=1.5, offset=0.5))
    gamma = torch.from_numpy(_np((5,), seed=81, scale=0.1, offset=1.0))
    beta = torch.from_numpy(_np((5,), seed=82, scale=0.1))
    for act in ("relu", "leaky_relu", "none"):
        cases.append((
            f"norm_{act}",
            lambda x, g, b, act=act: cuda_norm_act.instance_norm_act(
                x, g, b, 1e-3, act),
            lambda x, g, b, act=act: cuda_norm_act.instance_norm_act_plain(
                x, g, b, 1e-3, act),
            [xn, gamma, beta]))
    cases.append(("pool", cuda_resize.avg_pool2x2_nhcw,
                  lambda x: cuda_resize.sum2x2_plain(x, 0.25), [x]))
    cases.append(("junction", cuda_concat.concat_up2_nhcw,
                  cuda_concat.concat_up2_plain,
                  [torch.from_numpy(_np((2, 8, 3, 12), seed=83)),
                   torch.from_numpy(_np((2, 4, 5, 6), seed=84))]))
    return cases


@pytest.mark.parametrize("name,fn,plain,inputs", _plain_cases(),
                         ids=[c[0] for c in _plain_cases()])
def test_function_gradients_equal_plain_autograd(name, fn, plain, inputs):
    ref_out = plain(*inputs)
    cot = torch.from_numpy(_np(tuple(ref_out.shape), seed=90))
    out, got = _grads(fn, inputs, cot)
    _, want = _grads(plain, inputs, cot)
    assert out.grad_fn is not None
    torch.testing.assert_close(out, ref_out)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)


# --- the wrappers' checks --------------------------------------------------

def test_bwd_wrappers_reject_bad_shapes():
    x = torch.zeros(1, 4, 8, 16)
    with pytest.raises(ValueError):
        cuda_conv.conv_dw(x, torch.zeros(1, 4, 8, 8), 3, 1)
    with pytest.raises(ValueError):
        cuda_conv.conv_dw(x, torch.zeros(1, 4, 8, 16), 3, 3)
    with pytest.raises(ValueError):
        cuda_conv.conv_same_plain(x, torch.zeros(3, 3, 8, 16), pad=5)
    stats = torch.zeros(1, 8)
    with pytest.raises(ValueError):
        cuda_norm_act.instance_norm_act_bwd(x, torch.zeros(1, 4, 8, 8), None,
                                            None, stats, stats)
    with pytest.raises(ValueError):
        cuda_norm_act.instance_norm_act_bwd(x, x, None, None,
                                            torch.zeros(1, 4), stats)
    with pytest.raises(ValueError):
        cuda_concat.split_pool2(x, 8)
    with pytest.raises(ValueError):
        cuda_concat.split_pool2(torch.zeros(1, 3, 8, 16), 4)


def test_bwd_cuda_wrappers_refuse_cpu_tensors():
    """The kernel entry points never fall back: a CPU tensor is an error."""
    x = torch.zeros(1, 4, 16, 32)
    stats = torch.zeros(1, 16)
    with pytest.raises(ValueError, match="expected CUDA"):
        cuda_conv.conv_dw_cuda(x, x, 3, 1)
    with pytest.raises(ValueError, match="expected CUDA"):
        cuda_norm_act.instance_norm_act_bwd_cuda(x, x, None, None, stats,
                                                 stats)
    with pytest.raises(ValueError, match="expected CUDA"):
        cuda_resize.dup2x2_cuda(x, 0.25)
    with pytest.raises(ValueError, match="expected CUDA"):
        cuda_concat.split_pool2_cuda(x, 8)


def test_dw_splits_fill_the_card_and_never_exceed_the_rows():
    assert cuda_conv.dw_splits(4, 128, 128, 256) == 9
    assert cuda_conv.dw_splits(7, 3, 16, 2048) == 352
    assert cuda_conv.dw_splits(1, 32, 3, 4) == 4
