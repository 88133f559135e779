"""The port's channel concat (K11) and its split (K12) against the JAX
package, on the CPU.

On CPU tensors ``cuda_concat.Concat2`` runs the kernels' plain versions:
``concat2_plain`` forward, ``split2_plain`` backward. They are held against
``pallas_concat.concat2_nhcw`` in interpret mode and its ``jax.vjp``, and
against the JAX ``layout.concat_channels`` under the NHCW layout, on the
same seeded numpy inputs in bf16 and f32. Both sides copy values, so every
comparison is exact equality. The shapes include C1 != C2 and widths that
are not multiples of 128 (the Pallas kernel's TPU gate does not apply to
the port, which has none).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cyclegan_tpu.ops import layout as jax_layout
from cyclegan_tpu.ops import pallas_concat
from cyclegan_tpu_torch.ops import concat_channels, cuda_concat, layout

# (B, H, C1, C2, W)
SHAPES = [(2, 4, 16, 32, 128), (2, 3, 5, 7, 9), (1, 6, 48, 16, 40)]
DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}


@pytest.fixture(autouse=True)
def _interpret_mode():
    pallas_concat.set_interpret(True)
    yield
    pallas_concat.set_interpret(False)


@pytest.fixture(autouse=True, scope="module")
def _nhcw_layout():
    """These tests feed the ops and networks NHCW activations, the layout
    of the port's kernels; the default layout scope is NHWC."""
    with layout.nhcw():
        yield


def _pair(shape, seed, dtype):
    """The same values as a JAX array and a torch tensor of ``dtype``."""
    t = torch.from_numpy(np.random.default_rng(seed).normal(
        size=shape).astype(np.float32)).to(DTYPES[dtype][0])
    return jnp.asarray(t.float().numpy(), DTYPES[dtype][1]), t


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _inputs(shape, dtype):
    B, H, c1, c2, W = shape
    return (_pair((B, H, c1, W), 1, dtype), _pair((B, H, c2, W), 2, dtype),
            _pair((B, H, c1 + c2, W), 3, dtype))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", SHAPES)
def test_concat2_and_vjp_equal_pallas(shape, dtype):
    """Concat2 forward (K11's plain version) and its autograd backward
    (K12's) against the Pallas concat and its custom VJP (the two-output
    split)."""
    (ja, a), (jb, b), (jg, g) = _inputs(shape, dtype)
    want, vjp = jax.vjp(pallas_concat.concat2_nhcw, ja, jb)
    want_da, want_db = vjp(jg)

    leaves = [t.clone().requires_grad_(True) for t in (a, b)]
    got = cuda_concat.concat2_nhcw(*leaves)
    assert got.dtype == a.dtype and got.grad_fn is not None
    got_da, got_db = torch.autograd.grad(got, leaves, g)
    np.testing.assert_array_equal(_np(got), _np(want))
    np.testing.assert_array_equal(_np(got_da), _np(want_da))
    np.testing.assert_array_equal(_np(got_db), _np(want_db))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", SHAPES)
def test_plain_versions_equal_pallas(shape, dtype):
    (ja, a), (jb, b), (jg, g) = _inputs(shape, dtype)
    c1 = shape[2]
    np.testing.assert_array_equal(
        _np(cuda_concat.concat2_plain(a, b)),
        _np(pallas_concat.concat2_nhcw(ja, jb)))
    da, db = cuda_concat.split2_plain(g, c1)
    want_da, want_db = pallas_concat._split2(jg, c1)
    assert da.is_contiguous() and db.is_contiguous()
    np.testing.assert_array_equal(_np(da), _np(want_da))
    np.testing.assert_array_equal(_np(db), _np(want_db))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", SHAPES)
def test_concat_channels_equals_jax_under_nhcw(shape, dtype):
    """``ops.concat_channels`` against the JAX ``layout.concat_channels``
    in the NHCW layout (its XLA concatenate: the Pallas gate is off), and
    its VJP."""
    (ja, a), (jb, b), (jg, g) = _inputs(shape, dtype)

    def jax_concat(x, y):
        with jax_layout.nhcw():
            return jax_layout.concat_channels([x, y])

    want, vjp = jax.vjp(jax_concat, ja, jb)
    leaves = [t.clone().requires_grad_(True) for t in (a, b)]
    got = concat_channels(leaves)
    np.testing.assert_array_equal(_np(got), _np(want))
    for got_d, want_d in zip(torch.autograd.grad(got, leaves, g), vjp(jg)):
        np.testing.assert_array_equal(_np(got_d), _np(want_d))


def test_concat_channels_of_three_is_torch_cat():
    """The JAX function sends any other number of pieces to
    ``jnp.concatenate``; the port to ``torch.cat``."""
    xs = [torch.randn(1, 2, c, 3) for c in (1, 2, 3)]
    with jax_layout.nhcw():
        want = jax_layout.concat_channels([jnp.asarray(x.numpy())
                                           for x in xs])
    got = concat_channels(xs)
    assert got.grad_fn is None
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("call", [
    lambda: cuda_concat.concat2_plain(torch.zeros(1, 2, 3, 4),
                                      torch.zeros(1, 2, 3, 5)),
    lambda: cuda_concat.concat2_plain(torch.zeros(1, 2, 3, 4),
                                      torch.zeros(1, 3, 3, 4)),
    lambda: cuda_concat.concat2_plain(
        torch.zeros(1, 2, 3, 4), torch.zeros(1, 2, 3, 4, dtype=torch.bfloat16)),
    lambda: cuda_concat.split2_plain(torch.zeros(1, 2, 3, 4), 3),
    lambda: cuda_concat.split2_plain(torch.zeros(1, 2, 3, 4), 0),
])
def test_wrappers_refuse_what_they_do_not_take(call):
    """Mismatched B, H or W, mixed dtypes, and a split point outside
    (0, C)."""
    with pytest.raises(ValueError):
        call()


def test_kernel_wrappers_refuse_cpu_tensors():
    """``*_cuda`` launch on CUDA tensors only: a CPU tensor is refused
    before any build."""
    a = torch.zeros(1, 2, 3, 4)
    with pytest.raises(ValueError, match="expected CUDA"):
        cuda_concat.concat2_cuda(a, a)
    with pytest.raises(ValueError, match="expected CUDA"):
        cuda_concat.split2_cuda(a, 1)


def test_no_fallback_for_other_devices():
    """Dispatch is on the device alone: neither CUDA nor CPU raises."""
    a = torch.zeros(1, 2, 3, 4, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        cuda_concat.concat2_nhcw(a, a)
    with pytest.raises(ValueError, match="no kernel"):
        cuda_concat.split2(a, 1)
