"""The NHWC layout of the port on the CPU: each op's NHWC branch and the
four recipes' networks against the JAX package in NHWC (its XLA path), and
the port's NHWC and NHCW outputs against each other.

Tolerances, f32: ops 1e-5 relative + 2e-5 absolute (sums of up to 7x7x7
products in another order); copies exact, their adjoints (sums of up to
four cotangents) 1e-6; networks 1e-4 absolute on outputs
in [-1, 1] and 1e-4 relative to each network's gradient norm, at points
where no ReLU or LeakyReLU input lies within 1e-5 of zero (asserted), so
rounding cannot flip an activation's side.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cyclegan_tpu import ops as jax_ops
from cyclegan_tpu.models import create_model as jax_create_model
from cyclegan_tpu_torch import ops
from cyclegan_tpu_torch.config import yaml2namespace
from cyclegan_tpu_torch.models import create_model
from cyclegan_tpu_torch.ops import conv as conv_ops
from cyclegan_tpu_torch.ops import cuda_norm, layout
from cyclegan_tpu_torch.ops import norm as norm_ops
from cyclegan_tpu_torch.weights import (
    jax_params_to_torch,
    module_to_jax_params,
)

KINK_MARGIN = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in several worker processes."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _rnd(shape, seed, scale=1.0):
    return (scale * np.random.default_rng(seed).normal(size=shape)).astype(
        np.float32)


def _check_op(port_fn, jax_fn, arrays, atol=2e-5):
    """Forward and gradients (of sum(y * dy)) of the port's op on torch
    tensors against the JAX op's, both NHWC."""
    want, vjp = jax.vjp(jax_fn, *map(jnp.asarray, arrays))
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in arrays]
    got = port_fn(*leaves)
    assert tuple(got.shape) == tuple(want.shape)
    rtol = 1e-5 if atol else 0.0
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=rtol, atol=atol)
    dy = _rnd(tuple(want.shape), 99)
    for g, w in zip(torch.autograd.grad(got, leaves, torch.from_numpy(dy)),
                    vjp(jnp.asarray(dy))):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=rtol,
                                   atol=atol)


@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("k", [3, 4, 7])
def test_conv2d_matches_jax(k, stride):
    x, w, b = _rnd((2, 10, 12, 5), 0), _rnd((k, k, 5, 6), 1, 0.2), _rnd(
        (6,), 2)
    _check_op(lambda *a: ops.conv2d(*a, stride=stride),
              lambda *a: jax_ops.conv2d(*a, stride=stride), [x, w, b])


@pytest.mark.parametrize("k", [3, 4])
def test_conv2d_transpose_matches_jax(k):
    x, w, b = _rnd((2, 6, 5, 4), 3), _rnd((k, k, 7, 4), 4, 0.2), _rnd(
        (7,), 5)
    _check_op(lambda *a: ops.conv2d_transpose(*a, stride=2),
              lambda *a: jax_ops.conv2d_transpose(*a, stride=2), [x, w, b])


@pytest.mark.parametrize("k", [3, 7])
def test_conv2d_reflect_matches_jax(k):
    x, w, b = _rnd((1, 9, 8, 3), 6), _rnd((k, k, 3, 4), 7, 0.2), _rnd(
        (4,), 8)
    _check_op(ops.conv2d_reflect, jax_ops.conv2d_reflect, [x, w, b])


def test_reflection_pad2d_matches_jax():
    # the adjoint adds up to four cotangents in another order: 1e-6
    _check_op(lambda x: ops.reflection_pad2d(x, (2, 3)),
              lambda x: jax_ops.reflection_pad2d(x, (2, 3)),
              [_rnd((2, 5, 6, 3), 9)], atol=1e-6)


def test_avg_pool2x2_matches_jax():
    _check_op(ops.avg_pool2x2, jax_ops.avg_pool2x2,
              [_rnd((2, 8, 6, 5), 10)])


def test_upsample_concat_matches_jax():
    # the upsample's adjoint adds four cotangents in another order: 1e-6
    _check_op(ops.upsample_concat, jax_ops.upsample_concat,
              [_rnd((2, 8, 6, 3), 11), _rnd((2, 4, 3, 5), 12)], atol=1e-6)


def test_concat_channels_matches_jax():
    _check_op(lambda a, b: ops.concat_channels([a, b]),
              lambda a, b: jax_ops.concat_channels([a, b]),
              [_rnd((2, 4, 6, 3), 13), _rnd((2, 4, 6, 5), 14)], atol=0)


def test_library_convs_keep_channels_last(monkeypatch):
    """The NHWC convs hand cuDNN the channels_last view and get one back,
    so no copy to NCHW is made around them."""
    formats = []
    apply = conv_ops.LibraryConv.apply

    def recording(x, *args):
        y = apply(x, *args)
        formats.append((x.is_contiguous(memory_format=torch.channels_last),
                        y.is_contiguous(memory_format=torch.channels_last)))
        return y

    monkeypatch.setattr(conv_ops.LibraryConv, "apply", recording)
    x = torch.randn(2, 8, 8, 4)
    for y in (ops.conv2d(x, torch.randn(4, 4, 4, 6)),
              ops.conv2d(x, torch.randn(3, 3, 4, 6), stride=2),
              ops.conv2d_reflect(x, torch.randn(3, 3, 4, 6)),
              ops.conv2d_transpose(x, torch.randn(4, 4, 6, 4))):
        assert y.is_contiguous()
    assert formats == [(True, True)] * 4


RECIPES = {
    "unet": ("configs/cycle.yaml", [4, 4, 8, 8], [4, 4, 8]),
    "resnet": ("configs/resnet.yaml", 4, [8, 8, 16]),
    "transpose": ("configs/unet_transpose.yaml", [4, 4, 8, 8], [4, 4, 8]),
    "strided": ("configs/strided_unet.yaml", [4, 4, 8, 8], [4, 4, 8]),
}


def _networks():
    for recipe, (path, g_filters, d_filters) in RECIPES.items():
        cfg = yaml2namespace(path)
        yield recipe, "generator", dict(cfg.generator, filters=g_filters)
        if recipe in ("unet", "resnet"):
            yield recipe, "discriminator", dict(cfg.discriminator,
                                                filters=d_filters)


NETWORKS = list(_networks())


def _shifted_params(model, seed):
    """The model's parameters as a numpy tree with every affine norm's beta
    at +-(3..4) and biases at N(0, 0.1), so whole channels sit on either
    side of the ReLU kink."""
    rng = np.random.default_rng(seed)

    def leaf(p):
        name = next(k for k, q in model.named_parameters() if q is p)
        v = p.detach().numpy()
        if name.endswith("beta"):
            return (rng.choice([-1.0, 1.0], v.shape)
                    * rng.uniform(3.0, 4.0, v.shape)).astype(np.float32)
        if name.endswith(".b"):
            return (0.1 * rng.normal(size=v.shape)).astype(np.float32)
        return v

    return module_to_jax_params(model, leaf)


@pytest.fixture(scope="module", params=NETWORKS,
                ids=[f"{r}-{p}" for r, p, _ in NETWORKS])
def network(request):
    """(config, numpy params, input, cotangent, JAX output, JAX gradients)
    at a kink-free point; the JAX side under ``jax.jit``."""
    recipe, part, cfg = request.param
    # seed 3: kink-free for the non-affine ResNet networks too
    model = create_model(cfg, torch.Generator().manual_seed(3))
    params = _shifted_params(model, 2)
    x = np.random.default_rng(3).uniform(-1, 1, (2, 32, 32, 3)).astype(
        np.float32)
    jax_model = jax_create_model(cfg)
    state = jax.eval_shape(jax_model.init, jax.random.PRNGKey(0))[1]

    @jax.jit
    def forward_and_grads(params, x, dy):
        def loss(p):
            y = jax_model.apply(p, state, x, train=True)[0]
            return jnp.sum(y * dy), y
        return jax.grad(loss, has_aux=True)(params)

    y_shape = jax.eval_shape(lambda p, x: jax_model.apply(p, state, x)[0],
                             params, x).shape
    dy = _rnd(tuple(y_shape), 4)
    grads, y = forward_and_grads(jax.tree.map(jnp.asarray, params),
                                 jnp.asarray(x), jnp.asarray(dy))
    return cfg, params, x, dy, np.asarray(y), jax.tree.map(np.asarray, grads)


def _port(cfg, params, x, dy, nhcw=False, pallas=False):
    """The port's output and gradients, and the nearest ReLU input."""
    model = create_model(cfg)
    model.load_state_dict(jax_params_to_torch(params), strict=True)
    nearest = [np.inf]
    activation = norm_ops.activation

    def recording(y, act, alpha):
        if act != "none":
            nearest[0] = min(nearest[0], float(y.detach().abs().min()))
        return activation(y, act, alpha)

    norm_ops.activation = recording
    try:
        xt = torch.from_numpy(x)
        with layout.nhcw(nhcw), cuda_norm.scope(pallas):
            y = model(layout.to_nhcw(xt) if nhcw else xt)
        y = layout.from_nhcw(y) if nhcw else y
    finally:
        norm_ops.activation = activation
    grads = torch.autograd.grad(y, list(model.parameters()),
                                torch.from_numpy(dy))
    names = [k for k, _ in model.named_parameters()]
    return y.detach().numpy(), dict(zip(names, grads)), nearest[0]


def _grad_error(got, want):
    want = jax_params_to_torch(want)
    diff = sum(float(((got[k] - want[k]) ** 2).sum()) for k in want)
    norm = sum(float((want[k] ** 2).sum()) for k in want)
    return (diff / norm) ** 0.5


@pytest.mark.parametrize("pallas", [False, True])
def test_network_matches_jax_nhwc(network, pallas):
    """Forward and parameter gradients of each recipe's networks in NHWC,
    with the norms on torch ops and on K13's plain version."""
    cfg, params, x, dy, want_y, want_grads = network
    y, grads, kink = _port(cfg, params, x, dy, pallas=pallas)
    assert kink > KINK_MARGIN
    np.testing.assert_allclose(y, want_y, rtol=0, atol=1e-4)
    assert _grad_error(grads, want_grads) <= 1e-4


def test_network_nhwc_and_nhcw_agree(network):
    cfg, params, x, dy, _, _ = network
    y, grads, _ = _port(cfg, params, x, dy)
    y2, grads2, _ = _port(cfg, params, x, dy, nhcw=True)
    np.testing.assert_allclose(y, y2, rtol=0, atol=1e-4)
    norm = sum(float((g ** 2).sum()) for g in grads.values()) ** 0.5
    diff = sum(float(((grads[k] - grads2[k]) ** 2).sum())
               for k in grads) ** 0.5
    assert diff <= 1e-4 * norm
