"""The train step's ``fuse_apps`` and ``remat`` against the JAX package's
``_forward_losses`` options and against the port's own plain step, on the
CPU, in both layouts.

Two recipes: the default U-Net recipe (``configs/cycle.yaml``) cut to
generator filters 8/16/32 and discriminator 8/16/32 at its k7/k5/k3, its
betas moved to +-(3..4) (``tests/test_torch_steps.py``) so no ReLU sits
on its kink, and the ResNet recipe at the cut and kink-free seed of
``tests/test_torch_resnet.py``; 32x32, batch 2, f32. The JAX references
run under ``jax.jit``.

Bounds: against JAX, each network's gradient within 1e-4 relative as one
vector, pre-norm conv biases (rounding-sized: a non-affine norm removes
any per-channel constant) within 1e-4 of the network's gradient norm, as
``tests/test_torch_resnet.py``; the fused step against the unfused one
within 1e-6 relative (the same math: only the batch sums of the weight
gradients of the two fused applications change order); the remat step
against the plain one, bit for bit (the recompute runs the same ops on the
same inputs).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import nearest_kink, pre_norm_bias
from cyclegan_tpu import steps as jax_steps
from cyclegan_tpu.losses import get_loss_obj as jax_loss_obj
from cyclegan_tpu.models import create_model as jax_create_model
from cyclegan_tpu_torch import steps
from cyclegan_tpu_torch.config import yaml2namespace
from cyclegan_tpu_torch.losses import get_loss_obj
from cyclegan_tpu_torch.weights import (
    jax_params_to_torch,
    load_jax_params,
    models_to_jax_params,
)
from tests.test_torch_resnet import CFG as RESNET_CFG
from tests.test_torch_resnet import PARAM_SEED as RESNET_SEED
from tests.test_torch_resnet import _numpy_params
from tests.test_torch_steps import _shift_affine

_DEFAULT = yaml2namespace("configs/cycle.yaml")
UNET_CFG = {"generator": dict(_DEFAULT.generator, filters=[8, 16, 32],
                              kernels=[4, 4, 4]),
            "discriminator": dict(_DEFAULT.discriminator,
                                  filters=[8, 16, 32]),
            "loss": _DEFAULT.loss,
            "loss_weights": dict(_DEFAULT.loss_weights)}
RECIPES = {"unet": UNET_CFG, "resnet": RESNET_CFG}
NETWORKS = steps.NETWORKS
LAYOUTS = ["nhcw", "nhwc"]
KINK_MARGIN = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in several worker processes."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _params(recipe):
    if recipe == "resnet":
        return _numpy_params(RESNET_SEED)[0]
    params = models_to_jax_params(steps.build_models(UNET_CFG, seed=0))
    _shift_affine(params, np.random.default_rng(11))
    return params


@pytest.fixture(scope="module")
def points():
    """{recipe: (numpy params, real_a, real_b, JAX models, JAX state)}."""
    real_a, real_b = (np.random.default_rng(s).uniform(
        -1, 1, (2, 32, 32, 3)).astype(np.float32) for s in (2, 3))
    out = {}
    for recipe, cfg in RECIPES.items():
        models = {n: jax_create_model(cfg["generator"] if n.startswith("g")
                                      else cfg["discriminator"])
                  for n in NETWORKS}
        state = {n: jax.eval_shape(models[n].init, jax.random.PRNGKey(0))[1]
                 for n in NETWORKS}
        out[recipe] = (_params(recipe), real_a, real_b, models, state)
    return out


def _port_models(recipe, params):
    models = steps.build_models(RECIPES[recipe], seed=0)
    load_jax_params(models, params)
    return models


def port_grads(recipe, point, tpu_layout, **options):
    """{network: {parameter: gradient}} of the port's surrogate."""
    params, real_a, real_b = point[:3]
    cfg = RECIPES[recipe]
    models = _port_models(recipe, params)
    surrogate, _ = steps._forward_losses(
        models, get_loss_obj(cfg["loss"]),
        {k: float(v) for k, v in cfg["loss_weights"].items()},
        torch.from_numpy(real_a), torch.from_numpy(real_b), torch.float32,
        stop_grads=True, tpu_layout=tpu_layout, **options)
    named = {n: list(models[n].named_parameters()) for n in NETWORKS}
    values = iter(torch.autograd.grad(
        surrogate, [p for n in NETWORKS for _, p in named[n]]))
    return {n: {k: next(values).numpy() for k, _ in named[n]}
            for n in NETWORKS}


def jax_grads(recipe, point, **options):
    """JAX's surrogate gradients with ``_forward_losses`` ``options``."""
    params, real_a, real_b, models, state = point
    cfg = RECIPES[recipe]
    weights = {k: float(v) for k, v in cfg["loss_weights"].items()}

    def surrogate(p, a, b):
        return jax_steps._forward_losses(
            p, state, models, jax_loss_obj(cfg["loss"]), weights, a, b,
            train=True, rng=None, stop_grads=True, **options)[0]

    grads = jax.jit(jax.grad(surrogate))(jax.tree.map(jnp.asarray, params),
                                         jnp.asarray(real_a),
                                         jnp.asarray(real_b))
    return {n: {k: v.numpy() for k, v in jax_params_to_torch(
        jax.tree.map(np.asarray, grads[n])).items()} for n in NETWORKS}


def assert_networks_close(got, want, bound):
    """Per network: the leaves but pre-norm biases within ``bound``
    relative as one vector; each pre-norm bias within ``bound`` of the
    network's gradient norm."""
    for n in NETWORKS:
        assert got[n].keys() == want[n].keys()
        rest = [k for k in want[n] if not pre_norm_bias(k)]
        g = np.concatenate([got[n][k].ravel() for k in rest])
        w = np.concatenate([want[n][k].ravel() for k in rest])
        norm = float(np.linalg.norm(np.concatenate(
            [v.ravel() for v in want[n].values()])))
        assert np.linalg.norm(g - w) <= bound * np.linalg.norm(w), (
            n, float(np.linalg.norm(g - w) / np.linalg.norm(w)))
        for k in want[n]:
            if pre_norm_bias(k):
                assert np.abs(got[n][k] - want[n][k]).max() <= bound * norm, (
                    n, k)


@pytest.fixture(scope="module")
def fused(points):
    """{(recipe, layout): (the port's fused gradients, nearest kink)}."""
    return {(recipe, name): nearest_kink(lambda: port_grads(
        recipe, points[recipe], name == "nhcw", fuse_apps=True))
        for recipe in RECIPES for name in LAYOUTS}


@pytest.fixture(scope="module")
def jax_fused(points):
    return {recipe: jax_grads(recipe, points[recipe], fuse_apps=True)
            for recipe in RECIPES}


@pytest.mark.parametrize("name", LAYOUTS)
@pytest.mark.parametrize("recipe", sorted(RECIPES))
def test_fused_matches_jax_fused(fused, jax_fused, recipe, name):
    grads, kink = fused[(recipe, name)]
    assert kink > KINK_MARGIN
    assert_networks_close(grads, jax_fused[recipe], 1e-4)


@pytest.mark.parametrize("name", LAYOUTS)
@pytest.mark.parametrize("recipe", sorted(RECIPES))
def test_fused_matches_unfused(points, fused, recipe, name):
    plain = port_grads(recipe, points[recipe], name == "nhcw")
    assert_networks_close(fused[(recipe, name)][0], plain, 1e-6)


@pytest.mark.parametrize("fuse_apps", [False, True])
def test_fused_runs_four_generator_applications(points, fuse_apps):
    """6 generator applications at batch N, or 4 with two at 2N."""
    models = _port_models("unet", points["unet"][0])
    batches = []
    for n in ("g_AB", "g_BA"):
        models[n].register_forward_hook(
            lambda m, args, out: batches.append(args[0].shape[0]))
    params, real_a, real_b = points["unet"][:3]
    steps._forward_losses(
        models, get_loss_obj("mse"), {k: 1.0 for k in (
            "generator", "cycle", "identity", "discriminator")},
        torch.from_numpy(real_a), torch.from_numpy(real_b), torch.float32,
        stop_grads=True, fuse_apps=fuse_apps)
    assert sorted(batches) == ([2, 2, 4, 4] if fuse_apps else [2] * 6)


@pytest.fixture(scope="module")
def plain_unet(points):
    return {name: port_grads("unet", points["unet"], name == "nhcw")
            for name in LAYOUTS}


@pytest.mark.parametrize("name", LAYOUTS)
def test_remat_equals_plain_step(points, plain_unet, name):
    """The recompute runs in the backward, after the step's layout scope
    has closed: it must re-enter NHCW (a recompute in NHWC would fail on
    the shapes or change the gradients)."""
    got = port_grads("unet", points["unet"], name == "nhcw", remat=True)
    for n in NETWORKS:
        for k, want in plain_unet[name][n].items():
            np.testing.assert_array_equal(got[n][k], want, err_msg=(n, k))


@pytest.fixture(scope="module")
def jax_remat(points):
    return jax_grads("unet", points["unet"], remat=True)


@pytest.mark.parametrize("name", LAYOUTS)
def test_remat_matches_jax_remat(points, jax_remat, name):
    got = port_grads("unet", points["unet"], name == "nhcw", remat=True)
    assert_networks_close(got, jax_remat, 1e-4)


def test_remat_recomputes_the_generators_only(points, monkeypatch):
    """Each generator application runs its forward twice (the recompute),
    each discriminator application once."""
    models = _port_models("unet", points["unet"][0])
    calls = {n: 0 for n in NETWORKS}
    for n in NETWORKS:
        models[n].register_forward_pre_hook(
            lambda m, args, n=n: calls.__setitem__(n, calls[n] + 1))
    params, real_a, real_b = points["unet"][:3]
    surrogate, _ = steps._forward_losses(
        models, get_loss_obj("mse"), {k: 1.0 for k in (
            "generator", "cycle", "identity", "discriminator")},
        torch.from_numpy(real_a), torch.from_numpy(real_b), torch.float32,
        stop_grads=True, remat=True)
    assert calls == {"g_AB": 3, "g_BA": 3, "d_A": 3, "d_B": 3}
    surrogate.backward()
    assert calls == {"g_AB": 6, "g_BA": 6, "d_A": 3, "d_B": 3}
