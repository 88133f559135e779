"""The fifth recipe, ``configs/unet_patchgan.yaml`` (the default U-Net
generator with PatchGAN discriminators, cycle weight 10, identity weight
5), against the JAX package on the CPU, in both layouts of the port.

Cut to generator filters 8/16/32 and PatchGAN 8/16/32 (both k4, as the
recipe) at 32x32, batch 2. One numpy parameter tree seeds both packages:
the port's init from ``PARAM_SEED`` with every affine norm's beta moved to
+-(3..4) (``tests/test_torch_steps.py``), so the U-Nets' ReLUs sit off
their kinks; the PatchGAN's norms are non-affine, so the seed is one where
no ReLU or LeakyReLU input of the port's f32 step lies within 1e-5 of
zero in either layout (``test_f32_point_is_kink_free``). The JAX side runs
under ``jax.jit``.

Bounds (``tests/test_torch_steps.py``, ``tests/test_torch_resnet.py``):
the networks' outputs within 1e-4 of the largest |output|; gradients per
network, pre-norm biases apart, within 1e-4 relative as one vector, and
each PatchGAN pre-norm bias (its gradient is rounding: the norm removes
any per-channel constant) within 1e-4 of the network's gradient norm;
after one Adam step every parameter within 1e-5 of JAX's, or within 2 lr
where its gradient is rounding-sized (a pre-norm bias, or below 1e-6).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import nearest_kink
from cyclegan_tpu import steps as jax_steps
from cyclegan_tpu.models import create_model as jax_create_model
from cyclegan_tpu.optimizers import get_optimizer as jax_get_optimizer
from cyclegan_tpu_torch import steps
from cyclegan_tpu_torch.config import yaml2namespace
from cyclegan_tpu_torch.losses import get_losses
from cyclegan_tpu_torch.models import create_model
from cyclegan_tpu_torch.ops import layout
from cyclegan_tpu_torch.weights import (
    jax_params_to_torch,
    load_jax_params,
    models_to_jax_params,
)
from tests.test_torch_steps import _shift_affine

RECIPE = yaml2namespace("configs/unet_patchgan.yaml")
CFG = {"generator": dict(RECIPE.generator, filters=[8, 16, 32],
                         kernels=[4, 4, 4]),
       "discriminator": dict(RECIPE.discriminator, filters=[8, 16, 32]),
       "loss": RECIPE.loss, "loss_weights": dict(RECIPE.loss_weights)}
TRAIN = yaml2namespace("configs/training_config.yaml")
WEIGHTS = {k: float(v) for k, v in CFG["loss_weights"].items()}
NETWORKS = steps.NETWORKS
LAYOUTS = ["nhcw", "nhwc"]
PARAM_SEED = 0           # kink-free at KINK_MARGIN (asserted below)
KINK_MARGIN = 1e-5
F32_BOUND = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in several worker processes."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _config(name):
    return CFG["generator"] if name.startswith("g") else CFG["discriminator"]


@pytest.fixture(scope="module")
def point():
    """(params tree of numpy, real_a, real_b, JAX models, JAX state)."""
    params = models_to_jax_params(steps.build_models(CFG, seed=PARAM_SEED))
    _shift_affine(params, np.random.default_rng(11))
    real_a, real_b = (np.random.default_rng(s).uniform(
        -1, 1, (2, 32, 32, 3)).astype(np.float32) for s in (2, 3))
    models = {n: jax_create_model(_config(n)) for n in NETWORKS}
    state = {n: jax.eval_shape(models[n].init, jax.random.PRNGKey(0))[1]
             for n in NETWORKS}
    return params, real_a, real_b, models, state


def _port_models(params):
    models = steps.build_models(CFG, seed=0)
    load_jax_params(models, params)
    return models


def _flat(tree):
    return {k: v.numpy() for k, v in
            jax_params_to_torch(jax.tree.map(np.asarray, tree)).items()}


def _pre_norm_bias(name, key):
    """The PatchGAN's conv biases but the head's feed non-affine norms."""
    return name.startswith("d") and key.endswith(".b") and \
        not key.startswith("head.")


def _port_grads(params, real_a, real_b, tpu_layout):
    models = _port_models(params)
    surrogate, metrics = steps._forward_losses(
        models, get_losses(CFG["loss"]), WEIGHTS, torch.from_numpy(real_a),
        torch.from_numpy(real_b), torch.float32, stop_grads=True,
        tpu_layout=tpu_layout)
    named = {n: list(models[n].named_parameters()) for n in NETWORKS}
    values = iter(torch.autograd.grad(
        surrogate, [p for n in NETWORKS for _, p in named[n]]))
    return {n: {k: next(values).numpy() for k, _ in named[n]}
            for n in NETWORKS}


@pytest.fixture(scope="module")
def port_f32(point):
    """{layout: (the port's f32 surrogate gradients, nearest kink)}."""
    params, real_a, real_b, _, _ = point
    return {name: nearest_kink(lambda: _port_grads(
        params, real_a, real_b, name == "nhcw")) for name in LAYOUTS}


@pytest.fixture(scope="module")
def jax_reference(point):
    """JAX's naive four-backward gradients (jitted)."""
    params, real_a, real_b, models, state = point
    grads = jax.jit(lambda p, a, b: jax_steps.reference_gradients(
        models, CFG["loss"], WEIGHTS, p, state, a, b))(
        jax.tree.map(jnp.asarray, params), jnp.asarray(real_a),
        jnp.asarray(real_b))
    return {n: _flat(grads[n]) for n in NETWORKS}


def _assert_networks_close(got, want, bound):
    for n in NETWORKS:
        assert got[n].keys() == want[n].keys()
        rest = [k for k in want[n] if not _pre_norm_bias(n, k)]
        g = np.concatenate([got[n][k].ravel() for k in rest])
        w = np.concatenate([want[n][k].ravel() for k in rest])
        norm = float(np.linalg.norm(np.concatenate(
            [v.ravel() for v in want[n].values()])))
        assert np.linalg.norm(g - w) <= bound * np.linalg.norm(w), (
            n, float(np.linalg.norm(g - w) / np.linalg.norm(w)))
        for k in want[n]:
            if _pre_norm_bias(n, k):
                assert np.abs(got[n][k] - want[n][k]).max() <= bound * norm, (
                    n, k)


def test_config_is_the_recipe_cut_to_width():
    assert CFG["generator"]["type"] == "unet_generator"
    assert CFG["discriminator"]["type"] == "simple_discriminator"
    assert CFG["discriminator"]["kernels"] == [4, 4, 4]
    assert RECIPE.discriminator.filters == [64, 128, 256]
    assert WEIGHTS == dict(cycle=10.0, identity=5.0, generator=1.0,
                           discriminator=0.5)


@pytest.mark.parametrize("name", LAYOUTS)
def test_f32_point_is_kink_free(port_f32, name):
    assert port_f32[name][1] > KINK_MARGIN


@pytest.mark.parametrize("name", LAYOUTS)
@pytest.mark.parametrize("network", ["g_AB", "d_A"])
def test_network_f32_matches_jax(point, network, name):
    params, real_a, _, models, state = point
    model = create_model(_config(network))
    model.load_state_dict(jax_params_to_torch(params[network]), strict=True)
    x = torch.from_numpy(real_a)
    with torch.no_grad():
        if name == "nhcw":
            with layout.nhcw():
                got = layout.from_nhcw(model(layout.to_nhcw(x))).numpy()
        else:
            got = model(x).numpy()
    want = np.asarray(jax.jit(
        lambda p, x: models[network].apply(p, state[network], x)[0])(
        jax.tree.map(jnp.asarray, params[network]), jnp.asarray(real_a)))
    shape = (2, 32, 32, 3) if network.startswith("g") else (2, 4, 4, 1)
    assert got.shape == want.shape == shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-4 * float(np.abs(want).max()))


@pytest.mark.parametrize("name", LAYOUTS)
def test_f32_gradients_match_jax_reference_gradients(port_f32,
                                                     jax_reference, name):
    _assert_networks_close(port_f32[name][0], jax_reference, F32_BOUND)


@pytest.fixture(scope="module")
def jax_adam_step(point):
    """JAX's parameters after one Adam step (jitted)."""
    params, real_a, real_b, models, state = point
    optimizers = {n: jax_get_optimizer(TRAIN.g_opt if n.startswith("g")
                                       else TRAIN.d_opt) for n in NETWORKS}
    jparams = jax.tree.map(jnp.asarray, params)
    jstate = jax_steps.TrainState(
        params=jparams, model_state=state,
        opt_state={n: optimizers[n].init(jparams[n]) for n in NETWORKS},
        rng=jax.random.PRNGKey(0), step=jnp.zeros((), jnp.int32))
    jstate, _ = jax_steps.make_train_step(models, optimizers, CFG["loss"],
                                          WEIGHTS, donate=False)(
        jstate, jnp.asarray(real_a), jnp.asarray(real_b))
    return {n: _flat(jstate.params[n]) for n in NETWORKS}


@pytest.mark.parametrize("name", LAYOUTS)
def test_adam_step_matches_jax(point, port_f32, jax_adam_step, name):
    params, real_a, real_b, _, _ = point
    port = steps.init_train_state(_port_models(params), TRAIN, device="cpu")
    steps.make_train_step(CFG["loss"], CFG["loss_weights"],
                          tpu_layout=name == "nhcw")(
        port, torch.from_numpy(real_a), torch.from_numpy(real_b))
    lr = float(TRAIN.g_opt.learning_rate)
    for n in NETWORKS:
        for k, p in port.models[n].named_parameters():
            np.testing.assert_allclose(p.grad.numpy(),
                                       port_f32[name][0][n][k], rtol=1e-6,
                                       atol=1e-9)
            diff = np.abs(p.detach().numpy() - jax_adam_step[n][k])
            noise = _pre_norm_bias(n, k) | (np.abs(p.grad.numpy()) < 1e-6)
            assert (diff <= np.where(noise, 2 * lr, 1e-5)).all(), (
                n, k, float(diff.max()))
