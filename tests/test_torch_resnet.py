"""The port's ResNet recipe against the JAX package, on the CPU.

The canonical CycleGAN recipe (``configs/resnet.yaml``: ResNet-9 generator,
PatchGAN discriminator, weights cycle 10, identity 5) cut to generator
filters 4 and PatchGAN 8/16/32 at 32x32, batch 2. One numpy parameter tree,
drawn in the JAX package's structure, seeds both packages; the JAX side runs
under ``jax.jit`` (eagerly a ResNet-9 forward takes seconds on the CPU).

The test point. Every instance norm of this recipe is non-affine, so the
trick of the U-Net tests (moving beta off the kinks) does not exist here:
the normalized values straddle zero in every channel. Two f32
implementations disagree about the side of a ReLU or LeakyReLU kink for an
input within rounding of it, and one such element moves a gradient by far
more than the bound. The parameter seed is therefore chosen so that no
ReLU or LeakyReLU input of the port's f32 step lies within 1e-5 of zero,
and ``test_f32_point_is_kink_free`` asserts it.

Pre-norm biases. Every conv bias in front of a non-affine instance norm
(all but the two heads') has a gradient that is zero up to rounding,
since the norm removes any per-channel constant. A relative bound per
leaf fails on them by construction, so they are compared absolutely,
against the network's gradient norm; everything else is compared as one
vector per network, relatively.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cyclegan_tpu import steps as jax_steps
from cyclegan_tpu.apps.inference import InferenceSession as JaxSession
from cyclegan_tpu.losses import get_loss_obj as jax_loss_obj
from cyclegan_tpu.models import create_model as jax_create_model
from cyclegan_tpu.optimizers import get_optimizer as jax_get_optimizer
from cyclegan_tpu.utils.checkpoint import load_pytree as jax_load_pytree
from cyclegan_tpu_torch import steps
from cyclegan_tpu_torch.apps.inference import InferenceSession
from cyclegan_tpu_torch.config import yaml2namespace
from cyclegan_tpu_torch.losses import get_loss_obj
from cyclegan_tpu_torch.models import (
    ResNetGenerator,
    SimpleDiscriminator,
    create_model,
)
from cyclegan_tpu_torch.ops import cuda_norm_act, layout
from cyclegan_tpu_torch.utils.checkpoint import save_model_folder, save_pytree
from cyclegan_tpu_torch.weights import (
    jax_params_to_torch,
    load_jax_params,
    module_to_jax_params,
)

RECIPE = yaml2namespace("configs/resnet.yaml")
CFG = {"generator": {"type": "resnet_generator", "filters": 4},
       "discriminator": {"type": "simple_discriminator",
                         "filters": [8, 16, 32], "kernels": [4, 4, 4],
                         "normalization": "instancenorm"},
       "loss": RECIPE.loss, "loss_weights": dict(RECIPE.loss_weights)}
TRAIN = yaml2namespace("configs/training_config.yaml")
WEIGHTS = {k: float(v) for k, v in CFG["loss_weights"].items()}
NETWORKS = steps.NETWORKS
PARAM_SEED = 22          # kink-free at KINK_MARGIN (asserted below)
KINK_MARGIN = 1e-5
F32_BOUND = 1e-4


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


def _config(name):
    return CFG["generator"] if name.startswith("g") else CFG["discriminator"]


def _numpy_params(seed):
    """The JAX init's tree of every network, each leaf drawn with numpy
    from N(0, 0.1), and the JAX models and model states."""
    models = {n: jax_create_model(_config(n)) for n in NETWORKS}
    shapes = {n: jax.eval_shape(models[n].init, jax.random.PRNGKey(0))
              for n in NETWORKS}
    rng = np.random.default_rng(seed)
    params = {n: jax.tree.map(
        lambda leaf: (0.1 * rng.normal(size=leaf.shape)).astype(np.float32),
        shapes[n][0]) for n in NETWORKS}
    state = {n: shapes[n][1] for n in NETWORKS}
    return params, models, state


@pytest.fixture(scope="module")
def point():
    """(params tree of numpy, real_a, real_b, JAX models, JAX state)."""
    params, models, state = _numpy_params(PARAM_SEED)
    real_a = np.random.default_rng(2).uniform(
        -1, 1, (2, 32, 32, 3)).astype(np.float32)
    real_b = np.random.default_rng(3).uniform(
        -1, 1, (2, 32, 32, 3)).astype(np.float32)
    return params, real_a, real_b, models, state


def _port_models(params):
    models = steps.build_models(CFG, seed=0)
    load_jax_params(models, params)
    return models


def _flat(tree):
    return {k: v.numpy() for k, v in
            jax_params_to_torch(jax.tree.map(np.asarray, tree)).items()}


def _pre_norm_bias(name, key):
    """Every conv bias but the heads' feeds a non-affine instance norm."""
    return key.endswith(".b") and not key.startswith("head.")


@pytest.fixture(scope="module")
def port_f32(point):
    """The port's f32 surrogate gradients, metrics, and the smallest
    |ReLU or LeakyReLU input| its forward met."""
    params, real_a, real_b, _, _ = point
    plain = cuda_norm_act.instance_norm_act_plain
    nearest = []

    def recording(x, gamma, beta, eps=1e-3, act="relu", alpha=0.2,
                  with_stats=False):
        out, mu, rstd = plain(x, gamma, beta, eps, act, alpha,
                              with_stats=True)
        if act != "none":
            nearest.append(float(((x - mu[:, None, :, None])
                                  * rstd[:, None, :, None]).abs().min()))
        return (out, mu, rstd) if with_stats else out

    models = _port_models(params)
    cuda_norm_act.instance_norm_act_plain = recording
    try:
        surrogate, metrics = steps._forward_losses(
            models, get_loss_obj(CFG["loss"]), WEIGHTS,
            torch.from_numpy(real_a), torch.from_numpy(real_b),
            torch.float32, stop_grads=True)
    finally:
        cuda_norm_act.instance_norm_act_plain = plain
    named = {n: list(models[n].named_parameters()) for n in NETWORKS}
    values = iter(torch.autograd.grad(
        surrogate, [p for n in NETWORKS for _, p in named[n]]))
    grads = {n: {k: next(values).numpy() for k, _ in named[n]}
             for n in NETWORKS}
    return grads, {k: float(v.detach()) for k, v in metrics.items()}, \
        min(nearest)


@pytest.fixture(scope="module")
def jax_f32(point):
    """Gradients and metrics of JAX's train-step surrogate (jitted)."""
    params, real_a, real_b, models, state = point

    def surrogate(p, a, b):
        total, metrics, _ = jax_steps._forward_losses(
            p, state, models, jax_loss_obj(CFG["loss"]), WEIGHTS, a, b,
            train=True, rng=None, stop_grads=True)
        return total, metrics

    (_, metrics), grads = jax.jit(jax.value_and_grad(
        surrogate, has_aux=True))(jax.tree.map(jnp.asarray, params),
                                  jnp.asarray(real_a), jnp.asarray(real_b))
    return ({n: _flat(grads[n]) for n in NETWORKS},
            {k: float(v) for k, v in metrics.items()})


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
    """Per network: the leaves that are not pre-norm biases as one vector,
    |got - want| <= bound |want|; each pre-norm bias |got - want| <=
    bound |whole network's gradient|."""
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


def test_f32_point_is_kink_free(port_f32):
    assert port_f32[2] > KINK_MARGIN


def test_f32_gradients_match_jax_reference_gradients(port_f32,
                                                     jax_reference):
    """The port's one backward against JAX's naive four backwards."""
    _assert_networks_close(port_f32[0], jax_reference, F32_BOUND)


def test_f32_gradients_match_jax_train_step_gradients(port_f32, jax_f32):
    _assert_networks_close(port_f32[0], jax_f32[0], F32_BOUND)


def test_f32_metrics_match_jax(port_f32, jax_f32):
    assert port_f32[1].keys() == jax_f32[1].keys()
    for k, want in jax_f32[1].items():
        assert abs(port_f32[1][k] - want) <= 1e-5 * abs(want), k


def test_adam_step_matches_jax(point, port_f32):
    """One Adam step of both train steps. Adam's first update is
    lr g / (|g| + 1e-7): for a gradient of rounding size it is of order lr
    and of either sign in the two packages. A pre-norm bias's gradient is
    such noise, and so is a weight gradient below 1e-6 (as in
    ``test_torch_steps``): those land within 2 lr of JAX's, every other
    parameter within 1e-5. The gradients the port's step leaves are its
    one backward's."""
    params, real_a, real_b, models, state = point
    port = steps.init_train_state(_port_models(params), TRAIN, device="cpu")
    steps.make_train_step(CFG["loss"], CFG["loss_weights"])(
        port, torch.from_numpy(real_a), torch.from_numpy(real_b))
    for n in NETWORKS:
        for k, p in port.models[n].named_parameters():
            np.testing.assert_allclose(p.grad.numpy(), port_f32[0][n][k],
                                       rtol=1e-6, atol=1e-9)

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
    lr = float(TRAIN.g_opt.learning_rate)
    for n in NETWORKS:
        want = _flat(jstate.params[n])
        for k, p in port.models[n].named_parameters():
            diff = np.abs(p.detach().numpy() - want[k])
            noise = _pre_norm_bias(n, k) | (np.abs(p.grad.numpy()) < 1e-6)
            assert (diff <= np.where(noise, 2 * lr, 1e-5)).all(), (
                n, k, float(diff.max()))


@pytest.mark.parametrize("name", ["g_AB", "d_A"])
def test_network_f32_matches_jax(point, name):
    """Each network alone, weights carried JAX -> port, and the port's
    tree carried back and applied by JAX."""
    params, real_a, _, models, state = point
    model = create_model(_config(name))
    model.load_state_dict(jax_params_to_torch(params[name]), strict=True)
    with torch.no_grad():
        got = layout.from_nhcw(model(layout.to_nhcw(
            torch.from_numpy(real_a)))).numpy()
    apply = jax.jit(lambda p, x: models[name].apply(p, state[name], x)[0])
    want = np.asarray(apply(jax.tree.map(jnp.asarray, params[name]),
                            jnp.asarray(real_a)))
    shape = (2, 32, 32, 3) if name.startswith("g") else (2, 4, 4, 1)
    assert got.shape == want.shape == shape
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * scale)
    back = module_to_jax_params(model)
    assert jax.tree.structure(back) == jax.tree.structure(params[name])
    again = np.asarray(apply(jax.tree.map(jnp.asarray, back),
                             jnp.asarray(real_a)))
    np.testing.assert_array_equal(again, want)


def test_state_dict_keys_are_checkpoint_paths(point):
    params = point[0]
    gen = ResNetGenerator(CFG["generator"], torch.Generator().manual_seed(0))
    disc = SimpleDiscriminator(CFG["discriminator"])
    for model, tree in ((gen, params["g_AB"]), (disc, params["d_A"])):
        flat = jax_params_to_torch(tree)
        assert set(model.state_dict()) == set(flat)
        for key, value in model.state_dict().items():
            assert tuple(value.shape) == tuple(flat[key].shape), key
    assert {"stem.w", "res.8.conv2.b", "up.1.w", "head.b"} <= set(
        gen.state_dict())
    assert tuple(gen.state_dict()["up.0.w"].shape) == (3, 3, 8, 16)  # HWOI
    assert {"blocks.2.conv.w", "head.w"} <= set(disc.state_dict())
    # the non-affine norms hold no parameter, but stay in the JAX tree
    assert module_to_jax_params(disc)["blocks"][0]["norm"] == {}


def test_save_pytree_reads_back_in_jax(tmp_path, point):
    params = point[0]
    tree = {"params": params, "step": np.int32(7)}
    save_pytree(tmp_path / "c.npz", tree)
    got = jax_load_pytree(tmp_path / "c.npz", tree)
    assert jax.tree.structure(got) == jax.tree.structure(tree)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(tree)):
        np.testing.assert_array_equal(a, b)
    assert not [p for p in tmp_path.iterdir() if p.suffix == ".tmp"]


def test_saved_resnet_folder_serves_in_both_packages(tmp_path, point):
    """The port writes a model folder; its CPU session reproduces the
    generator it saved, and the JAX session reads the same folder and
    answers within one uint8 step."""
    params = point[0]
    models = _port_models(params)
    config = tmp_path / "resnet_small.yaml"
    config.write_text(
        "generator:\n  type: resnet_generator\n  filters: 4\n"
        "discriminator:\n  type: simple_discriminator\n  filters:\n"
        "    - 8\n    - 16\n    - 32\n  kernels:\n    - 4\n    - 4\n"
        "    - 4\n  normalization: instancenorm\n")
    save_model_folder(tmp_path / "model", config, models)
    images = np.random.default_rng(5).integers(0, 256, (2, 32, 32, 3),
                                               dtype=np.uint8)
    session = InferenceSession(tmp_path / "model", "float32", device="cpu")
    got = session.stylize(images, "b2a")
    with torch.no_grad():
        x = torch.from_numpy(images).float() / 127.5 - 1.0
        y = layout.from_nhcw(models["g_BA"](layout.to_nhcw(x)))
    assert got.dtype == np.uint8 and got.shape == images.shape
    assert np.abs(got.astype(int)
                  - np.round((y.numpy() + 1) * 127.5)).max() <= 1
    want = JaxSession(tmp_path / "model", "float32").stylize(images, "b2a")
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1
