"""The port's transpose-expansion U-Net and strided U-Net, and the train
steps of their recipes, against the JAX package, on the CPU.

Two recipes at narrow widths, 32x32, batch 2, losses and weights of
``configs/cycle.yaml``:

- T (``configs/unet_transpose.yaml``): U-Nets with ``expansion:
  transpose``, generators 8/16/32/64 all k4, discriminators 8/16/32 at
  k7/k5/k3 (so the discriminators' conv-transposes are k3 and k5);
- S (``configs/strided_unet.yaml``): a ``strided_unet`` generator 8/16/32/64
  at k4 and the default U-Net discriminator 8/16/32 at k7/k5/k3.

One numpy parameter tree, in the JAX package's structure, seeds both
packages. The test point (as ``tests/test_torch_steps.py``): every affine
norm's beta at +-(3..4), gamma 1 +- 0.2 and every bias N(0, 0.1), so whole
channels sit on either side of each ReLU kink; ``test_f32_point_is_kink_free``
asserts that no ReLU input of the port's f32 step lies within 1e-5 of
zero. Pre-norm biases (the conv-transposes' and the strided down convs',
whose outputs an instance norm takes whole) have gradients of rounding
size, so they are compared absolutely, against the network's gradient
norm; every other leaf of a network as one vector, relatively. The JAX
sides run under ``jax.jit``.
"""

import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import pre_norm_bias
from cyclegan_tpu import steps as jax_steps
from cyclegan_tpu.apps import inference as jax_inference
from cyclegan_tpu.apps.inference import InferenceSession as JaxSession
from cyclegan_tpu.losses import get_loss_obj as jax_loss_obj
from cyclegan_tpu.models import create_model as jax_create_model
from cyclegan_tpu.optimizers import get_optimizer as jax_get_optimizer
from cyclegan_tpu_torch import steps
from cyclegan_tpu_torch.apps.inference import InferenceSession
from cyclegan_tpu_torch.config import yaml2namespace
from cyclegan_tpu_torch.losses import get_losses
from cyclegan_tpu_torch.models import StridedUNet, UNetGenerator, create_model
from cyclegan_tpu_torch.ops import cuda_norm_act, layout
from cyclegan_tpu_torch.utils.checkpoint import save_model_folder
from cyclegan_tpu_torch.weights import (
    jax_params_to_torch,
    load_jax_params,
    models_to_jax_params,
    module_to_jax_params,
)
from tests.test_torch_steps import _shift_affine

BASE = yaml2namespace("configs/cycle.yaml")
TRAIN = yaml2namespace("configs/training_config.yaml")
WEIGHTS = {k: float(v) for k, v in BASE.loss_weights.items()}
NETWORKS = steps.NETWORKS
KINK_MARGIN = 1e-5
F32_BOUND = 1e-4


def _unet(filters, kernels, out, expansion, final):
    return {"type": "unet_generator", "filters": filters, "kernels": kernels,
            "output_channels": out, "expansion": expansion,
            "normalization": "instancenorm", "dropout": False,
            "final_activation": final}


_DISC = [8, 16, 32], [7, 5, 3], 1
RECIPES = {
    "transpose": {
        "generator": _unet([8, 16, 32, 64], [4] * 4, 3, "transpose", "tanh"),
        "discriminator": _unet(*_DISC, "transpose", "sigmoid")},
    "strided": {
        "generator": {"type": "strided_unet", "filters": [8, 16, 32, 64],
                      "kernels": [4] * 4, "output_channels": 3,
                      "normalization": "instancenorm",
                      "final_activation": "tanh"},
        "discriminator": _unet(*_DISC, "upsample", "sigmoid")},
}
for _cfg in RECIPES.values():
    _cfg.update(loss=BASE.loss, loss_weights=dict(BASE.loss_weights))
# the new networks: the transpose-expansion generator and discriminator,
# the strided generator
NEW_NETWORKS = [("transpose", "g_AB"), ("transpose", "d_A"),
                ("strided", "g_AB")]


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


def _config(recipe, name):
    return RECIPES[recipe]["generator" if name.startswith("g")
                           else "discriminator"]


@pytest.fixture(scope="module", params=list(RECIPES))
def point(request):
    """(recipe, params tree of numpy, real_a, real_b, JAX models, JAX
    model state) of one recipe."""
    recipe = request.param
    params = models_to_jax_params(steps.build_models(RECIPES[recipe],
                                                     seed=0))
    _shift_affine(params, np.random.default_rng(11))
    real_a, real_b = (np.random.default_rng(s).uniform(
        -1, 1, (2, 32, 32, 3)).astype(np.float32) for s in (2, 3))
    models = {n: jax_create_model(_config(recipe, n)) for n in NETWORKS}
    state = {n: jax.eval_shape(models[n].init, jax.random.PRNGKey(0))[1]
             for n in NETWORKS}
    return recipe, params, real_a, real_b, models, state


def _port_models(recipe, params):
    models = steps.build_models(RECIPES[recipe], seed=0)
    load_jax_params(models, params)
    return models


def _flat(tree):
    return {k: v.numpy() for k, v in
            jax_params_to_torch(jax.tree.map(np.asarray, tree)).items()}


@pytest.fixture(scope="module")
def port_f32(point):
    """The port's f32 surrogate gradients, metrics, and the smallest
    |ReLU input| its forward met."""
    recipe, params, real_a, real_b, _, _ = point
    plain = cuda_norm_act.instance_norm_act_plain
    nearest = []

    def recording(x, gamma, beta, eps=1e-3, act="relu", alpha=0.2,
                  with_stats=False):
        out, mu, rstd = plain(x, gamma, beta, eps, act, alpha,
                              with_stats=True)
        if act == "relu":
            v = ((x - mu[:, None, :, None]) * rstd[:, None, :, None]
                 * gamma[:, None] + beta[:, None])
            nearest.append(float(v.abs().min()))
        return (out, mu, rstd) if with_stats else out

    models = _port_models(recipe, params)
    cuda_norm_act.instance_norm_act_plain = recording
    try:
        surrogate, metrics = steps._forward_losses(
            models, get_losses(BASE.loss), WEIGHTS,
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
    """``jax.grad`` of JAX's train-step surrogate, and its metrics
    (jitted)."""
    _, params, real_a, real_b, models, state = point

    def surrogate(p, a, b):
        total, metrics, _ = jax_steps._forward_losses(
            p, state, models, jax_loss_obj(BASE.loss), WEIGHTS, a, b,
            train=True, rng=None, stop_grads=True)
        return total, metrics

    (_, metrics), grads = jax.jit(jax.value_and_grad(
        surrogate, has_aux=True))(jax.tree.map(jnp.asarray, params),
                                  jnp.asarray(real_a), jnp.asarray(real_b))
    return ({n: _flat(grads[n]) for n in NETWORKS},
            {k: float(v) for k, v in metrics.items()})


def test_f32_point_is_kink_free(port_f32):
    assert port_f32[2] > KINK_MARGIN


def test_f32_gradients_match_jax_grad(port_f32, jax_f32):
    """Per network: the leaves that are not pre-norm biases as one vector,
    |got - want| <= 1e-4 |want|; each pre-norm bias |got - want| <= 1e-4
    |whole network's gradient|."""
    got, want = port_f32[0], jax_f32[0]
    for n in NETWORKS:
        assert got[n].keys() == want[n].keys()
        rest = [k for k in want[n] if not pre_norm_bias(k)]
        g = np.concatenate([got[n][k].ravel() for k in rest])
        w = np.concatenate([want[n][k].ravel() for k in rest])
        norm = float(np.linalg.norm(np.concatenate(
            [v.ravel() for v in want[n].values()])))
        assert np.linalg.norm(g - w) <= F32_BOUND * np.linalg.norm(w), (
            n, float(np.linalg.norm(g - w) / np.linalg.norm(w)))
        for k in want[n]:
            if pre_norm_bias(k):
                assert np.abs(got[n][k] - want[n][k]).max() <= \
                    F32_BOUND * norm, (n, k)


def test_f32_metrics_match_jax(port_f32, jax_f32):
    assert port_f32[1].keys() == jax_f32[1].keys()
    for k, want in jax_f32[1].items():
        assert abs(port_f32[1][k] - want) <= 1e-5 * abs(want), k


def test_train_step_matches_jax(point, port_f32):
    """One step of both packages' train steps (surrogate, one backward,
    four Adam updates). The gradients the port's step leaves are its one
    backward's. Adam's first update is lr g / (|g| + 1e-7): for a pre-norm
    bias's gradient (rounding noise) or a gradient below 1e-6 it turns on
    rounding, so those parameters land within 2 lr of JAX's, every other
    within 1e-5."""
    recipe, params, real_a, real_b, models, state = point
    cfg = RECIPES[recipe]
    port = steps.init_train_state(_port_models(recipe, params), TRAIN,
                                  device="cpu")
    steps.make_train_step(cfg["loss"], cfg["loss_weights"])(
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
    jstate, _ = jax_steps.make_train_step(models, optimizers, cfg["loss"],
                                          WEIGHTS, donate=False)(
        jstate, jnp.asarray(real_a), jnp.asarray(real_b))
    lr = float(TRAIN.g_opt.learning_rate)
    for n in NETWORKS:
        want = _flat(jstate.params[n])
        for k, p in port.models[n].named_parameters():
            diff = np.abs(p.detach().numpy() - want[k])
            noise = pre_norm_bias(k) | (np.abs(p.grad.numpy()) < 1e-6)
            assert (diff <= np.where(noise, 2 * lr, 1e-5)).all(), (
                n, k, float(diff.max()))


@pytest.fixture(scope="module", params=NEW_NETWORKS,
                ids=[f"{r}-{n}" for r, n in NEW_NETWORKS])
def network(request):
    """(JAX model, its params tree of numpy, JAX state, the port's module
    with the same weights, input) of one new network."""
    recipe, name = request.param
    cfg = _config(recipe, name)
    model = create_model(cfg, torch.Generator().manual_seed(1))
    params = module_to_jax_params(model)
    _shift_affine(params, np.random.default_rng(12))
    model.load_state_dict(jax_params_to_torch(params), strict=True)
    jax_model = jax_create_model(cfg)
    state = jax.eval_shape(jax_model.init, jax.random.PRNGKey(0))[1]
    x = np.random.default_rng(4).uniform(-1, 1, (2, 32, 32, 3)).astype(
        np.float32)
    return jax_model, params, state, model, x


def _jax_apply(network, dtype):
    jax_model, params, state, _, x = network
    p = jax.tree.map(lambda v: jnp.asarray(v, dtype), params)
    y = jax.jit(lambda p, x: jax_model.apply(p, state, x)[0])(
        p, jnp.asarray(x, dtype))
    return np.asarray(y, np.float32)


def _port_apply(network, dtype):
    model, x = copy.deepcopy(network[3]).to(dtype), network[4]
    with torch.no_grad():
        y = model(layout.to_nhcw(torch.from_numpy(x).to(dtype)))
    return layout.from_nhcw(y).float().numpy()


def test_network_f32_forward_matches_jax(network):
    """Each new network alone, weights carried JAX -> port: within 1e-5
    (outputs are O(1): tanh, sigmoid)."""
    got = _port_apply(network, torch.float32)
    want = _jax_apply(network, jnp.float32)
    assert got.shape == want.shape and got.shape[:3] == (2, 32, 32)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_network_bf16_forward_matches_jax_bf16(network):
    """Both round every activation to bf16, in other places: the port's
    bf16 output no farther from the JAX f32 output than 1.5x the JAX bf16
    output is, at worst and on average."""
    got = _port_apply(network, torch.bfloat16)
    ref = _jax_apply(network, jnp.bfloat16)
    exact = _jax_apply(network, jnp.float32)
    assert np.abs(got - exact).max() <= 1.5 * np.abs(ref - exact).max()
    assert np.abs(got - exact).mean() <= 1.5 * np.abs(ref - exact).mean()


@pytest.mark.parametrize("recipe,name", NEW_NETWORKS)
def test_module_tree_is_the_jax_init_tree(recipe, name):
    """``module_to_jax_params`` of a freshly built network has the keys,
    list structure and shapes of the JAX ``init`` tree."""
    cfg = _config(recipe, name)
    want = jax.eval_shape(jax_create_model(cfg).init,
                          jax.random.PRNGKey(0))[0]
    got = module_to_jax_params(create_model(cfg, torch.Generator()
                                            .manual_seed(0)))
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        assert g.shape == w.shape and g.dtype == np.float32


def test_parameter_names_and_shapes():
    t = UNetGenerator(RECIPES["transpose"]["generator"]).state_dict()
    assert tuple(t["up.0.convt.w"].shape) == (4, 4, 64, 64)  # HWOI
    assert {"up.2.convt.b", "up.2.convt_norm.gamma", "up.2.dc.0.conv.w",
            "head.b"} <= set(t)
    # the double conv takes skip + f channels
    assert tuple(t["up.2.dc.0.conv.w"].shape) == (4, 4, 8 + 16, 16)
    s = StridedUNet(RECIPES["strided"]["generator"]).state_dict()
    assert {"down.2.conv.b", "down.2.norm.beta", "bottom.w", "bottom.b",
            "up.0.convt.b", "last.w", "last.b"} <= set(s)
    # the up norms run after the concat, over skip + up channels
    assert tuple(s["up.0.norm.gamma"].shape) == (32 + 64,)
    assert tuple(s["last.w"].shape) == (4, 4, 3, 8 + 16)


def test_saved_folder_serves_in_both_packages(tmp_path, point,
                                              monkeypatch):
    """The port writes a model folder; its CPU session reproduces the
    generator it saved, and the JAX session reads the same folder and
    answers within one uint8 step. The JAX session builds the template of
    the checkpoint it restores with an eager ``init`` of the four networks
    (~35 s for these U-Nets on the CPU); zeros of the same shapes and
    dtypes are the same template, and the checkpoint overwrites every
    value."""
    build = jax_inference.create_model

    def create_model_with_template_init(config):
        model = build(config)
        return dataclasses.replace(model, init=lambda key: jax.tree.map(
            lambda s: np.zeros(s.shape, s.dtype),
            jax.eval_shape(model.init, key)))

    monkeypatch.setattr(jax_inference, "create_model",
                        create_model_with_template_init)
    recipe, params = point[:2]
    models = _port_models(recipe, params)
    lines = []
    for part in ("generator", "discriminator"):
        lines.append(f"{part}:")
        for k, v in RECIPES[recipe][part].items():
            lines += ([f"  {k}:"] + [f"    - {i}" for i in v]
                      if isinstance(v, list) else [f"  {k}: {v}"])
    config = tmp_path / "model_config.yaml"
    config.write_text("\n".join(lines) + "\n")
    save_model_folder(tmp_path / "model", config, models)
    images = np.random.default_rng(5).integers(0, 256, (2, 32, 32, 3),
                                               dtype=np.uint8)
    got = InferenceSession(tmp_path / "model", "float32", tpu_layout=True,
                           device="cpu").stylize(images, "a2b")
    with torch.no_grad():
        x = torch.from_numpy(images).float() / 127.5 - 1.0
        y = layout.from_nhcw(models["g_AB"](layout.to_nhcw(x)))
    assert got.dtype == np.uint8 and got.shape == images.shape
    assert np.abs(got.astype(int)
                  - np.round((y.numpy() + 1) * 127.5)).max() <= 1
    want = JaxSession(tmp_path / "model", "float32").stylize(images, "a2b")
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1
