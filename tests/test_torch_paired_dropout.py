"""The paired step and dropout against the JAX package, on the CPU.

``paired``: the port's ``torch.func.vmap`` over the twin networks' stacked
parameters against JAX's ``_forward_losses_paired`` (gradients) and
``make_train_step(paired=True)`` (one Adam step), with the port's NHWC
norms on torch ops and on K13's plain version (``pallas_norm``). Dropout:
one training step of a U-Net recipe with ``dropout: True`` in both the
generator and the discriminator config, where JAX's ``dropout`` (bound in
``cyclegan_tpu.models.unet``) is replaced for the test by one that takes
the keep masks the port's step drew, in order: per generator application
(``fake_b, cycled_a, fake_a, cycled_b, same_a, same_b``) two per
double-conv block in block order. JAX's discriminators get no key, so
they never drop out; a port whose discriminators drew masks would leave
masks over or differ. Then validation and ``fuse_apps`` with dropout.

The default U-Net recipe cut to generator 8/16/32 and discriminator
8/16/32 (k7/k5/k3) at 32x32, batch 2, every beta at +-(3..4) so no ReLU
sits on its kink (``tests/test_torch_steps.py``). Bounds as there:
gradients within 1e-4 relative per network; after an Adam step every
parameter within 1e-5, or within 2 lr where a gradient is below 1e-6
(Adam's first update lr g / (|g| + 1e-7) turns on rounding there);
metrics within 1e-5 relative. The JAX references run under ``jax.jit``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cyclegan_tpu.models.unet as jax_unet
from cyclegan_tpu import steps as jax_steps
from cyclegan_tpu.losses import get_loss_obj as jax_loss_obj
from cyclegan_tpu.models import create_model as jax_create_model
from cyclegan_tpu.optimizers import get_optimizer as jax_get_optimizer
from cyclegan_tpu_torch import steps
from cyclegan_tpu_torch.losses import get_loss_obj
from cyclegan_tpu_torch.models import UNetGenerator
from cyclegan_tpu_torch.ops import conv as conv_ops
from cyclegan_tpu_torch.ops import cuda_norm
from cyclegan_tpu_torch.weights import (
    jax_params_to_torch,
    load_jax_params,
    models_to_jax_params,
)
from tests.test_torch_step_options import UNET_CFG, assert_networks_close
from tests.test_torch_steps import _shift_affine

NETWORKS = steps.NETWORKS
TRAIN = dict(g_opt=dict(name="adam", learning_rate=2e-4, beta_1=0.5),
             d_opt=dict(name="adam", learning_rate=2e-4, beta_1=0.5))
WEIGHTS = {k: float(v) for k, v in UNET_CFG["loss_weights"].items()}
DROPOUT_CFG = dict(UNET_CFG,
                   generator=dict(UNET_CFG["generator"], dropout=True),
                   discriminator=dict(UNET_CFG["discriminator"],
                                      dropout=True))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in several worker processes."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _jax_models(cfg):
    models = {n: jax_create_model(cfg["generator"] if n.startswith("g")
                                  else cfg["discriminator"])
              for n in NETWORKS}
    state = {n: jax.eval_shape(models[n].init, jax.random.PRNGKey(0))[1]
             for n in NETWORKS}
    return models, state


@pytest.fixture(scope="module")
def point():
    params = models_to_jax_params(steps.build_models(UNET_CFG, seed=0))
    _shift_affine(params, np.random.default_rng(11))
    real_a, real_b = (np.random.default_rng(s).uniform(
        -1, 1, (2, 32, 32, 3)).astype(np.float32) for s in (2, 3))
    return params, real_a, real_b


def _port_state(cfg, params, seed=0):
    models = steps.build_models(cfg, seed=0)
    load_jax_params(models, params)
    return steps.init_train_state(models, TRAIN, seed=seed, device="cpu")


def _jax_train_state(params, models, state):
    optimizers = {n: jax_get_optimizer(TRAIN["g_opt"]) for n in NETWORKS}
    jparams = jax.tree.map(jnp.asarray, params)
    return optimizers, jax_steps.TrainState(
        params=jparams, model_state=state,
        opt_state={n: optimizers[n].init(jparams[n]) for n in NETWORKS},
        rng=jax.random.PRNGKey(0), step=jnp.zeros((), jnp.int32))


def _flat(tree):
    return {k: v.numpy() for k, v in
            jax_params_to_torch(jax.tree.map(np.asarray, tree)).items()}


def _assert_adam_step_close(port, want):
    lr = TRAIN["g_opt"]["learning_rate"]
    for n in NETWORKS:
        for k, p in port.models[n].named_parameters():
            diff = np.abs(p.detach().numpy() - want[n][k])
            small = np.abs(p.grad.numpy()) < 1e-6
            assert (diff <= np.where(small, 2 * lr, 1e-5)).all(), (
                n, k, float(diff.max()))


def _assert_metrics_close(got, want):
    assert got.keys() == want.keys()
    for k, w in want.items():
        assert abs(float(got[k]) - float(w)) <= 1e-5 * abs(float(w)) + 1e-7, k


# ---------------------------------------------------------------- paired

@pytest.fixture(scope="module")
def jax_paired(point):
    """JAX's paired surrogate gradients and its paired Adam step."""
    params, real_a, real_b = point
    models, state = _jax_models(UNET_CFG)

    def surrogate(p, a, b):
        return jax_steps._forward_losses_paired(
            p, state, models, jax_loss_obj(UNET_CFG["loss"]), WEIGHTS, a, b,
            train=True, rng=None, stop_grads=True)[0]

    args = (jnp.asarray(real_a), jnp.asarray(real_b))
    grads = jax.jit(jax.grad(surrogate))(jax.tree.map(jnp.asarray, params),
                                         *args)
    optimizers, jstate = _jax_train_state(params, models, state)
    jstate, metrics = jax_steps.make_train_step(
        models, optimizers, UNET_CFG["loss"], WEIGHTS, donate=False,
        paired=True)(jstate, *args)
    return ({n: _flat(grads[n]) for n in NETWORKS},
            {n: _flat(jstate.params[n]) for n in NETWORKS}, metrics)


@pytest.mark.parametrize("pallas_norm", [False, True])
def test_paired_gradients_match_jax(point, jax_paired, pallas_norm):
    params, real_a, real_b = point
    models = _port_state(UNET_CFG, params).models
    surrogate, _ = steps._forward_losses(
        models, get_loss_obj(UNET_CFG["loss"]), WEIGHTS,
        torch.from_numpy(real_a), torch.from_numpy(real_b), torch.float32,
        stop_grads=True, pallas_norm=pallas_norm, paired=True)
    named = {n: list(models[n].named_parameters()) for n in NETWORKS}
    values = iter(torch.autograd.grad(
        surrogate, [p for n in NETWORKS for _, p in named[n]]))
    got = {n: {k: next(values).numpy() for k, _ in named[n]}
           for n in NETWORKS}
    assert_networks_close(got, jax_paired[0], 1e-4)


@pytest.mark.parametrize("pallas_norm", [False, True])
def test_paired_train_step_matches_jax(point, jax_paired, pallas_norm):
    params, real_a, real_b = point
    port = _port_state(UNET_CFG, params)
    metrics = steps.make_train_step(
        UNET_CFG["loss"], WEIGHTS, pallas_norm=pallas_norm, paired=True)(
        port, torch.from_numpy(real_a), torch.from_numpy(real_b))
    _assert_metrics_close(metrics, jax_paired[2])
    _assert_adam_step_close(port, jax_paired[1])


def test_paired_runs_nhwc_through_the_vmap_rules(point, monkeypatch):
    """The layout flag changes nothing (JAX's paired step ignores it), and
    the twin applications go through LibraryConv's and K13's batching
    rules, once per vmapped convolution and norm."""
    params, real_a, real_b = point
    calls = {"conv": 0, "norm": 0}
    for key, cls in (("conv", conv_ops.LibraryConv),
                     ("norm", cuda_norm.InstanceNormNHWC)):
        rule = cls.vmap

        def counting(*args, key=key, rule=rule):
            calls[key] += 1
            return rule(*args)

        monkeypatch.setattr(cls, "vmap", staticmethod(counting))
    grads = {}
    for tpu_layout in (True, False):
        port = _port_state(UNET_CFG, params)
        steps.make_train_step(UNET_CFG["loss"], WEIGHTS, paired=True,
                              pallas_norm=True, tpu_layout=tpu_layout)(
            port, torch.from_numpy(real_a), torch.from_numpy(real_b))
        grads[tpu_layout] = [p.grad.clone() for n in NETWORKS
                             for p in port.models[n].parameters()]
    assert all(torch.equal(a, b) for a, b in zip(*grads.values()))
    # per step: 3 generator rounds and 3 discriminator calls, each of 11
    # convs and 10 norms
    assert calls == {"conv": 2 * 6 * 11, "norm": 2 * 6 * 10}


# ---------------------------------------------------------------- dropout

def _recording_masks(monkeypatch):
    """Record every mask list the port's generators draw, in order."""
    drawn = []
    draw = UNetGenerator.dropout_masks

    def recording(self, *args, **kwargs):
        masks = draw(self, *args, **kwargs)
        drawn.append(masks)
        return masks

    monkeypatch.setattr(UNetGenerator, "dropout_masks", recording)
    return drawn


@pytest.fixture(scope="module")
def jax_dropout_step(point):
    """JAX's train step with its ``dropout`` taking keep masks in order
    from a list that is an argument of the jitted function, so one
    compile serves every set of masks: (state, masks, a, b) -> (state,
    metrics)."""
    params = point[0]
    models, state = _jax_models(DROPOUT_CFG)
    optimizers, jstate = _jax_train_state(params, models, state)
    step = jax_steps.make_train_step(
        models, optimizers, DROPOUT_CFG["loss"], WEIGHTS,
        donate=False).__wrapped__
    queue = []

    def dropout(x, rate, rng, train):
        if not train or rng is None:
            return x
        mask = queue.pop(0)
        assert mask.shape == x.shape
        return jnp.where(mask, x / (1.0 - rate), jnp.zeros_like(x))

    def run(jstate, masks, a, b):
        queue[:] = list(masks)
        with pytest.MonkeyPatch.context() as patch:
            patch.setattr(jax_unet, "dropout", dropout)
            out = step(jstate, a, b)
        assert not queue  # every mask taken, by the generators alone
        return out

    return jstate, jax.jit(run)


@pytest.mark.parametrize("name", ["nhcw", "nhwc"])
def test_dropout_train_step_matches_jax_with_its_masks(
        point, jax_dropout_step, monkeypatch, name):
    params, real_a, real_b = point
    drawn = _recording_masks(monkeypatch)
    port = _port_state(DROPOUT_CFG, params)
    got = steps.make_train_step(DROPOUT_CFG["loss"], WEIGHTS,
                                tpu_layout=name == "nhcw")(
        port, torch.from_numpy(real_a), torch.from_numpy(real_b))
    # 6 generator applications, none of the discriminators'; 2 masks per
    # double-conv block of 5
    assert [len(m) for m in drawn] == [10] * 6
    flat = [m.numpy() for masks in drawn for m in masks]
    if name == "nhcw":
        flat = [m.transpose(0, 1, 3, 2) for m in flat]
    assert 0.45 < np.mean([m.mean() for m in flat]) < 0.55
    jstate, run = jax_dropout_step
    jstate, want = run(jstate, [jnp.asarray(m) for m in flat],
                       jnp.asarray(real_a), jnp.asarray(real_b))
    _assert_metrics_close(got, want)
    _assert_adam_step_close(port, {n: _flat(jstate.params[n])
                                   for n in NETWORKS})


def test_dropout_changes_training_only(point):
    """With dropout the train step's losses change; the validate step's
    (no masks) equal those of the same networks without dropout."""
    params, real_a, real_b = point
    batch = (torch.from_numpy(real_a), torch.from_numpy(real_b))
    with_dropout = _port_state(DROPOUT_CFG, params)
    without = _port_state(UNET_CFG, params)
    validate = steps.make_validate_step(UNET_CFG["loss"], WEIGHTS)
    for k, v in validate(without, *batch).items():
        assert torch.equal(validate(with_dropout, *batch)[k], v), k
    train = steps.make_train_step(UNET_CFG["loss"], WEIGHTS)
    assert float(train(with_dropout, *batch)["gAB_loss"]) != float(
        train(without, *batch)["gAB_loss"])


def test_fuse_apps_with_dropout_runs_unfused(point, monkeypatch):
    """A U-Net with dropout is not batchable: fuse_apps leaves the six
    applications, their masks and the step as they are."""
    params, real_a, real_b = point
    drawn = _recording_masks(monkeypatch)
    grads = []
    for fuse_apps in (False, True):
        port = _port_state(DROPOUT_CFG, params, seed=4)
        assert not port.models["g_AB"].batchable
        steps.make_train_step(DROPOUT_CFG["loss"], WEIGHTS,
                              fuse_apps=fuse_apps)(
            port, torch.from_numpy(real_a), torch.from_numpy(real_b))
        grads.append([p.grad for n in NETWORKS
                      for p in port.models[n].parameters()])
    assert [m[0].shape[0] for m in drawn] == [2] * 12
    assert all(torch.equal(a, b) for a, b in zip(*grads))


def test_remat_reapplies_the_same_masks(point):
    params, real_a, real_b = point
    grads = []
    for remat in (False, True):
        port = _port_state(DROPOUT_CFG, params, seed=4)
        steps.make_train_step(DROPOUT_CFG["loss"], WEIGHTS, remat=remat)(
            port, torch.from_numpy(real_a), torch.from_numpy(real_b))
        grads.append([p.grad for n in NETWORKS
                      for p in port.models[n].parameters()])
    assert all(torch.equal(a, b) for a, b in zip(*grads))
