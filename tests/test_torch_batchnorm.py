"""Batch norm in the port against the JAX package, on the CPU.

``normalization: batchnorm`` at small widths: ``batch_norm_stats`` in both
layouts and dtypes, the four model types (output and new moving
statistics against ``model.apply``), one f32 train step of a batch-norm
U-Net recipe against JAX's ``make_train_step`` (metrics, parameters after
Adam, and the moving statistics each network keeps), the validate step,
checkpoints both ways and ``InferenceSession``. Weights and inputs are
drawn with numpy from seeds and carried into both packages. JAX runs under
``jax.jit``; the port runs its plain kernel versions with one torch
intra-op thread.

Tolerances: f32 outputs and statistics within 1e-5 (the same math in
another summation order; 1e-4 for a model's output on random moving
statistics, which do not normalize its activations); bf16 outputs within
one bf16 step of their value (both round the same f32 result once); f32
parameters after one Adam step within 1e-5 where the gradient is not
below 1e-6 (there Adam's g / (sqrt(v) + eps) turns on rounding); f32
serving within 1 uint8 step.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cyclegan_tpu import steps as jax_steps
from cyclegan_tpu.apps.inference import InferenceSession as JaxSession
from cyclegan_tpu.models import create_model as jax_create_model
from cyclegan_tpu.ops import layout as jax_layout
from cyclegan_tpu.ops.norm import batch_norm_stats as jax_batch_norm_stats
from cyclegan_tpu.optimizers import get_optimizer as jax_get_optimizer
from cyclegan_tpu.utils import checkpoint as jax_checkpoint
from cyclegan_tpu_torch import steps
from cyclegan_tpu_torch.apps.inference import InferenceSession
from cyclegan_tpu_torch.config import namespace2yaml, yaml2namespace
from cyclegan_tpu_torch.models import create_model
from cyclegan_tpu_torch.ops import layout
from cyclegan_tpu_torch.ops import norm as norm_ops
from cyclegan_tpu_torch.utils.checkpoint import (
    LEGACY_TRAIN_STATE_INDEX,
    legacy_key,
    load_train_state,
    save_train_state,
)
from cyclegan_tpu_torch.weights import (
    jax_params_to_torch,
    load_jax_params,
    models_to_jax_params,
    models_to_jax_state,
)

NETWORKS = steps.NETWORKS
TRAIN = yaml2namespace("configs/training_config.yaml")
BN = {"normalization": "batchnorm"}
GEN = {"type": "unet_generator", "filters": [8, 16, 32], "kernels": [4, 4, 4],
       "output_channels": 3, "expansion": "upsample", "dropout": False,
       "final_activation": "tanh", **BN}
DISC = {"type": "unet_generator", "filters": [8, 16], "kernels": [7, 5],
        "output_channels": 1, "expansion": "upsample", "dropout": False,
        "final_activation": "sigmoid", **BN}
MODEL_TYPES = {
    "unet_upsample": GEN,
    "unet_transpose": {**GEN, "expansion": "transpose"},
    "strided_unet": {"type": "strided_unet", "filters": [8, 16, 32],
                     "kernels": [4, 4, 4], "output_channels": 3,
                     "final_activation": "tanh", **BN},
    "simple_discriminator": {"type": "simple_discriminator",
                             "filters": [8, 16], "kernels": [4, 4], **BN},
}


def model_config(name="bn", location="model_instances"):
    cfg = copy.deepcopy(yaml2namespace("configs/cycle.yaml"))
    cfg.generator, cfg.discriminator = dict(GEN), dict(DISC)
    cfg.name, cfg.location = name, str(location)
    return cfg


CFG = model_config()
WEIGHTS = {k: float(v) for k, v in CFG.loss_weights.items()}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in several worker processes."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _draw(tree, rng, stats=False):
    """Every leaf of a params (or model_state) tree redrawn in place:
    convs N(0, 0.1), gamma 1 +- 0.2, beta +-(3..4) so that whole channels
    sit on either side of the ReLU kink, biases N(0, 0.1); moving means
    N(0, 0.5), moving variances 0.5..2."""
    items = enumerate(tree) if isinstance(tree, list) else list(tree.items())
    for k, v in items:
        if isinstance(v, (dict, list)):
            _draw(v, rng, stats)
            continue
        shape = np.shape(v)
        if k == "beta":
            new = rng.choice([-1.0, 1.0], shape) * rng.uniform(3, 4, shape)
        elif k == "gamma":
            new = 1.0 + 0.2 * rng.normal(size=shape)
        elif k == "moving_mean":
            new = 0.5 * rng.normal(size=shape)
        elif k == "moving_var":
            new = rng.uniform(0.5, 2.0, shape)
        else:
            new = 0.1 * rng.normal(size=shape)
        tree[k] = new.astype(np.float32)
    return tree


def _jax_tree(model, seed):
    params, state = jax.device_get(model.init(jax.random.PRNGKey(0)))
    rng = np.random.default_rng(seed)
    return _draw(params, rng), _draw(state, rng, stats=True)


def _port_model(cfg, params, state):
    model = create_model(cfg)
    load_jax_params({"m": model}, {"m": params}, {"m": state})
    return model


# --- batch_norm_stats -----------------------------------------------------

@pytest.mark.parametrize("train", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("nhcw", [False, True])
def test_batch_norm_stats_matches_jax(nhcw, dtype, train):
    rng = np.random.default_rng(5)
    x = (3.0 + 2.0 * rng.normal(size=(3, 8, 5, 8) if nhcw
                                else (3, 8, 8, 5))).astype(np.float32)
    gamma, beta = (rng.normal(size=5).astype(np.float32) for _ in range(2))
    mean0 = rng.normal(size=5).astype(np.float32)
    var0 = rng.uniform(0.5, 2, 5).astype(np.float32)
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    with jax_layout.nhcw(nhcw):
        want = jax.jit(jax_batch_norm_stats, static_argnums=5)(
            jnp.asarray(x, jdt), gamma, beta, mean0, var0, train)
    with layout.nhcw(nhcw):
        got = norm_ops.batch_norm_stats(
            torch.from_numpy(x).to(tdt), torch.from_numpy(gamma),
            torch.from_numpy(beta), torch.from_numpy(mean0),
            torch.from_numpy(var0), train)
    assert got[0].dtype == tdt and got[1].dtype == torch.float32
    y, w = got[0].float().numpy(), np.asarray(want[0], np.float32)
    if dtype == "float32":
        np.testing.assert_allclose(y, w, rtol=0, atol=1e-5)
    else:  # one bf16 step of the value
        assert (np.abs(y - w) <= 2.0 ** -7 * np.abs(w) + 1e-6).all()
    for g, v in zip(got[1:], want[1:]):
        np.testing.assert_allclose(g.numpy(), np.asarray(v), rtol=1e-5,
                                   atol=1e-6)
    if not train:
        assert torch.equal(got[1], torch.from_numpy(mean0))


@pytest.mark.parametrize("affine", [True, False])
@pytest.mark.parametrize("act", ["relu", "leaky_relu", "none"])
@pytest.mark.parametrize("nhcw", [False, True])
def test_closed_form_backward_matches_autograd(nhcw, act, affine):
    """``BatchNormAct`` (train mode) against autograd through
    ``batch_norm_stats`` and the activation: outputs, statistics and every
    gradient within 1e-5 in f32 (the same math, summed in another order);
    in bf16 the output within one bf16 step and the gradients within 1e-2
    of their scale, and under ``vmap`` each member as alone."""
    rng = np.random.default_rng(7)
    shape = (3, 6, 5, 7) if nhcw else (3, 6, 7, 5)
    x = torch.from_numpy((1.0 + rng.normal(size=shape)).astype(np.float32))
    gamma = torch.from_numpy(rng.normal(size=5).astype(np.float32))
    beta = torch.from_numpy(rng.normal(size=5).astype(np.float32))
    g = torch.from_numpy(rng.normal(size=shape).astype(np.float32))
    params = (gamma, beta) if affine else (None, None)
    zero, one = torch.zeros(5), torch.ones(5)
    with layout.nhcw(nhcw):
        axes = (0,) + layout.spatial_axes()
        outs = {}
        for dtype in (torch.float32, torch.bfloat16):
            for way in ("closed", "autograd"):
                xs = x.to(dtype).clone().requires_grad_()
                ps = [p.to(dtype).clone().requires_grad_() if p is not None
                      else None for p in params]
                if way == "closed":
                    y, mean, var = norm_ops.BatchNormAct.apply(
                        xs, *ps, axes, act, 0.2, 1e-3)
                    stats = (mean.reshape(-1), var.reshape(-1))
                else:
                    y, m, v = norm_ops.batch_norm_stats(xs, *ps, zero, one,
                                                        True, momentum=0.0)
                    y = norm_ops.activation(y, act, 0.2)
                    stats = (m, v)
                (y.float() * g).sum().backward()
                grads = [t.grad.float() for t in [xs, *ps] if t is not None]
                outs[(dtype, way)] = (y.float(), stats, grads)
        closed, auto = outs[(torch.float32, "closed")], outs[
            (torch.float32, "autograd")]
        torch.testing.assert_close(closed[0], auto[0], rtol=0, atol=1e-5)
        for a, b in zip(closed[1] + tuple(closed[2]),
                        auto[1] + tuple(auto[2])):
            torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)
        c16, a16 = outs[(torch.bfloat16, "closed")], outs[
            (torch.bfloat16, "autograd")]
        assert ((c16[0] - a16[0]).abs() <= 2.0 ** -7 * a16[0].abs()
                + 1e-6).all()
        for a, b in zip(c16[2], a16[2]):
            assert (a - b).abs().max() <= 1e-2 * b.abs().max()
        stacked = torch.stack([x, 2 * x + 1])
        ys = torch.func.vmap(lambda t: norm_ops.BatchNormAct.apply(
            t, *params, axes, act, 0.2, 1e-3)[0])(stacked)
        for i in range(2):
            torch.testing.assert_close(ys[i], norm_ops.BatchNormAct.apply(
                stacked[i], *params, axes, act, 0.2, 1e-3)[0])


def test_batch_norm_is_scoped_per_thread():
    """Outside a scope batch norm serves (moving statistics, no sink); a
    scope's sink receives one entry per norm, keyed by its owner."""
    model = create_model(GEN, torch.Generator().manual_seed(0))
    x = torch.randn(2, 16, 16, 3)
    assert norm_ops.batch_mode() == (False, None)
    with norm_ops.batch_stats(True, {}) as sink:
        model(x)
    norms = [m for m in model.modules() if hasattr(m, "moving_mean")]
    assert set(sink) == set(norms) and len(norms) == 10
    norm_ops.commit_batch_stats(sink)
    for owner, (mean, var) in sink.items():
        assert torch.equal(owner.moving_mean, mean)
    assert norm_ops.batch_mode() == (False, None)


# --- the four model types -------------------------------------------------

@pytest.mark.parametrize("train", [True, False])
@pytest.mark.parametrize("kind", sorted(MODEL_TYPES))
def test_model_matches_jax_apply(kind, train):
    """Output and new moving statistics of ``model.apply`` (the port in
    NHCW, its kernel layout; JAX in NHWC), and the port's buffers are the
    JAX ``model_state`` tree."""
    cfg = MODEL_TYPES[kind]
    jmodel = jax_create_model(cfg)
    params, state = _jax_tree(jmodel, seed=1)
    x = np.random.default_rng(2).uniform(-1, 1, (2, 32, 32, 3)).astype(
        np.float32)
    y_want, state_want = jax.jit(
        lambda p, s, x: jmodel.apply(p, s, x, train=train))(params, state, x)
    model = _port_model(cfg, params, state)
    assert set(model.state_dict()) == set(
        jax_params_to_torch(params)) | set(jax_params_to_torch(state))
    with layout.nhcw(), torch.no_grad(), \
            norm_ops.batch_stats(train, {}) as sink:
        y = layout.from_nhcw(model(layout.to_nhcw(torch.from_numpy(x))))
    # eval mode: random moving statistics do not normalize these
    # activations, which grow through the layers, and the f32 rounding of
    # another summation order with them
    np.testing.assert_allclose(y.numpy(), np.asarray(y_want), rtol=0,
                               atol=1e-5 if train else 1e-4)
    norm_ops.commit_batch_stats(sink)
    got = models_to_jax_state({"m": model})["m"]
    want = jax_params_to_torch(jax.device_get(state_want))
    for key, value in jax_params_to_torch(got).items():
        np.testing.assert_allclose(value.numpy(), want[key].numpy(),
                                   rtol=1e-5, atol=1e-6, err_msg=key)
    assert model.batchable is False


def test_resnet_generator_stays_stateless():
    cfg = {"type": "resnet_generator", "filters": 8, **BN}
    assert list(create_model(cfg).buffers()) == []
    assert jax.tree.leaves(jax.eval_shape(jax_create_model(cfg).init,
                                          jax.random.PRNGKey(0))[1]) == []


# --- the train step -------------------------------------------------------

@pytest.fixture(scope="module")
def point():
    """(params, model_state, real_a, real_b, JAX models) of the recipe."""
    models = steps.build_models(CFG, seed=0)
    rng = np.random.default_rng(11)
    params = _draw(models_to_jax_params(models), rng)
    state = _draw(models_to_jax_state(models), rng, stats=True)
    real_a, real_b = (np.random.default_rng(s).uniform(
        -1, 1, (2, 32, 32, 3)).astype(np.float32) for s in (2, 3))
    jmodels = {n: jax_create_model(CFG.generator if n.startswith("g")
                                   else CFG.discriminator) for n in NETWORKS}
    return params, state, real_a, real_b, jmodels


def _port_state(point):
    params, state = point[:2]
    models = steps.build_models(CFG, seed=0)
    load_jax_params(models, params, state)
    return steps.init_train_state(models, TRAIN, device="cpu")


def _jax_state(point):
    params, state, _, _, jmodels = point
    optimizers = {n: jax_get_optimizer(TRAIN.g_opt if n.startswith("g")
                                       else TRAIN.d_opt) for n in NETWORKS}
    jparams = jax.tree.map(jnp.asarray, params)
    return jax_steps.TrainState(
        params=jparams, model_state=jax.tree.map(jnp.asarray, state),
        opt_state={n: optimizers[n].init(jparams[n]) for n in NETWORKS},
        rng=jax.random.PRNGKey(0),
        step=jnp.zeros((), jnp.int32)), optimizers


@pytest.fixture(scope="module")
def stepped(point):
    """One f32 train step in each package: (port state, its metrics, JAX
    state, its metrics)."""
    _, _, real_a, real_b, jmodels = point
    port = _port_state(point)
    metrics = steps.make_train_step(CFG.loss, CFG.loss_weights)(
        port, torch.from_numpy(real_a), torch.from_numpy(real_b))
    jstate, optimizers = _jax_state(point)
    jstate, jmetrics = jax_steps.make_train_step(
        jmodels, optimizers, CFG.loss, WEIGHTS, donate=False)(
            jstate, jnp.asarray(real_a), jnp.asarray(real_b))
    return port, metrics, jstate, jmetrics


def _flat(tree):
    return {k: v.numpy() for k, v in
            jax_params_to_torch(jax.device_get(tree)).items()}


def test_train_step_metrics_match_jax(stepped):
    _, metrics, _, want = stepped
    for k in want:
        assert abs(float(metrics[k]) - float(want[k])) <= 1e-5 * max(
            abs(float(want[k])), 1e-3), k


def test_train_step_parameters_match_jax(stepped):
    port, _, jstate, _ = stepped
    for n in NETWORKS:
        want = _flat(jstate.params[n])
        for k, p in port.models[n].named_parameters():
            far = np.abs(p.detach().numpy() - want[k]) > 1e-5
            assert not (far & (p.grad.abs().numpy() >= 1e-6)).any(), (n, k)


def test_train_step_keeps_jax_statistics(stepped):
    """Every moving statistic after the step equals JAX's new
    ``model_state``, and changed from the old one."""
    port, _, jstate, _ = stepped
    got = models_to_jax_state(port.models)
    for n in NETWORKS:
        want = _flat(jstate.model_state[n])
        for k, v in jax_params_to_torch(got[n]).items():
            np.testing.assert_allclose(v.numpy(), want[k], rtol=1e-5,
                                       atol=1e-7, err_msg=f"{n}.{k}")


# (network, the application the step keeps, another application of the
# same network on the same step) as ``steps._forward_losses`` runs them
KEPT = {"g_AB": ("fake_a", "real_a"), "g_BA": ("real_b", "fake_b"),
        "d_A": ("fake_a", "real_a"), "d_B": ("fake_b", "real_b")}


def test_train_step_keeps_the_right_application(point, stepped):
    """Which application's statistics are kept: the committed statistics
    of each network are those of its application to KEPT's first input
    (g_AB's cycle pass on fake_a, g_BA's translation pass on real_b, each
    discriminator on its fake batch) and not those of its other
    application."""
    params, state, real_a, real_b, _ = point
    port = stepped[0]
    fresh = _port_state(point)
    with torch.no_grad(), layout.nhcw(), norm_ops.batch_stats(True):
        a, b = (layout.to_nhcw(torch.from_numpy(t)) for t in (real_a,
                                                               real_b))
        inputs = {"real_a": a, "real_b": b,
                  "fake_b": fresh.models["g_AB"](a),
                  "fake_a": fresh.models["g_BA"](b)}
    for n, (kept, other) in KEPT.items():
        stats = {}
        for name in (kept, other):
            with torch.no_grad(), layout.nhcw(), \
                    norm_ops.batch_stats(True, {}) as sink:
                fresh.models[n](inputs[name])
            stats[name] = {owner: mean for owner, (mean, _) in sink.items()}
        for owner in stats[kept]:
            now = owner_stat(port, fresh, n, owner)
            assert torch.allclose(now, stats[kept][owner], rtol=1e-5,
                                  atol=1e-7), n

            def batch(new):  # the batch mean a momentum step took in
                return (new - 0.99 * owner.moving_mean) / 0.01

            assert (batch(now) - batch(stats[other][owner])).abs().max() \
                > 1e-2, n


def owner_stat(port, fresh, network, owner):
    """``owner`` (a norm block of ``fresh``'s network) -> the same block's
    committed moving mean in ``port``."""
    names = {m: k for k, m in fresh.models[network].named_modules()}
    return dict(port.models[network].named_modules())[
        names[owner]].moving_mean


def test_remat_and_bf16_commit_as_the_plain_step(point, stepped):
    """A ``remat`` step commits the plain step's statistics (its recompute
    commits nothing); a bf16 step keeps them f32."""
    _, _, real_a, real_b, _ = point
    remat = _port_state(point)
    steps.make_train_step(CFG.loss, CFG.loss_weights, remat=True)(
        remat, torch.from_numpy(real_a), torch.from_numpy(real_b))
    want = jax_params_to_torch(models_to_jax_state(stepped[0].models))
    got = jax_params_to_torch(models_to_jax_state(remat.models))
    for k in want:
        torch.testing.assert_close(got[k], want[k], rtol=1e-6, atol=1e-7)
    half = _port_state(point)
    steps.make_train_step(CFG.loss, CFG.loss_weights, "bfloat16")(
        half, torch.from_numpy(real_a), torch.from_numpy(real_b))
    for model in half.models.values():
        assert {b.dtype for b in model.buffers()} == {torch.float32}
    bf16 = jax_params_to_torch(models_to_jax_state(half.models))
    assert all(not torch.equal(bf16[k], jax_params_to_torch(point[1])[k])
               for k in bf16)


def test_paired_step_keeps_the_old_statistics(point):
    """JAX's paired step (``steps.py``: ``new_model_state =
    state.model_state``) keeps the moving statistics as they were, and so
    does the port's."""
    _, state, real_a, real_b, jmodels = point
    real_a, real_b = (np.ascontiguousarray(t[:, :16, :16])
                      for t in (real_a, real_b))
    port = _port_state(point)
    steps.make_train_step(CFG.loss, CFG.loss_weights, paired=True)(
        port, torch.from_numpy(real_a), torch.from_numpy(real_b))
    want = jax_params_to_torch(state)
    for k, v in jax_params_to_torch(models_to_jax_state(port.models)).items():
        assert torch.equal(v, want[k]), k
    jstate, optimizers = _jax_state(point)
    jstate2, _ = jax_steps.make_train_step(
        jmodels, optimizers, CFG.loss, WEIGHTS, donate=False, paired=True)(
            jstate, jnp.asarray(real_a), jnp.asarray(real_b))
    for k, v in _flat(jstate2.model_state).items():
        np.testing.assert_array_equal(v, _flat(jstate.model_state)[k])


def test_validate_step_matches_jax(point):
    """On the moving statistics: the port's and JAX's validate metrics."""
    _, _, real_a, real_b, jmodels = point
    port = _port_state(point)
    got = steps.make_validate_step(CFG.loss, CFG.loss_weights)(
        port, torch.from_numpy(real_a), torch.from_numpy(real_b))
    jstate, _ = _jax_state(point)
    want = jax_steps.make_validate_step(jmodels, CFG.loss, WEIGHTS)(
        jstate, jnp.asarray(real_a), jnp.asarray(real_b))
    for k in want:
        assert abs(float(got[k]) - float(want[k])) <= 1e-5 * max(
            abs(float(want[k])), 1e-3), k


# --- checkpoints and serving ----------------------------------------------

def _jax_template(point):
    jstate, _ = _jax_state(point)
    return jax.device_get(jstate)


def test_port_checkpoint_reads_in_jax(point, stepped, tmp_path):
    port = stepped[0]
    save_train_state(tmp_path / "ck.npz", port, np.zeros(2, np.uint32))
    restored = jax_checkpoint.load_pytree(tmp_path / "ck.npz",
                                          _jax_template(point))
    for tree, port_tree in ((restored.params,
                             models_to_jax_params(port.models)),
                            (restored.model_state,
                             models_to_jax_state(port.models))):
        want = jax_params_to_torch(port_tree)
        for k, v in jax_params_to_torch(tree).items():
            assert torch.equal(v, want[k]), k
    assert int(restored.step) == 1


@pytest.mark.parametrize("legacy", [False, True])
def test_jax_checkpoint_reads_in_the_port(point, stepped, tmp_path, legacy):
    """JAX's checkpoint after its step, under the named keys or the
    round-1 positional ones (``model_state`` at index 1)."""
    jstate = jax.device_get(stepped[2])
    jax_checkpoint.save_pytree(tmp_path / "ck.npz", jstate)
    if legacy:
        with np.load(tmp_path / "ck.npz") as data:
            stored = {k: data[k] for k in data.files}
        assert LEGACY_TRAIN_STATE_INDEX["model_state"] == 1
        np.savez(tmp_path / "ck.npz",
                 **{legacy_key(k): v for k, v in stored.items()})
    port = _port_state(point)
    load_train_state(tmp_path / "ck.npz", port)
    for tree, port_tree in ((jstate.params,
                             models_to_jax_params(port.models)),
                            (jstate.model_state,
                             models_to_jax_state(port.models))):
        got = jax_params_to_torch(port_tree)
        for k, v in jax_params_to_torch(tree).items():
            assert torch.equal(got[k], v), k
    assert port.step == 1


@pytest.fixture(scope="module")
def model_dir(point, tmp_path_factory):
    """A batch-norm model folder with non-trivial moving statistics."""
    folder = tmp_path_factory.mktemp("bn_model")
    namespace2yaml(folder / "model_config.yaml", CFG)
    params, state = point[:2]
    jax_checkpoint.save_pytree(folder / "checkpoint.npz",
                               {"params": params, "model_state": state})
    return folder


@pytest.mark.parametrize("tpu_layout", [False, True])
def test_session_serves_moving_statistics_as_jax(model_dir, tpu_layout):
    image = np.random.default_rng(0).integers(0, 256, (2, 32, 32, 3),
                                              dtype=np.uint8)
    port = InferenceSession(model_dir, "float32", tpu_layout=tpu_layout,
                            device="cpu")
    want = JaxSession(model_dir, "float32").stylize(image, "b2a")
    got = port.stylize(image, "b2a")
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1
    # the session's statistics are the checkpoint's, and a batch-statistics
    # forward would differ
    with layout.nhcw(tpu_layout), norm_ops.batch_stats(True):
        x = torch.from_numpy(image).float() / 127.5 - 1
        x = layout.to_nhcw(x) if tpu_layout else x
        with torch.no_grad():
            y = port.models["g_BA"](x)
    assert not np.allclose(
        (layout.from_nhcw(y) if tpu_layout else y).numpy(),
        got / 127.5 - 1, atol=0.05)


def test_bf16_session_keeps_statistics_f32(model_dir):
    session = InferenceSession(model_dir, "bfloat16", device="cpu")
    model = session.models["g_AB"]
    assert {p.dtype for p in model.parameters()} == {torch.bfloat16}
    assert {b.dtype for b in model.buffers()} == {torch.float32}
    want = jax_params_to_torch(
        jax_checkpoint.load_pytree(model_dir / "checkpoint.npz",
                                   {"model_state": {"g_AB": jax.device_get(
                                       jax_create_model(GEN).init(
                                           jax.random.PRNGKey(0))[1])}})
        ["model_state"]["g_AB"])
    for k, b in model.named_buffers():
        assert torch.equal(b, want[k]), k
    out = session.stylize(np.zeros((1, 32, 32, 3), np.uint8))
    assert out.shape == (1, 32, 32, 3)


def test_trainer_predicts_on_moving_statistics(model_dir, tmp_path):
    """``CycleGan.predict`` (and so its sample images) serves the moving
    statistics, as the session does."""
    from cyclegan_tpu_torch.trainer import CycleGan

    cfg = model_config("bn_trainer", tmp_path)
    train = copy.deepcopy(TRAIN)
    train.compute_dtype = "float32"
    gan = CycleGan(cfg, train, device="cpu")
    load_jax_params(gan.state.models, *(
        jax_checkpoint.load_pytree(model_dir / "checkpoint.npz",
                                   {"params": models_to_jax_params(
                                       gan.state.models),
                                    "model_state": models_to_jax_state(
                                        gan.state.models)}).values()))
    image = np.random.default_rng(3).integers(0, 256, (2, 32, 32, 3),
                                              dtype=np.uint8)
    got = gan.predict(image, "a2b")
    session = InferenceSession(model_dir, "float32", tpu_layout=False,
                               device="cpu")
    want = session.stylize(image, "a2b")
    assert np.abs(np.clip((got + 1) * 127.5, 0, 255).round()
                  - want).max() <= 1
