"""The port's train and validate steps against the JAX package's, on the CPU.

Default-recipe widths (generators 16/32/64/128 all k4, discriminators
16/32/64 at k7/k5/k3, configs/cycle.yaml) at 32x32, batch 2, from one numpy
parameter tree carried into both packages.

The test point. Two f32 implementations of a ReLU network whose forwards
differ by rounding (~1e-7 relative) disagree about the side of the kink
for any ReLU input within that distance of zero, and each such element
moves the gradient by far more than 1e-4 at this size: at the init point,
where beta = 0 puts the kink in the middle of every channel, a 1e-6
relative change of the input moves the port's own discriminator gradient
by over 1e-3 (``test_test_point_keeps_the_gradient_off_the_kinks``). The
f32 bound of 1e-4 per leaf is therefore checked where it is defined: every
instance norm's beta is drawn at +-(3..4), so whole channels sit on either
side of the kink, and ``test_f32_point_is_kink_free`` asserts that no ReLU
input of the port's f32 forward lies within 1e-5 of zero.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cyclegan_tpu import steps as jax_steps
from cyclegan_tpu.losses import get_loss_obj as jax_loss_obj
from cyclegan_tpu.models import create_model as jax_create_model
from cyclegan_tpu.optimizers import get_optimizer as jax_get_optimizer
from cyclegan_tpu_torch import steps
from cyclegan_tpu_torch.config import yaml2namespace
from cyclegan_tpu_torch.losses import get_losses
from cyclegan_tpu_torch.ops import cuda_norm_act, layout
from cyclegan_tpu_torch.weights import (
    jax_params_to_torch,
    load_jax_params,
    models_to_jax_params,
)

CFG = yaml2namespace("configs/cycle.yaml")
TRAIN = yaml2namespace("configs/training_config.yaml")
WEIGHTS = {k: float(v) for k, v in CFG.loss_weights.items()}
NETWORKS = steps.NETWORKS
KINK_MARGIN = 1e-5


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


def _shift_affine(tree, rng):
    """beta at +-(3..4), gamma at 1 +- 0.2, biases at N(0, 0.1), in place."""
    if isinstance(tree, list):
        for v in tree:
            _shift_affine(v, rng)
        return
    for k, v in tree.items():
        if k == "beta":
            tree[k] = (rng.choice([-1.0, 1.0], v.shape)
                       * rng.uniform(3.0, 4.0, v.shape)).astype(np.float32)
        elif k == "gamma":
            tree[k] = (1.0 + 0.2 * rng.normal(size=v.shape)).astype(
                np.float32)
        elif k == "b":
            tree[k] = (0.1 * rng.normal(size=v.shape)).astype(np.float32)
        elif isinstance(v, (dict, list)):
            _shift_affine(v, rng)


@pytest.fixture(scope="module")
def point():
    """(params tree of numpy, real_a, real_b, JAX models, JAX model state)."""
    params = models_to_jax_params(steps.build_models(CFG, seed=0))
    _shift_affine(params, np.random.default_rng(11))
    real_a = np.random.default_rng(2).uniform(
        -1, 1, (2, 32, 32, 3)).astype(np.float32)
    real_b = np.random.default_rng(3).uniform(
        -1, 1, (2, 32, 32, 3)).astype(np.float32)
    models = {n: jax_create_model(CFG.generator if n.startswith("g")
                                  else CFG.discriminator) for n in NETWORKS}
    state = {n: jax.eval_shape(models[n].init, jax.random.PRNGKey(0))[1]
             for n in NETWORKS}
    return params, real_a, real_b, models, state


def _port_state(params, device="cpu"):
    models = steps.build_models(CFG, seed=0)
    load_jax_params(models, params)
    return steps.init_train_state(models, TRAIN, device=device)


def _flat(tree):
    """A network's tree -> {state_dict key: numpy}."""
    return {k: v.numpy() for k, v in
            jax_params_to_torch(jax.tree.map(np.asarray, tree)).items()}


def _port_grads(models, real_a, real_b, dtype):
    """(grads {net: {key: numpy}}, metrics) of the single-backward
    surrogate, as the train step computes them."""
    surrogate, metrics = steps._forward_losses(
        models, get_losses(CFG.loss), WEIGHTS, torch.from_numpy(real_a),
        torch.from_numpy(real_b), dtype, stop_grads=True)
    named = {n: list(models[n].named_parameters()) for n in NETWORKS}
    values = iter(torch.autograd.grad(
        surrogate, [p for n in NETWORKS for _, p in named[n]]))
    grads = {n: {k: next(values).numpy() for k, _ in named[n]}
             for n in NETWORKS}
    return grads, {k: float(v.detach()) for k, v in metrics.items()}


def _jax_surrogate(point, dtype):
    params, real_a, real_b, models, state = point

    def surrogate(p):
        total, metrics, _ = jax_steps._forward_losses(
            p, state, models, jax_loss_obj(CFG.loss), WEIGHTS,
            jnp.asarray(real_a), jnp.asarray(real_b), train=True, rng=None,
            stop_grads=True, compute_dtype=dtype)
        return total, metrics

    (_, metrics), grads = jax.value_and_grad(surrogate, has_aux=True)(
        jax.tree.map(jnp.asarray, params))
    return ({n: _flat(grads[n]) for n in NETWORKS},
            {k: float(v) for k, v in metrics.items()})


@pytest.fixture(scope="module")
def port_f32(point):
    """The port's f32 gradients and metrics, with the smallest |ReLU input|
    its forward met."""
    params, real_a, real_b, _, _ = point
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

    cuda_norm_act.instance_norm_act_plain = recording
    try:
        grads, metrics = _port_grads(_port_state(params).models, real_a,
                                     real_b, torch.float32)
    finally:
        cuda_norm_act.instance_norm_act_plain = plain
    return grads, metrics, min(nearest)


@pytest.fixture(scope="module")
def jax_f32(point):
    return _jax_surrogate(point, jnp.float32)


@pytest.fixture(scope="module")
def jax_reference(point):
    params, real_a, real_b, models, state = point
    grads = jax_steps.reference_gradients(
        models, CFG.loss, WEIGHTS, jax.tree.map(jnp.asarray, params), state,
        jnp.asarray(real_a), jnp.asarray(real_b))
    return {n: _flat(grads[n]) for n in NETWORKS}


def _rel(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _assert_leaves_close(got, want, bound):
    worst = {}
    for n in NETWORKS:
        assert got[n].keys() == want[n].keys()
        for k in want[n]:
            worst[f"{n}.{k}"] = _rel(got[n][k], want[n][k])
    leaf = max(worst, key=worst.get)
    assert worst[leaf] <= bound, (leaf, worst[leaf])


def test_f32_point_is_kink_free(port_f32):
    assert port_f32[2] > KINK_MARGIN


def _input_sensitivity(params):
    """Relative changes of d_A's parameter gradient under three 1e-6
    relative perturbations of its input."""
    model = _port_state(params).models["d_A"]
    x = np.random.default_rng(2).uniform(-1, 1, (2, 32, 32, 3)).astype(
        np.float32)

    def grads(x):
        y = model(torch.from_numpy(np.ascontiguousarray(
            x.transpose(0, 1, 3, 2))))
        return torch.cat([g.reshape(-1) for g in torch.autograd.grad(
            torch.mean(y ** 2), list(model.parameters()))]).numpy()

    base = grads(x)
    return [_rel(grads((x * (1 + 1e-6 * np.random.default_rng(10 + s)
                             .normal(size=x.shape))).astype(np.float32)),
                 base) for s in range(3)]


def test_test_point_keeps_the_gradient_off_the_kinks(point):
    """At the init point a rounding-sized change of the input flips a ReLU
    decision and moves the gradient by over 1e-3; at the test point it
    moves it by rounding only."""
    init = models_to_jax_params(steps.build_models(CFG, seed=0))
    assert max(_input_sensitivity(init)) > 1e-3
    assert max(_input_sensitivity(point[0])) < 1e-5


def test_f32_gradients_match_jax_reference_gradients(port_f32,
                                                     jax_reference):
    """The port's one backward against JAX's naive four backwards."""
    _assert_leaves_close(port_f32[0], jax_reference, 1e-4)


def test_f32_gradients_match_jax_train_step_gradients(port_f32, jax_f32):
    """... and against the gradient of JAX's train-step surrogate."""
    _assert_leaves_close(port_f32[0], jax_f32[0], 1e-4)


def test_f32_metrics_match_jax(port_f32, jax_f32):
    assert port_f32[1].keys() == jax_f32[1].keys()
    for k, want in jax_f32[1].items():
        assert abs(port_f32[1][k] - want) <= 1e-5 * abs(want), k


def test_port_single_backward_equals_its_reference_gradients(point,
                                                             port_f32):
    """Same forward, same ReLU masks: the surrogate's per-network gradient
    is the reference's four backwards up to f32 summation order."""
    params, real_a, real_b, _, _ = point
    state = _port_state(params)
    ref = steps.reference_gradients(state.models, CFG.loss, WEIGHTS,
                                    torch.from_numpy(real_a),
                                    torch.from_numpy(real_b))
    _assert_leaves_close(
        port_f32[0], {n: {k: v.numpy() for k, v in ref[n].items()}
                      for n in NETWORKS}, 1e-5)


def test_train_step_leaves_the_surrogate_gradients(point, port_f32):
    params, real_a, real_b, _, _ = point
    state = _port_state(params)
    step = steps.make_train_step(CFG.loss, CFG.loss_weights)
    metrics = step(state, torch.from_numpy(real_a), torch.from_numpy(real_b))
    assert state.step == 1
    assert set(metrics) == {"gAB_loss", "gBA_loss", "dA_loss", "dB_loss",
                            "dA_acc", "dB_acc"}
    got = {n: {k: p.grad.numpy() for k, p in
               state.models[n].named_parameters()} for n in NETWORKS}
    _assert_leaves_close(got, port_f32[0], 1e-6)


def test_two_adam_steps_match_jax(point):
    """Parameters after two steps within 1e-5 for >= 99.99% of entries;
    an entry outside has a gradient below 1e-6 at one of the steps, where
    Adam's update g / (sqrt(v) + 1e-7) turns on rounding."""
    params, real_a, real_b, models, state = point
    port = _port_state(params)
    port_step = steps.make_train_step(CFG.loss, CFG.loss_weights)
    small = {n: {k: np.zeros(p.shape, bool) for k, p in
                 port.models[n].named_parameters()} for n in NETWORKS}
    for _ in range(2):
        port_step(port, torch.from_numpy(real_a), torch.from_numpy(real_b))
        for n in NETWORKS:
            for k, p in port.models[n].named_parameters():
                small[n][k] |= p.grad.abs().numpy() < 1e-6

    optimizers = {n: jax_get_optimizer(TRAIN.g_opt if n.startswith("g")
                                       else TRAIN.d_opt) for n in NETWORKS}
    jparams = jax.tree.map(jnp.asarray, params)
    jstate = jax_steps.TrainState(
        params=jparams, model_state=state,
        opt_state={n: optimizers[n].init(jparams[n]) for n in NETWORKS},
        rng=jax.random.PRNGKey(0), step=jnp.zeros((), jnp.int32))
    jax_step = jax_steps.make_train_step(models, optimizers, CFG.loss,
                                         WEIGHTS, donate=False).__wrapped__
    for _ in range(2):
        jstate, _ = jax_step(jstate, jnp.asarray(real_a),
                             jnp.asarray(real_b))

    total = outside = 0
    for n in NETWORKS:
        want = _flat(jstate.params[n])
        for k, p in port.models[n].named_parameters():
            far = np.abs(p.detach().numpy() - want[k]) > 1e-5
            total += far.size
            outside += int(far.sum())
            assert not (far & ~small[n][k]).any(), (n, k)
    assert outside <= 1e-4 * total, (outside, total)


def test_bf16_gradients_match_jax_bf16(point, port_f32, jax_f32):
    """Per network: cosine >= 0.99 against JAX's bf16 gradient, and the
    distance from the f32 gradient at most 1.5x JAX's own bf16 one."""
    params, real_a, real_b, _, _ = point
    port16, _ = _port_grads(_port_state(params).models, real_a, real_b,
                            torch.bfloat16)
    jax16, _ = _jax_surrogate(point, jnp.bfloat16)
    for n in NETWORKS:
        keys = sorted(jax_f32[0][n])

        def vec(g):
            return np.concatenate([g[n][k].ravel() for k in keys])

        ref, p16, j16 = vec(jax_f32[0]), vec(port16), vec(jax16)
        cos = p16 @ j16 / (np.linalg.norm(p16) * np.linalg.norm(j16))
        assert cos >= 0.99, (n, cos)
        assert _rel(p16, ref) <= 1.5 * _rel(j16, ref), (
            n, _rel(p16, ref), _rel(j16, ref))


def test_validate_metrics_match_jax(point, jax_f32):
    params, real_a, real_b, models, state = point
    port = _port_state(params)
    got = steps.make_validate_step(CFG.loss, CFG.loss_weights)(
        port, torch.from_numpy(real_a), torch.from_numpy(real_b))
    jstate = jax_steps.TrainState(
        params=jax.tree.map(jnp.asarray, params), model_state=state,
        opt_state={}, rng=jax.random.PRNGKey(0),
        step=jnp.zeros((), jnp.int32))
    want = jax_steps.make_validate_step(models, CFG.loss, WEIGHTS).__wrapped__(
        jstate, jnp.asarray(real_a), jnp.asarray(real_b))
    for k in want:
        assert abs(float(got[k]) - float(want[k])) <= 1e-5 * abs(
            float(want[k])), k
    # without stop-gradients the two fake views are one application, so
    # the validation metrics are the train step's forward
    for k in jax_f32[1]:
        assert abs(float(got[k]) - jax_f32[1][k]) <= 1e-5 * abs(
            jax_f32[1][k]), k


@pytest.mark.parametrize("w_gen,w_d", [(1.0, 0.0), (0.0, 1.0), (0.7, 1.3)])
def test_dual_view_routing_matches_jax(point, w_gen, w_d):
    """steps.disc_views (two applications) routes the generator-view
    cotangent only into the input and the discriminator-view cotangent
    only into the parameters, as JAX's shared-forward
    ``_dual_disc_views``."""
    params, real_a, _, models, state = point
    d = models["d_A"]

    def d_apply(p, x):
        return d.apply(p, state["d_A"], x, train=True)

    def loss_dual(p, x):
        y_gen, y_d, _ = jax_steps._dual_disc_views(d_apply, p, x)
        return w_gen * jnp.sum(y_gen ** 2) + w_d * jnp.sum((y_d - 1.0) ** 2)

    x_nhcw = np.ascontiguousarray(real_a.transpose(0, 1, 3, 2))
    ref_p, ref_x = jax.grad(loss_dual, argnums=(0, 1))(
        jax.tree.map(jnp.asarray, params["d_A"]),
        jnp.asarray(real_a))
    model = _port_state(params).models["d_A"]
    named = dict(model.named_parameters())
    x = torch.from_numpy(x_nhcw).requires_grad_(True)
    y_gen, y_d = steps.disc_views(model, named, x)
    loss = w_gen * torch.sum(y_gen ** 2) + w_d * torch.sum((y_d - 1.0) ** 2)
    got = torch.autograd.grad(loss, [x] + list(named.values()))
    got_x, got_p = got[0].numpy(), dict(zip(named, got[1:]))
    for k, want in _flat(ref_p).items():
        if w_d == 0.0:  # the generator view leaves the parameters alone
            assert not got_p[k].any() and not want.any(), k
        else:
            assert _rel(got_p[k].numpy(), want) <= 1e-4, k
    want_x = np.asarray(ref_x).transpose(0, 1, 3, 2)
    if w_gen == 0.0:  # the discriminator view leaves the input alone
        assert not got_x.any() and not want_x.any()
    else:
        assert _rel(got_x, want_x) <= 1e-4


def test_train_state_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        steps.init_train_state(steps.build_models(CFG), TRAIN)
