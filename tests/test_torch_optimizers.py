"""The port's RMSprop, SGD and AdaBelief against the JAX package's optax
transforms (``cyclegan_tpu.optimizers``), on the CPU.

Step for step over ten steps of seeded gradients, f32: rtol 1e-6, atol
1e-7. The scalar terms of AdaBelief (bias corrections, RAdam's r_t) are
taken in f32 on both sides; RMSprop's and SGD's updates are the same
elementwise expressions. The AdaBelief golden trajectory of
``tests/test_tf_parity.py::test_adabelief_golden_trajectory`` (literal
inputs and the weights after steps 1, 4, 6 and 8 of adabelief-tf's
algorithm at b2 = 0.99, computed in f64 there) is replayed against the
port within that test's own bounds, rtol 1e-6 and atol 1e-6.
"""

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from cyclegan_tpu.optimizers import adabelief_tf_update
from cyclegan_tpu.optimizers import get_optimizer as jax_get_optimizer
from cyclegan_tpu_torch.optimizers import AdaBeliefTF, get_optimizer

SHAPES = [(4, 4, 3, 16), (16,), (1, 1, 32, 3)]


def _run(opt, tx, rng, steps=10, grad_scale=1.0):
    """Ten steps of seeded gradients (times ``grad_scale``) through the
    torch optimizer ``opt`` (over parameters made by the caller) and the
    optax ``tx``; yields the two parameter lists after each step."""
    params = [p for group in opt.param_groups for p in group["params"]]
    jparams = [jnp.asarray(p.detach().numpy().copy()) for p in params]
    state = tx.init(jparams)
    for _ in range(steps):
        grads = [(grad_scale * rng.normal(size=p.shape)).astype(np.float32)
                 for p in params]
        for p, g in zip(params, grads):
            p.grad = torch.from_numpy(g)
        opt.step()
        updates, state = tx.update([jnp.asarray(g) for g in grads], state,
                                   jparams)
        jparams = optax.apply_updates(jparams, updates)
        yield params, jparams


@pytest.mark.parametrize("config", [
    dict(name="rmsprop", learning_rate=1e-3),
    dict(name="sgd", learning_rate=1e-2),
    dict(name="adabelief", learning_rate=2e-4),
], ids=lambda c: c["name"])
def test_matches_optax_step_for_step(config):
    rng = np.random.default_rng(9)
    params = [torch.nn.Parameter(torch.from_numpy(
        (0.02 * rng.normal(size=s)).astype(np.float32))) for s in SHAPES]
    opt = get_optimizer(config, params)
    for got, want in _run(opt, jax_get_optimizer(config), rng):
        for p, j in zip(got, want):
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(j),
                                       rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("rectify,grad_scale", [
    (True, 1.0), (False, 1.0), (True, 1e-7)])
def test_adabelief_at_b2_099_matches_adabelief_tf_update(rectify,
                                                         grad_scale):
    """b2 = 0.99 moves the gate to step 6 within the ten steps; without
    rectification the update is Adam-like from the first step. Gradients
    of 1e-7 make (g - m)^2 (1 - b2) of order 1e-16, so the eps of 1e-14
    that adabelief-tf adds inside the s EMA dominates s: there the EMA's
    eps is seen, where gradients of order 1 round it away."""
    rng = np.random.default_rng(10)
    params = [torch.nn.Parameter(torch.from_numpy(
        (0.02 * rng.normal(size=s)).astype(np.float32))) for s in SHAPES]
    opt = AdaBeliefTF(params, lr=1e-2, b2=0.99, rectify=rectify)
    tx = adabelief_tf_update(1e-2, b2=0.99, rectify=rectify)
    for got, want in _run(opt, tx, rng, grad_scale=grad_scale):
        for p, j in zip(got, want):
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(j),
                                       rtol=1e-6, atol=1e-7)


# tests/test_tf_parity.py::test_adabelief_golden_trajectory: lr 1e-2,
# b2 0.99, these weights and gradients, and the weights after steps 1
# (fallback), 4 (fallback), 6 (the gate opens) and 8 (rectified)
GOLDEN_W0 = [0.5, -0.25, 1.0]
GOLDEN_GRADS = [[0.1, -0.2, 0.3], [-0.05, 0.15, 0.25], [0.2, 0.1, -0.1],
                [0.0, -0.3, 0.2], [0.12, 0.08, -0.22], [-0.18, 0.05, 0.09],
                [0.07, -0.11, 0.13], [0.03, 0.21, -0.04]]
GOLDEN = {
    1: [0.499, -0.248, 0.997],
    4: [0.4973010035742, -0.2474301752526, 0.9913605892471],
    6: [0.4963965175109, -0.2470364003780, 0.9904334200574],
    8: [0.4957610165036, -0.2468877166106, 0.9895309382248],
}


@pytest.mark.parametrize("t", sorted(GOLDEN))
def test_adabelief_golden_trajectory(t):
    w = torch.nn.Parameter(torch.tensor(GOLDEN_W0, dtype=torch.float32))
    opt = AdaBeliefTF([w], lr=1e-2, b2=0.99)
    for g in GOLDEN_GRADS[:t]:
        w.grad = torch.tensor(g, dtype=torch.float32)
        opt.step()
    np.testing.assert_allclose(w.detach().numpy(), GOLDEN[t], rtol=1e-6,
                               atol=1e-6)


def test_adabelief_gate_is_host_arithmetic():
    """The scalar terms come from the host step count: shut through step
    5 and open from step 6 at b2 = 0.99, as adabelief-tf's sma_t >= 5."""
    gates = [AdaBeliefTF.coefficients(t, 0.9, 0.99, True, 5.0)[2]
             is not None for t in range(1, 9)]
    assert gates == [False] * 5 + [True] * 3


def test_optimizer_classes_and_hyperparameters():
    p = [torch.nn.Parameter(torch.zeros(2))]
    rms = get_optimizer(dict(name="rmsprop", learning_rate=1e-3), p)
    assert isinstance(rms, torch.optim.RMSprop)
    group = rms.param_groups[0]
    assert (group["alpha"], group["eps"], group["momentum"],
            group["centered"]) == (0.9, 1e-7, 0, False)
    sgd = get_optimizer(dict(name="sgd", learning_rate=1e-3), p)
    assert isinstance(sgd, torch.optim.SGD)
    assert sgd.param_groups[0]["momentum"] == 0
    ada = get_optimizer(dict(name="adabelief", learning_rate=1e-3), p)
    assert isinstance(ada, AdaBeliefTF)
    assert {k: ada.param_groups[0][k] for k in
            ("b1", "b2", "eps", "rectify", "sma_threshold")} == dict(
        b1=0.9, b2=0.999, eps=1e-14, rectify=True, sma_threshold=5.0)
