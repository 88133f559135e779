"""The port's losses and optimizers against the JAX package's, on the CPU."""

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from cyclegan_tpu import losses as jax_losses
from cyclegan_tpu_torch import losses
from cyclegan_tpu_torch.optimizers import get_optimizer

ADAM = dict(name="adam", learning_rate=2e-4, beta_1=0.5)


def _pair(shape, seed, low=-1.0, high=1.0):
    a = np.random.default_rng(seed).uniform(low, high, shape).astype(
        np.float32)
    return jnp.asarray(a), torch.from_numpy(a)


@pytest.mark.parametrize("name", ["mse", "mae", "bce"])
def test_adversarial_losses_match_jax(name):
    (jt, tt), (jp, tp) = _pair((2, 8, 8, 1), 0, 0, 1), _pair((2, 8, 8, 1), 1,
                                                            -4, 4)
    want = float(jax_losses.get_loss_obj(name)(jt, jp))
    got = float(losses.get_loss_obj(name)(tt, tp))
    assert got == pytest.approx(want, rel=1e-6)


def test_unknown_loss_name_raises():
    with pytest.raises(KeyError):
        losses.get_loss_obj("hinge")


@pytest.mark.parametrize("name", ["mse", "mae", "bce"])
def test_generator_and_discriminator_losses_match_jax(name):
    (jr, tr), (jf, tf) = _pair((2, 8, 8, 1), 2, 0, 1), _pair((2, 8, 8, 1), 3,
                                                            0, 1)
    jobj, tobj = jax_losses.get_loss_obj(name), losses.get_loss_obj(name)
    assert float(losses.generator_loss(tf, tobj, 1.0)) == pytest.approx(
        float(jax_losses.generator_loss(jf, jobj, 1.0)), rel=1e-6)
    assert float(losses.discriminator_loss(tr, tf, tobj, 0.5)) == \
        pytest.approx(float(jax_losses.discriminator_loss(jr, jf, jobj, 0.5)),
                      rel=1e-6)


def test_cycle_identity_and_accuracy_match_jax():
    (ja, ta), (jb, tb) = _pair((2, 8, 8, 3), 4), _pair((2, 8, 8, 3), 5)
    assert float(losses.calc_cycle_loss(ta, tb, 2.0)) == pytest.approx(
        float(jax_losses.calc_cycle_loss(ja, jb, 2.0)), rel=1e-6)
    assert float(losses.identity_loss(ta, tb, 0.5)) == pytest.approx(
        float(jax_losses.identity_loss(ja, jb, 0.5)), rel=1e-6)
    (jr, tr), (jf, tf) = _pair((2, 8, 8, 1), 6, 0, 1), _pair((2, 8, 8, 1), 7,
                                                            0, 1)
    assert float(losses.accuracy(tr, tf)) == float(
        jax_losses.accuracy(jr, jf))


def test_adam_matches_optax_step_for_step():
    """lr 2e-4, b1 0.5, b2 0.999, eps 1e-7, over five steps of seeded
    gradients. Each step may round a parameter one f32 ulp apart, and
    optax takes the bias correction 1 - 0.999^t in f32 (1.3e-5 off at
    t = 1) where torch takes it in doubles: over five steps, within 8 ulps
    (rtol 1e-6) plus 5e-5 of one 2e-4 step (atol 1e-8)."""
    rng = np.random.default_rng(8)
    shapes = [(4, 4, 3, 16), (16,), (1, 1, 32, 3)]
    init = [rng.normal(size=s).astype(np.float32) * 0.02 for s in shapes]
    params = [torch.nn.Parameter(torch.from_numpy(a.copy())) for a in init]
    opt = get_optimizer(ADAM, params)
    tx = optax.adam(2e-4, b1=0.5, b2=0.999, eps=1e-7)
    jparams = [jnp.asarray(a) for a in init]
    state = tx.init(jparams)
    for _ in range(5):
        grads = [rng.normal(size=s).astype(np.float32) for s in shapes]
        for p, g in zip(params, grads):
            p.grad = torch.from_numpy(g)
        opt.step()
        updates, state = tx.update([jnp.asarray(g) for g in grads], state,
                                   jparams)
        jparams = optax.apply_updates(jparams, updates)
        for p, j in zip(params, jparams):
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(j),
                                       rtol=1e-6, atol=1e-8)


def test_adam_takes_keras_epsilon():
    opt = get_optimizer(ADAM, [torch.nn.Parameter(torch.zeros(2))])
    group = opt.param_groups[0]
    assert group["eps"] == 1e-7 and group["betas"] == (0.5, 0.999)
    assert group["lr"] == 2e-4


def test_unknown_optimizer_raises_as_jax():
    with pytest.raises(ValueError, match="not found"):
        get_optimizer(dict(name="lamb", learning_rate=1e-3),
                      [torch.nn.Parameter(torch.zeros(2))])
