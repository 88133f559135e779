"""Train-state checkpoints of every optimizer crossing between the port and
the JAX package, on the CPU.

For adam, rmsprop, sgd and adabelief (``g_opt`` and ``d_opt`` alike) a
checkpoint written by one package after two updates of seeded gradients is
loaded by the other: its optimizer state must equal the writer's leaf for
leaf, exactly (f32 and int32 leaves are copied), with optax's own leaves
(adam ``0/count``, ``0/mu``, ``0/nu``; rmsprop ``0/nu`` only; sgd none;
adabelief ``count``, ``m``, ``s``). Then one more update of the same
gradients on each side must leave equal parameters: rtol 1e-6 and atol
1e-7, the bounds of ``tests/test_torch_optimizers.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from cyclegan_tpu import steps as jax_steps
from cyclegan_tpu.models import create_model as jax_create_model
from cyclegan_tpu.optimizers import get_optimizer as jax_get_optimizer
from cyclegan_tpu.utils.checkpoint import _path_str
from cyclegan_tpu.utils.checkpoint import load_pytree as jax_load_pytree
from cyclegan_tpu.utils.checkpoint import save_pytree as jax_save_pytree
from cyclegan_tpu_torch import steps
from cyclegan_tpu_torch.utils.checkpoint import (
    DROPOUT_GENERATOR_KEY,
    GENERATOR_KEY,
    load_train_state,
    optimizer_tree,
    save_train_state,
)
from cyclegan_tpu_torch.weights import (
    jax_params_to_torch,
    models_to_jax_params,
)

NETWORKS = steps.NETWORKS
UNET = dict(type="unet_generator", filters=[4, 4], kernels=[3, 3],
            expansion="upsample", normalization="instancenorm", dropout=False)
CFG = dict(generator=dict(UNET, output_channels=3, final_activation="tanh"),
           discriminator=dict(UNET, output_channels=1,
                              final_activation="sigmoid"))
OPTIMIZERS = {
    "adam": dict(name="adam", learning_rate=2e-4, beta_1=0.5),
    "rmsprop": dict(name="rmsprop", learning_rate=1e-3),
    "sgd": dict(name="sgd", learning_rate=1e-2),
    "adabelief": dict(name="adabelief", learning_rate=2e-4),
}
LEAVES = {"adam": ["0/count", "0/mu", "0/nu"], "rmsprop": ["0/nu"],
          "sgd": [], "adabelief": ["count", "m", "s"]}


def _gradients(params, seed):
    """Seeded f32 gradients in the shape of a JAX parameter tree."""
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda leaf: rng.normal(size=np.shape(leaf)).astype(np.float32),
        params)


def _jax_state(params, name):
    models = {n: jax_create_model(CFG["generator"] if n.startswith("g")
                                  else CFG["discriminator"])
              for n in NETWORKS}
    tx = jax_get_optimizer(OPTIMIZERS[name])
    jparams = jax.tree.map(jnp.asarray, params)
    return tx, jax_steps.TrainState(
        params=jparams,
        model_state={n: jax.eval_shape(models[n].init,
                                       jax.random.PRNGKey(0))[1]
                     for n in NETWORKS},
        opt_state={n: tx.init(jparams[n]) for n in NETWORKS},
        rng=jax.random.PRNGKey(5), step=jnp.zeros((), jnp.int32))


def _jax_update(tx, state, seed):
    grads = _gradients(jax.tree.map(np.asarray, state.params), seed)
    params, opt_state = {}, {}
    for n in NETWORKS:
        updates, opt_state[n] = tx.update(
            jax.tree.map(jnp.asarray, grads[n]), state.opt_state[n],
            state.params[n])
        params[n] = optax.apply_updates(state.params[n], updates)
    return jax_steps.TrainState(params=params, model_state=state.model_state,
                                opt_state=opt_state, rng=state.rng,
                                step=state.step + 1)


def _port_state(name):
    config = {"g_opt": OPTIMIZERS[name], "d_opt": OPTIMIZERS[name]}
    return steps.init_train_state(steps.build_models(CFG, seed=0), config,
                                  seed=3, device="cpu")


def _port_update(state, seed):
    grads = _gradients(models_to_jax_params(state.models), seed)
    for n in NETWORKS:
        flat = jax_params_to_torch(grads[n])
        for key, p in state.models[n].named_parameters():
            p.grad = flat[key]
        state.optimizers[n].step()
    state.step += 1


def _leaves(tree):
    """{path as the JAX checkpoint writes it: leaf}"""
    return {_path_str(path): np.asarray(leaf) for path, leaf in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


def _assert_opt_states_equal(port_state, jax_state):
    for n in NETWORKS:
        got = _leaves(optimizer_tree(port_state.models[n],
                                     port_state.optimizers[n]))
        want = _leaves(jax.tree.map(np.asarray, jax_state.opt_state[n]))
        assert got.keys() == want.keys(), (n, sorted(got), sorted(want))
        for key, w in want.items():
            np.testing.assert_array_equal(got[key], w, err_msg=f"{n} {key}")


def _assert_params_close(port_state, jax_state):
    for n in NETWORKS:
        want = jax_params_to_torch(jax.tree.map(np.asarray,
                                                jax_state.params[n]))
        for key, p in port_state.models[n].named_parameters():
            np.testing.assert_allclose(p.detach().numpy(), want[key].numpy(),
                                       rtol=1e-6, atol=1e-7,
                                       err_msg=f"{n} {key}")


def _assert_stored_keys(path, tx, params, name):
    """The checkpoint's optimizer keys of one network are the ones JAX
    writes for that optimizer, under optax's slot names."""
    with np.load(path) as data:
        stored = sorted(k for k in data.files
                        if k.startswith("opt_state/g_AB/"))
    want = sorted("opt_state/g_AB/" + k for k in _leaves(
        tx.init(jax.tree.map(jnp.asarray, params["g_AB"]))))
    assert stored == want
    assert {k.split("/")[2] if k.split("/")[2] != "0" else
            "0/" + k.split("/")[3] for k in stored} == set(LEAVES[name])


@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_jax_checkpoint_resumes_in_the_port(tmp_path, name):
    port = _port_state(name)
    params = models_to_jax_params(port.models)
    tx, jstate = _jax_state(params, name)
    for seed in (1, 2):
        jstate = _jax_update(tx, jstate, seed)
    jax_save_pytree(tmp_path / "checkpoint.npz", jstate)
    _assert_stored_keys(tmp_path / "checkpoint.npz", tx, params, name)

    rng = load_train_state(tmp_path / "checkpoint.npz", port)
    assert port.step == 2
    np.testing.assert_array_equal(rng, np.asarray(jstate.rng))
    _assert_opt_states_equal(port, jstate)
    _assert_params_close(port, jstate)
    _port_update(port, 3)
    _assert_params_close(port, _jax_update(tx, jstate, 3))


@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_port_checkpoint_resumes_in_jax(tmp_path, name):
    port = _port_state(name)
    params = models_to_jax_params(port.models)
    for seed in (1, 2):
        _port_update(port, seed)
    save_train_state(tmp_path / "checkpoint.npz", port,
                     np.array([0, 5], np.uint32))
    with np.load(tmp_path / "checkpoint.npz") as data:
        assert {GENERATOR_KEY, DROPOUT_GENERATOR_KEY} <= set(data.files)
    tx, template = _jax_state(params, name)
    _assert_stored_keys(tmp_path / "checkpoint.npz", tx, params, name)
    jstate = jax_load_pytree(tmp_path / "checkpoint.npz",
                             jax.device_get(template))
    assert int(jstate.step) == 2
    _assert_opt_states_equal(port, jstate)
    _assert_params_close(port, jstate)
    _port_update(port, 3)
    _assert_params_close(port, _jax_update(
        tx, jax.tree.map(jnp.asarray, jstate), 3))

    # and back into a fresh port state: every slot, the step and both
    # generators exactly
    again = _port_state(name)
    load_train_state(tmp_path / "checkpoint.npz", again)
    _port_update(again, 3)
    for n in NETWORKS:
        mine = dict(port.models[n].named_parameters())
        for key, p in again.models[n].named_parameters():
            assert torch.equal(p, mine[key]), (n, key)
            for slot, value in again.optimizers[n].state[p].items():
                assert torch.equal(
                    value, port.optimizers[n].state[mine[key]][slot]), (
                    n, key, slot)
    assert torch.equal(again.dropout_generator.get_state(),
                       port.dropout_generator.get_state())
