"""K train steps per call (``steps.make_train_multi_step``, the JAX
trainer's ``steps_per_call``) and the trainer's remaining options on the
CPU: ``steps_per_call`` with a ragged tail, ``remat`` and ``fuse_apps``
passed through, ``profile_dir``, and a run with AdaBelief generators and
RMSprop discriminators that resumes exactly.

The tiny U-Net recipe of ``tests/test_torch_trainer.py`` at 16x16, batch
2. The multi step must equal K single steps bit for bit (the same body,
the same generator draws), and, from equal parameters without a
preprocess, JAX's ``make_train_multi_step`` within the bounds of
``tests/test_torch_steps.py``: every parameter within 1e-5 after the three
steps, or within 2 lr per step where a gradient fell below 1e-6 (Adam's
update turns on rounding there), at a point where every beta sits at
+-(3..4) so no ReLU decision flips.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cyclegan_tpu import steps as jax_steps
from cyclegan_tpu.models import create_model as jax_create_model
from cyclegan_tpu.optimizers import get_optimizer as jax_get_optimizer
from cyclegan_tpu_torch import steps
from cyclegan_tpu_torch.data.augment import random_jitter_batch
from cyclegan_tpu_torch.data.pipeline import ArrayDataset
from cyclegan_tpu_torch.trainer import PROFILE_FILE, CycleGan
from cyclegan_tpu_torch.weights import (
    jax_params_to_torch,
    load_jax_params,
    models_to_jax_params,
)
from tests.test_torch_steps import _shift_affine
from tests.test_torch_trainer import tiny_model_config, tiny_train_config

NETWORKS = steps.NETWORKS
K = 3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in several worker processes."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def point():
    cfg = tiny_model_config("unused")
    params = models_to_jax_params(steps.build_models(cfg, seed=0))
    _shift_affine(params, np.random.default_rng(11))
    rng = np.random.default_rng(5)
    a, b = (rng.uniform(-1, 1, (K, 2, 16, 16, 3)).astype(np.float32)
            for _ in range(2))
    return cfg, params, a, b


def _port_state(cfg, params):
    models = steps.build_models(cfg, seed=0)
    load_jax_params(models, params)
    return steps.init_train_state(models, tiny_train_config(), seed=7,
                                  device="cpu")


def _jitter(generator, a, b):
    return (random_jitter_batch(generator, a, 16),
            random_jitter_batch(generator, b, 16))


def test_multi_step_is_k_single_steps(point):
    cfg, params, a, b = point
    a8, b8 = (torch.from_numpy(((x + 1) * 127.5).astype(np.uint8))
              for x in (a, b))
    single, multi = _port_state(cfg, params), _port_state(cfg, params)
    step = steps.make_train_step(cfg.loss, cfg.loss_weights,
                                 preprocess=_jitter)
    want = [step(single, a8[i], b8[i]) for i in range(K)]
    got = steps.make_train_multi_step(cfg.loss, cfg.loss_weights,
                                      preprocess=_jitter)(multi, a8, b8)
    assert multi.step == single.step == K
    for k, v in got.items():
        assert v.shape == (K,)
        assert torch.equal(v, torch.stack([m[k] for m in want])), k
    for n in NETWORKS:
        for p, q in zip(multi.models[n].parameters(),
                        single.models[n].parameters()):
            assert torch.equal(p, q), n
    assert torch.equal(multi.generator.get_state(),
                       single.generator.get_state())


def test_multi_step_matches_jax_multi_step(point):
    cfg, params, a, b = point
    port = _port_state(cfg, params)
    metrics = steps.make_train_multi_step(cfg.loss, cfg.loss_weights)(
        port, torch.from_numpy(a), torch.from_numpy(b))
    # where a step's gradient fell below 1e-6, from the same steps run
    # singly (bit-identical, test_multi_step_is_k_single_steps)
    single = _port_state(cfg, params)
    small = {n: {k: np.zeros(p.shape, int) for k, p in
                 single.models[n].named_parameters()} for n in NETWORKS}
    step = steps.make_train_step(cfg.loss, cfg.loss_weights)
    for i in range(K):
        step(single, torch.from_numpy(a[i]), torch.from_numpy(b[i]))
        for n in NETWORKS:
            for k, p in single.models[n].named_parameters():
                small[n][k] += (p.grad.abs() < 1e-6).numpy()

    models = {n: jax_create_model(cfg.generator if n.startswith("g")
                                  else cfg.discriminator) for n in NETWORKS}
    optimizers = {n: jax_get_optimizer(tiny_train_config().g_opt)
                  for n in NETWORKS}
    jparams = jax.tree.map(jnp.asarray, params)
    jstate = jax_steps.TrainState(
        params=jparams,
        model_state={n: jax.eval_shape(models[n].init,
                                       jax.random.PRNGKey(0))[1]
                     for n in NETWORKS},
        opt_state={n: optimizers[n].init(jparams[n]) for n in NETWORKS},
        rng=jax.random.PRNGKey(0), step=jnp.zeros((), jnp.int32))
    jstate, want = jax_steps.make_train_multi_step(
        models, optimizers, cfg.loss, dict(cfg.loss_weights),
        donate=False)(jstate, jnp.asarray(a), jnp.asarray(b))
    assert metrics.keys() == want.keys()
    for k, v in want.items():
        assert np.shape(v) == metrics[k].shape == (K,)
        np.testing.assert_allclose(metrics[k].numpy(), np.asarray(v),
                                   rtol=1e-5, atol=1e-7, err_msg=k)
    lr = tiny_train_config().g_opt.learning_rate
    for n in NETWORKS:
        want = jax_params_to_torch(jax.tree.map(np.asarray,
                                                jstate.params[n]))
        for k, p in port.models[n].named_parameters():
            diff = np.abs(p.detach().numpy() - want[k].numpy())
            assert (diff <= 1e-5 + 2 * lr * small[n][k]).all(), (
                n, k, float(diff.max()))


def _dataset(n=10, size=16):
    """n images per domain, five train batches at batch 2, and one
    validation batch of the first 2."""
    rng = np.random.default_rng(3)
    a, b = (rng.integers(0, 256, size=(n, size, size, 3), dtype=np.uint8)
            for _ in range(2))
    return ArrayDataset(a, b, shuffle=True, seed=0), ArrayDataset(
        a[:2], b[:2], shuffle=False)


def _trained(tmp_path, label, **extra):
    gan = CycleGan(tiny_model_config(tmp_path / label),
                   tiny_train_config(**extra), device="cpu")
    gan.train(*_dataset())
    return gan


def _assert_same_state(a, b):
    for n in NETWORKS:
        other = dict(b.models[n].named_parameters())
        for key, p in a.models[n].named_parameters():
            assert torch.equal(p, other[key]), (n, key)
            mine = a.optimizers[n].state[p]
            theirs = b.optimizers[n].state[other[key]]
            assert mine.keys() == theirs.keys(), (n, key)
            for slot, value in mine.items():
                assert torch.equal(value, theirs[slot]), (n, key, slot)
    assert a.step == b.step
    for gen in ("generator", "dropout_generator"):
        assert torch.equal(getattr(a, gen).get_state(),
                           getattr(b, gen).get_state()), gen


def test_steps_per_call_with_a_ragged_tail(tmp_path):
    """Five batches at steps_per_call 2: two chunks and a single step,
    the same training as five single steps."""
    single = _trained(tmp_path, "single")
    chunked = _trained(tmp_path, "chunked", steps_per_call=2)
    assert chunked.multi_step_fn is not None
    assert single.state.step == chunked.state.step == 5
    assert chunked.history[0]["train_steps"] == 5
    _assert_same_state(single.state, chunked.state)
    assert single.history[0]["train"] == chunked.history[0]["train"]


def test_remat_and_fuse_apps_reach_the_steps(tmp_path):
    fused = _trained(tmp_path, "fused", fuse_apps=True)
    both = _trained(tmp_path, "both", fuse_apps=True, remat=True)
    assert (both.remat, both.fuse_apps) == (True, True)
    _assert_same_state(fused.state, both.state)
    plain = _trained(tmp_path, "plain")
    assert not torch.equal(next(plain.state.models["g_AB"].parameters()),
                           next(fused.state.models["g_AB"].parameters()))


def test_profile_dir_writes_a_trace(tmp_path):
    gan = _trained(tmp_path, "profiled", profile_dir=str(tmp_path / "prof"),
                   profile_steps=2, steps_per_call=2)
    trace = tmp_path / "prof" / PROFILE_FILE
    assert trace.stat().st_size > 0
    assert '"traceEvents"' in trace.read_text()
    assert gan.state.step == 5


def test_adabelief_and_rmsprop_train_and_resume(tmp_path):
    options = dict(g_opt=dict(name="adabelief", learning_rate=2e-4),
                   d_opt=dict(name="rmsprop", learning_rate=2e-4))
    train_config = tiny_train_config()
    train_config.update(options)
    gan = CycleGan(tiny_model_config(tmp_path), train_config, device="cpu")
    gan.train(*_dataset())
    assert gan.state.step == 5
    resumed = CycleGan(tiny_model_config(tmp_path, new=False), train_config,
                       device="cpu")
    _assert_same_state(gan.state, resumed.state)
    resumed.train(*_dataset())
    assert resumed.state.step == 10
