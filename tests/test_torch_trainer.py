"""The port's trainer and its CLI on the CPU, with the tiny configs of
``tests/test_trainer.py``: training, checkpoint and resume in both layouts,
checkpoints crossing between the two packages, one NHWC train step against
the JAX package's, the config writer against PyYAML's reader, and
``python -m cyclegan_tpu_torch.train`` on tiny records.

Tolerances: checkpoints cross exactly (f32 and int32 leaves copied). The
train step: losses 1e-5 relative; parameters after one Adam step within
1e-6 except where a gradient is below 1e-6, where Adam's g / (sqrt(v) +
1e-7) turns on rounding (as ``test_torch_steps.py``), at a point where the
norms' betas sit at +-(3..4) so no ReLU decision flips.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cyclegan_tpu import steps as jax_steps
from cyclegan_tpu.config import Namespace as JaxNamespace
from cyclegan_tpu.config import yaml2namespace as jax_yaml2namespace
from cyclegan_tpu.models import create_model as jax_create_model
from cyclegan_tpu.optimizers import get_optimizer as jax_get_optimizer
from cyclegan_tpu.trainer import CycleGan as JaxCycleGan
from cyclegan_tpu_torch import kernels, steps
from cyclegan_tpu_torch.config import Namespace, namespace2yaml
from cyclegan_tpu_torch.config import yaml2namespace
from cyclegan_tpu_torch.data.codec import image2example
from cyclegan_tpu_torch.data.pipeline import ArrayDataset
from cyclegan_tpu_torch.data.tfrecord import write_tfrecord_file
from cyclegan_tpu_torch.ops import cuda_norm, cuda_norm_act
from cyclegan_tpu_torch.train import main as train_main
from cyclegan_tpu_torch.trainer import CHECKPOINT_FILE, CycleGan
from cyclegan_tpu_torch.weights import (
    jax_params_to_torch,
    load_jax_params,
    models_to_jax_params,
)
from tests.test_torch_steps import _shift_affine

NETWORKS = steps.NETWORKS


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in several worker processes."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def tiny_model_config(location, new=True):
    unet = dict(type="unet_generator", filters=[4, 4], kernels=[3, 3],
                expansion="upsample", normalization="instancenorm",
                dropout=False)
    return Namespace(dict(
        name="tiny", new=new, location=str(location), seed=0,
        generator=dict(unet, output_channels=3, final_activation="tanh"),
        discriminator=dict(unet, output_channels=1,
                           final_activation="sigmoid"),
        loss="mse", loss_weights=dict(cycle=2.0, identity=0.5, generator=1.0,
                                      discriminator=0.5)))


def tiny_train_config(epochs=1, batch_size=2, image_size=16, **extra):
    adam = dict(name="adam", learning_rate=2e-4, beta_1=0.5)
    return Namespace(dict(epochs=epochs, batch_size=batch_size,
                          image_size=image_size, g_opt=adam, d_opt=adam,
                          summary=dict(samples=2, images=1, model=1),
                          **extra))


def tiny_dataset(n=6, size=16):
    rng = np.random.default_rng(3)
    a = rng.integers(0, 256, size=(n, size, size, 3), dtype=np.uint8)
    b = rng.integers(0, 256, size=(n, size, size, 3), dtype=np.uint8)
    return ArrayDataset(a, b, shuffle=True, seed=0), ArrayDataset(
        a[:4], b[:4], shuffle=False)


def _counting(monkeypatch, module, name):
    calls = []
    plain = getattr(module, name)

    def counting(*args, **kwargs):
        calls.append(1)
        return plain(*args, **kwargs)

    monkeypatch.setattr(module, name, counting)
    return calls


def _assert_same_state(a, b):
    for name in NETWORKS:
        other = dict(b.models[name].named_parameters())
        for key, p in a.models[name].named_parameters():
            q = other[key]
            assert torch.equal(p, q), (name, key)
            sa = a.optimizers[name].state[p]
            sb = b.optimizers[name].state[q]
            for slot in ("step", "exp_avg", "exp_avg_sq"):
                assert torch.equal(sa[slot], sb[slot]), (name, key, slot)
    assert a.step == b.step
    assert torch.equal(a.generator.get_state(), b.generator.get_state())
    assert torch.equal(a.dropout_generator.get_state(),
                       b.dropout_generator.get_state())


@pytest.mark.parametrize("layout", ["nhwc", "nhwc_pallas", "nhcw"])
def test_train_checkpoint_resume(tmp_path, monkeypatch, layout):
    nhwc_calls = _counting(monkeypatch, cuda_norm,
                           "instance_norm_nhwc_plain")
    nhcw_calls = _counting(monkeypatch, cuda_norm_act,
                           "instance_norm_act_plain")
    train_config = tiny_train_config(tpu_layout=layout == "nhcw",
                                     pallas_norm=layout == "nhwc_pallas")
    gan = CycleGan(tiny_model_config(tmp_path), train_config, device="cpu")
    assert gan.tpu_layout == (layout == "nhcw")
    train_ds, val_ds = tiny_dataset()
    gan.train(train_ds, val_ds)
    assert gan.state.step == 3
    assert (bool(nhwc_calls), bool(nhcw_calls)) == {
        "nhwc": (False, False), "nhwc_pallas": (True, False),
        "nhcw": (False, True)}[layout]

    folder = tmp_path / "tiny"
    for name in (CHECKPOINT_FILE, "a_samples.npy", "b_samples.npy",
                 "model_config.yaml", "train_config.yaml"):
        assert (folder / name).exists(), name
    written = yaml2namespace(folder / "model_config.yaml")
    assert written.current_epoch == 1 and written.new is False
    record = gan.history[-1]
    assert record["train_steps"] == 3 and record["validation_steps"] == 2
    assert all(np.isfinite(v) for v in record["train"].values())

    resumed = CycleGan(written, train_config, device="cpu")
    _assert_same_state(gan.state, resumed.state)
    np.testing.assert_array_equal(resumed.a_samples, gan.a_samples)
    resumed.train(train_ds, val_ds)
    assert resumed.state.step == 6
    assert yaml2namespace(folder / "model_config.yaml").current_epoch == 2


def test_tpu_layout_auto_resolution(tmp_path):
    """auto is NHCW only on a CUDA device with bf16; true and false win."""
    for extra, want in ((dict(compute_dtype="bfloat16"), False),
                        (dict(compute_dtype="bfloat16", tpu_layout=True),
                         True),
                        (dict(tpu_layout=False), False)):
        gan = CycleGan(tiny_model_config(tmp_path),
                       tiny_train_config(**extra), device="cpu")
        assert gan.tpu_layout is want, extra


@pytest.mark.parametrize("extra,item", [
    (dict(dp_shard_map=True), "item 7")])
def test_unported_options_raise(tmp_path, extra, item):
    """The last option that raised, dp_shard_map (ROADMAP.md queue 1,
    item 7), is ported: it builds, and without a mesh the step is the
    single-device one, as the JAX trainer's."""
    gan = CycleGan(tiny_model_config(tmp_path), tiny_train_config(**extra),
                   device="cpu")
    assert gan.dp_shard_map and gan.mesh is None and gan.is_lead


def test_mesh_and_default_device(tmp_path):
    from cyclegan_tpu_torch.parallel import create_mesh

    with pytest.raises(RuntimeError, match="initialized torch.distributed"):
        CycleGan(tiny_model_config(tmp_path), tiny_train_config(),
                 mesh=create_mesh(2), device="cpu")
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        CycleGan(tiny_model_config(tmp_path), tiny_train_config())


def test_predict_shapes_and_range(tmp_path):
    gan = CycleGan(tiny_model_config(tmp_path), tiny_train_config(),
                   device="cpu")
    images = np.random.default_rng(1).integers(0, 256, (2, 16, 16, 3),
                                               dtype=np.uint8)
    for direction in ("a2b", "b2a"):
        out = gan.predict(images, direction)
        assert out.shape == (2, 16, 16, 3) and out.dtype == np.float32
        assert out.min() >= -1.0 and out.max() <= 1.0
    assert all(m.training for m in gan.state.models.values())


def _jax_config(namespace):
    return JaxNamespace(namespace.to_dict())


def _jax_adam_tree(state, name):
    return jax.tree.map(np.asarray, state.opt_state[name][0])


def test_jax_checkpoint_resumes_in_the_port(tmp_path):
    """A checkpoint the JAX trainer writes, with Adam moments and counts
    set to values of its own: the port restores its parameters, moments,
    counts, step and key exactly."""
    jax_gan = JaxCycleGan(_jax_config(tiny_model_config(tmp_path)),
                          _jax_config(tiny_train_config()))
    rng = np.random.default_rng(0)

    def fill(leaf):
        if jnp.issubdtype(leaf.dtype, jnp.floating):
            return jnp.asarray(np.abs(rng.normal(size=leaf.shape)), leaf.dtype)
        return jnp.asarray(3, leaf.dtype)

    jax_gan.state = dataclasses.replace(
        jax_gan.state, opt_state=jax.tree.map(fill, jax_gan.state.opt_state),
        step=jnp.asarray(3, jnp.int32))
    jax_gan.save_model()

    gan = CycleGan(tiny_model_config(tmp_path, new=False),
                   tiny_train_config(), device="cpu")
    assert gan.state.step == 3
    np.testing.assert_array_equal(gan.rng, np.asarray(jax_gan.state.rng))
    for name in NETWORKS:
        want = jax_params_to_torch(jax.tree.map(np.asarray,
                                                jax_gan.state.params[name]))
        adam = _jax_adam_tree(jax_gan.state, name)
        mu, nu = jax_params_to_torch(adam.mu), jax_params_to_torch(adam.nu)
        opt = gan.state.optimizers[name].state
        for key, p in gan.state.models[name].named_parameters():
            assert torch.equal(p, want[key]), (name, key)
            assert torch.equal(opt[p]["exp_avg"], mu[key]), (name, key)
            assert torch.equal(opt[p]["exp_avg_sq"], nu[key]), (name, key)
            assert float(opt[p]["step"]) == int(adam.count) == 3


def test_port_checkpoint_resumes_in_jax(tmp_path):
    """A checkpoint the port writes after a step: the JAX trainer's
    ``load_model`` restores the same parameters, moments, count and
    step."""
    gan = CycleGan(tiny_model_config(tmp_path), tiny_train_config(),
                   device="cpu")
    a, b = (torch.from_numpy(x) for x in next(tiny_dataset()[0].batches(2)))
    gan.train_step_fn(gan.state, a, b)
    gan.save_model()

    jax_gan = JaxCycleGan(jax_yaml2namespace(tmp_path / "tiny" /
                                             "model_config.yaml"),
                          _jax_config(tiny_train_config()))
    assert int(jax_gan.state.step) == 1
    for name in NETWORKS:
        got = jax_params_to_torch(jax.tree.map(np.asarray,
                                               jax_gan.state.params[name]))
        adam = _jax_adam_tree(jax_gan.state, name)
        mu, nu = jax_params_to_torch(adam.mu), jax_params_to_torch(adam.nu)
        assert int(adam.count) == 1
        opt = gan.state.optimizers[name].state
        for key, p in gan.state.models[name].named_parameters():
            assert torch.equal(got[key], p.detach()), (name, key)
            assert torch.equal(mu[key], opt[p]["exp_avg"]), (name, key)
            assert torch.equal(nu[key], opt[p]["exp_avg_sq"]), (name, key)


@pytest.fixture(scope="module")
def step_point():
    """(numpy params with shifted affines, batch a, b, the JAX NHWC step's
    metrics and parameters after it), the JAX step under ``jax.jit``."""
    cfg = tiny_model_config("unused")
    params = models_to_jax_params(steps.build_models(cfg, seed=0))
    _shift_affine(params, np.random.default_rng(11))
    rng = np.random.default_rng(5)
    a, b = (rng.uniform(-1, 1, (2, 16, 16, 3)).astype(np.float32)
            for _ in range(2))
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
    jstate, metrics = jax_steps.make_train_step(
        models, optimizers, cfg.loss, dict(cfg.loss_weights),
        donate=False)(jstate, jnp.asarray(a), jnp.asarray(b))
    return (params, a, b, {k: float(v) for k, v in metrics.items()},
            {n: jax_params_to_torch(jax.tree.map(np.asarray,
                                                 jstate.params[n]))
             for n in NETWORKS})


@pytest.mark.parametrize("pallas_norm", [False, True])
def test_nhwc_train_step_matches_jax(step_point, pallas_norm):
    """One f32 step from equal parameters on an equal batch, no jitter:
    the port's NHWC step (norms on torch ops, or on K13's plain version)
    against the JAX package's NHWC (XLA) step."""
    params, a, b, want, want_params = step_point
    cfg = tiny_model_config("unused")
    port_models = steps.build_models(cfg, seed=0)
    load_jax_params(port_models, params)
    state = steps.init_train_state(port_models, tiny_train_config(),
                                   device="cpu")
    got = steps.make_train_step(cfg.loss, cfg.loss_weights,
                                tpu_layout=False, pallas_norm=pallas_norm)(
        state, torch.from_numpy(a), torch.from_numpy(b))
    for key, value in want.items():
        assert abs(float(got[key]) - value) <= 1e-5 * abs(value) + 1e-7, key
    for name in NETWORKS:
        for key, p in state.models[name].named_parameters():
            far = (p.detach() - want_params[name][key]).abs() > 1e-6
            small = p.grad.abs() < 1e-6
            assert not bool((far & ~small).any()), (name, key)


def test_namespace2yaml_is_read_back_by_jax(tmp_path):
    cfg = yaml2namespace("configs/cycle.yaml")
    cfg.update(location=str(tmp_path / "a b"), new=False, current_epoch=3,
               note="it's: #1", eps=1e-7, empty={}, none=None)
    path = tmp_path / "model_config.yaml"
    namespace2yaml(path, cfg)
    assert jax_yaml2namespace(path).to_dict() == cfg.to_dict()
    assert yaml2namespace(path).to_dict() == cfg.to_dict()


def _write_records(root, n=6, size=16):
    rng = np.random.default_rng(7)
    for domain in ("tabby_records", "tortie_records"):
        (root / domain).mkdir(parents=True)
        images = rng.integers(0, 256, (n, size, size, 3), dtype=np.uint8)
        write_tfrecord_file(root / domain / "00000.tfrecords",
                            (image2example(im) for im in images))


def test_cli_trains_and_resumes_on_tiny_records(tmp_path):
    _write_records(tmp_path / "data")
    model_yaml, train_yaml = tmp_path / "model.yaml", tmp_path / "train.yaml"
    namespace2yaml(model_yaml, tiny_model_config(tmp_path / "models"))
    namespace2yaml(train_yaml, tiny_train_config(pallas_norm=True))
    args = ["--train_config", str(train_yaml), "--data_dir",
            str(tmp_path / "data"), "--device", "cpu"]
    kernels.reset_launches()
    gan = train_main(["--model_config", str(model_yaml), *args])
    # 6 images: 1 for validation, 5 to train, 2 batches of 2
    assert gan.state.step == 2 and not gan.tpu_layout and gan.pallas_norm
    assert not any(kernels.launches.values())  # the CPU runs no kernel
    saved = tmp_path / "models" / "tiny" / "model_config.yaml"
    gan = train_main(["--model_config", str(saved), *args])
    assert gan.state.step == 4
    assert yaml2namespace(saved).current_epoch == 2


@pytest.mark.parametrize("flags", [["--num_devices", "2"],
                                   ["--spatial_devices", "2"],
                                   ["--dp_shard_map"], ["--distributed"],
                                   ["--coordinator", "localhost:1"]])
def test_cli_rejects_parallel_flags(flags, monkeypatch):
    """Parallel flags need one process per device in a process group:
    without one, a mesh of more than one device stops the CLI, and
    --distributed or --coordinator without the group's description
    raise (``tests/test_torch_multiprocess.py`` runs them)."""
    for var in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(var, raising=False)
    if flags == ["--dp_shard_map"]:
        flags = flags + ["--spatial_devices", "2"]
    want = ((ValueError, "MASTER_ADDR|--num_processes")
            if "--distributed" in flags or "--coordinator" in flags
            else (SystemExit, "one process per device"))
    with pytest.raises(want[0], match=want[1]):
        train_main(["--device", "cpu", *flags])
