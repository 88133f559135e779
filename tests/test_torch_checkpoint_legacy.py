"""Round-1 checkpoints, whose leaves sit under positional keys
(``[<flat index N>]/...``), in the port's loader against the JAX package's.

``model_instances/demo`` is such a checkpoint (a U-Net 8/16/32 at k3 with
Adam, trained at 64x64). Tolerances: the f32 sessions' uint8 outputs may
differ by 1 (two f32 paths may round a pixel on either side of a half, as
``test_torch_inference.py``); a resumed train state is copied, so it must
equal the JAX package's exactly.
"""

import shutil

import jax
import numpy as np
import pytest
import torch

from cyclegan_tpu.apps.inference import InferenceSession as JaxSession
from cyclegan_tpu.config import Namespace as JaxNamespace
from cyclegan_tpu.trainer import CycleGan as JaxCycleGan
from cyclegan_tpu_torch import steps
from cyclegan_tpu_torch.apps.inference import InferenceSession
from cyclegan_tpu_torch.config import yaml2namespace
from cyclegan_tpu_torch.trainer import CycleGan
from cyclegan_tpu_torch.utils.checkpoint import (
    load_pytree,
    save_pytree,
)
from cyclegan_tpu_torch.weights import jax_params_to_torch

DEMO = "model_instances/demo"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in several worker processes."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_demo_checkpoint_holds_only_legacy_keys():
    with np.load(f"{DEMO}/checkpoint.npz") as data:
        assert data.files and all(k.startswith("[<flat index ")
                                  for k in data.files)


@pytest.mark.parametrize("direction", ["a2b", "b2a"])
def test_demo_session_matches_jax(direction):
    images = np.random.default_rng(0).integers(0, 256, (2, 64, 64, 3),
                                               dtype=np.uint8)
    got = InferenceSession(DEMO, "float32", device="cpu").stylize(
        images, direction)
    want = JaxSession(DEMO, "float32").stylize(images, direction)
    assert got.dtype == np.uint8 and got.shape == want.shape == images.shape
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1


def _demo_copy(tmp_path):
    """demo's folder under tmp_path (constructing a trainer writes summary
    folders beside the checkpoint), and its two configs pointing there."""
    shutil.copytree(DEMO, tmp_path / "demo")
    model_cfg = yaml2namespace(tmp_path / "demo" / "model_config.yaml")
    model_cfg.location = str(tmp_path)
    return model_cfg, yaml2namespace(tmp_path / "demo" / "train_config.yaml")


def test_demo_resume_matches_jax(tmp_path):
    """A port trainer resumed from demo holds the parameters, Adam moments
    and counts, step and key that the JAX trainer's resume holds."""
    model_cfg, train_cfg = _demo_copy(tmp_path)
    assert model_cfg.new is False
    jax_gan = JaxCycleGan(JaxNamespace(model_cfg.to_dict()),
                          JaxNamespace(train_cfg.to_dict()))
    gan = CycleGan(model_cfg, train_cfg, device="cpu")

    want_state = jax.tree.map(np.asarray, jax_gan.state)
    assert gan.state.step == int(want_state.step) > 0
    np.testing.assert_array_equal(gan.rng, want_state.rng)
    for name in steps.NETWORKS:
        want = jax_params_to_torch(want_state.params[name])
        adam = want_state.opt_state[name][0]
        mu, nu = jax_params_to_torch(adam.mu), jax_params_to_torch(adam.nu)
        assert int(adam.count) == int(want_state.step)
        opt = gan.state.optimizers[name].state
        for key, p in gan.state.models[name].named_parameters():
            assert torch.equal(p.detach(), want[key]), (name, key)
            assert torch.equal(opt[p]["exp_avg"], mu[key]), (name, key)
            assert torch.equal(opt[p]["exp_avg_sq"], nu[key]), (name, key)
            assert float(opt[p]["step"]) == int(adam.count), (name, key)


def test_named_key_wins_over_legacy_key(tmp_path):
    path = tmp_path / "both.npz"
    save_pytree(path, {"params": {"w": np.full(3, 1.0, np.float32)},
                       "[<flat index 0>]": {"w": np.full(3, 2.0, np.float32)},
                       "[<flat index 4>]": np.int32(7)})
    template = {"params": {"w": np.zeros(3, np.float32)},
                "step": np.int32(0)}
    got = load_pytree(path, template)
    np.testing.assert_array_equal(got["params"]["w"], np.ones(3))
    assert int(got["step"]) == 7
    with pytest.raises(KeyError):
        load_pytree(path, {"rng": np.zeros(2, np.uint32)})
