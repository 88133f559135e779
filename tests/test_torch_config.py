"""The port's config reader, checkpoint reader and weight bridge."""

import glob

import numpy as np
import pytest
import torch
import yaml

from cyclegan_tpu_torch.config import Namespace, parse_yaml, yaml2namespace
from cyclegan_tpu_torch.models import UNetGenerator
from cyclegan_tpu_torch.utils.checkpoint import load_pytree
from cyclegan_tpu_torch.weights import jax_params_to_torch, module_to_jax_params

YAML_FILES = sorted(glob.glob("configs/*.yaml")
                    + glob.glob("model_instances/*/*.yaml"))


def test_yaml_files_found():
    assert "configs/cycle.yaml" in YAML_FILES
    assert "model_instances/converged256/model_config.yaml" in YAML_FILES


@pytest.mark.parametrize("path", YAML_FILES)
def test_reader_matches_pyyaml(path):
    with open(path) as f:
        text = f.read()
    assert parse_yaml(text) == yaml.safe_load(text)


@pytest.mark.parametrize("text", [
    "a: 1\nb: [1, 2.5, x]\nc:\n  d: true\n  e: ~\n",
    "list:\n- 1\n- 'two # not a comment'\n- \"3\"\nnext: 0.5  # comment\n",
    "items:\n  - name: a\n    k: 1\n  - name: b\n    k: 2\n",
    "nums: [1.0, -2, +3, 1e5, 1.0e-7, 2e-4, .5, 0]\nflags: [yes, No, off]\n",
    "nested:\n  deeper:\n    deepest: []\n  empty:\nend: {}\n",
])
def test_reader_subset_matches_pyyaml(text):
    assert parse_yaml(text) == yaml.safe_load(text)


@pytest.mark.parametrize("text", ["a: 1\n   b: 2\n", "a: [1, [2]]\n",
                                  "a: &anchor 1\n", "- 1\nb: 2\n"])
def test_reader_rejects_what_it_does_not_take(text):
    with pytest.raises(ValueError):
        parse_yaml(text)


def test_namespace_attribute_access():
    ns = yaml2namespace("configs/cycle.yaml")
    assert ns.generator.filters == [16, 32, 64, 128]
    assert isinstance(ns.generator, Namespace)
    assert not hasattr(ns, "missing")
    with pytest.raises(KeyError):
        ns["missing"]
    assert ns.to_dict()["loss_weights"]["cycle"] == 2.0


def _small_model():
    cfg = yaml2namespace("configs/smoke.yaml").generator
    return UNetGenerator(cfg, torch.Generator().manual_seed(1))


def test_weight_round_trip():
    model = _small_model()
    state = model.state_dict()
    tree = module_to_jax_params(model)
    assert isinstance(tree["down"], list) and isinstance(tree["head"], dict)
    assert tree["down"][0][1]["conv"]["w"].shape == (3, 3, 8, 8)
    back = jax_params_to_torch(tree)
    assert set(back) == set(state)
    for key in state:
        assert torch.equal(back[key], state[key]), key


def test_checkpoint_loads_and_checks(tmp_path):
    model = _small_model()
    state = model.state_dict()
    tree = {"params": {"g": module_to_jax_params(model)}}
    flat = {"params/g/" + k.replace(".", "/"): v.numpy()
            for k, v in state.items()}
    path = tmp_path / "ckpt.npz"
    np.savez(path, extra=np.zeros(2), **flat)
    restored = load_pytree(path, tree)
    for key, value in jax_params_to_torch(restored["params"]["g"]).items():
        assert torch.equal(value, state[key]), key

    missing = dict(flat)
    missing.pop("params/g/head/b")
    np.savez(path, **missing)
    with pytest.raises(KeyError, match="head/b"):
        load_pytree(path, tree)

    flat["params/g/head/b"] = np.zeros(5, np.float32)
    np.savez(path, **flat)
    with pytest.raises(ValueError, match="shape"):
        load_pytree(path, tree)
