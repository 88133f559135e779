"""Write and read the JAX package's ``.npz`` checkpoints
(cyclegan_tpu/utils/checkpoint.py ``save_pytree``, ``load_pytree``).

A checkpoint holds one array per leaf of the saved tree, under its
``/``-joined path, such as ``params/g_AB/down/0/0/conv/w``. A model folder
is a ``model_config.yaml`` beside a ``checkpoint.npz`` holding at least
``params/{g_AB,g_BA,d_A,d_B}``; both packages' ``InferenceSession``s read
it.

The trainer's checkpoint is the JAX ``TrainState``'s tree, so either
package resumes the other's: ``params/<net>/...``; ``opt_state/<net>/0/``
``count``, ``mu/...`` and ``nu/...``, optax Adam's state (the chain's
second element, the learning-rate scale, holds nothing), which are torch
Adam's per-parameter ``step`` (one count per network), ``exp_avg`` and
``exp_avg_sq``; ``rng``, the JAX key, which the port does not use and
writes through as it was loaded; ``step``. The instance-norm networks'
``model_state`` has no leaves. The torch generator that draws the
augmentation is kept under ``GENERATOR_KEY``, which the JAX loader skips.

Round-1 checkpoints (``model_instances/demo``) stored the ``TrainState``
fields by position, ``[<flat index N>]/...``; ``load_pytree`` reads them
as the JAX loader does, through ``LEGACY_TRAIN_STATE_INDEX``.
"""

from __future__ import annotations

import os
import shutil
import tempfile
from pathlib import Path
from typing import Any, Dict, Mapping, Union

import numpy as np
import torch
from torch import nn

from cyclegan_tpu_torch.weights import (
    jax_params_to_torch,
    load_jax_params,
    models_to_jax_params,
    module_to_jax_params,
)

GENERATOR_KEY = "torch_augment_generator"

# The positional key prefix of each TrainState field in round-1 checkpoints
# (the JAX loader's ``_LEGACY_TRAIN_STATE_INDEX``), read where the named key
# is missing.
LEGACY_TRAIN_STATE_INDEX = {"params": 0, "model_state": 1, "opt_state": 2,
                            "rng": 3, "step": 4}


def legacy_key(key: str) -> str:
    """``params/g_AB/...`` -> ``[<flat index 0>]/g_AB/...``; other keys as
    they are."""
    head, sep, rest = key.partition("/")
    if head in LEGACY_TRAIN_STATE_INDEX:
        return (f"[<flat index {LEGACY_TRAIN_STATE_INDEX[head]}>]"
                + sep + rest)
    return key


def _leaves(node: Any, prefix: list, out: Dict[str, np.ndarray]) -> None:
    if isinstance(node, dict):
        for k, v in node.items():
            _leaves(v, prefix + [str(k)], out)
    elif isinstance(node, (list, tuple)):
        for i, v in enumerate(node):
            _leaves(v, prefix + [str(i)], out)
    else:
        out["/".join(prefix)] = np.asarray(node)


def save_pytree(path: Union[str, Path], tree: Any) -> None:
    """Write a tree of nested dicts and lists of arrays to ``path`` (npz),
    one entry per leaf under its ``/``-joined path; atomically, through a
    temporary file in the same folder renamed over ``path``."""
    arrays: Dict[str, np.ndarray] = {}
    _leaves(tree, [], arrays)
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp_name = tempfile.mkstemp(dir=path.parent, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, **arrays)
        os.replace(tmp_name, path)
    except BaseException:
        if os.path.exists(tmp_name):
            os.unlink(tmp_name)
        raise


def save_model_folder(model_dir: Union[str, Path],
                      model_config_path: Union[str, Path],
                      models: Mapping[str, nn.Module]) -> None:
    """A model folder of the four networks (f32 parameters): the model
    config copied as ``model_config.yaml`` and ``params/<network>/...`` in
    ``checkpoint.npz``."""
    model_dir = Path(model_dir)
    model_dir.mkdir(parents=True, exist_ok=True)
    shutil.copyfile(model_config_path, model_dir / "model_config.yaml")
    save_pytree(model_dir / "checkpoint.npz",
                {"params": models_to_jax_params(models)})


def load_pytree(path: Union[str, Path], template: Any) -> Any:
    """Load the leaves of ``template`` (nested dicts and lists of arrays)
    from ``path``, in the template's structure and dtypes.

    The template's leaf paths must be a subset of the stored keys; extra
    stored keys (optimizer state, the discriminators) are ignored. A leaf
    missing under its named key is read under its round-1 positional key
    (``legacy_key``). A leaf missing under both raises ``KeyError``, a
    shape mismatch ``ValueError``."""
    with np.load(path) as data:
        stored = {k: data[k] for k in data.files}

    def restore(node, prefix):
        if isinstance(node, dict):
            return {k: restore(v, prefix + [str(k)]) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [restore(v, prefix + [str(i)]) for i, v in enumerate(node)]
        key = "/".join(prefix)
        if key not in stored:
            key = legacy_key(key)
        if key not in stored:
            raise KeyError(f"checkpoint missing leaf {key!r}")
        value = stored[key]
        leaf = np.asarray(node)
        if tuple(value.shape) != tuple(leaf.shape):
            raise ValueError(f"checkpoint leaf {key!r} has shape "
                             f"{value.shape}, expected {leaf.shape}")
        return value.astype(leaf.dtype)

    return restore(template, [])


def _adam_tree(model: nn.Module, optimizer: torch.optim.Optimizer) -> list:
    """optax ``adam``'s state of one network: [ScaleByAdamState, the
    learning-rate scale's empty state]."""
    if not isinstance(optimizer, torch.optim.Adam):
        raise NotImplementedError(
            f"checkpointing {type(optimizer).__name__} is not ported yet "
            f"(ROADMAP.md queue 1, item 2)")
    state = optimizer.state
    steps = {int(state[p]["step"]) for p in model.parameters() if p in state}
    if len(steps) > 1:
        raise ValueError(f"Adam steps differ across parameters: {steps}")

    def moment(name):
        return lambda p: (state[p][name].detach().float().cpu().numpy()
                          if p in state else
                          np.zeros(tuple(p.shape), np.float32))

    return [{"count": np.int32(steps.pop() if steps else 0),
             "mu": module_to_jax_params(model, moment("exp_avg")),
             "nu": module_to_jax_params(model, moment("exp_avg_sq"))}, {}]


def train_state_tree(state, rng: np.ndarray) -> dict:
    """The JAX ``TrainState`` tree of a port ``steps.TrainState`` (numpy
    leaves), with the JAX key ``rng``."""
    return {"params": models_to_jax_params(state.models),
            "opt_state": {name: _adam_tree(model, state.optimizers[name])
                          for name, model in state.models.items()},
            "rng": np.asarray(rng, np.uint32),
            "step": np.int32(state.step)}


def save_train_state(path: Union[str, Path], state, rng: np.ndarray) -> None:
    """Write a ``steps.TrainState`` as the JAX trainer's checkpoint, plus
    the augmentation generator's state under ``GENERATOR_KEY``."""
    tree = train_state_tree(state, rng)
    tree[GENERATOR_KEY] = state.generator.get_state().numpy()
    save_pytree(path, tree)


def load_train_state(path: Union[str, Path], state) -> np.ndarray:
    """Restore a checkpoint of either trainer into ``state`` in place:
    parameters, Adam moments and counts, the step and, where the port wrote
    it, the augmentation generator. Returns the JAX key ``rng``."""
    restored = load_pytree(path, train_state_tree(
        state, np.zeros(2, np.uint32)))
    load_jax_params(state.models, restored["params"])
    for name, model in state.models.items():
        adam = restored["opt_state"][name][0]
        mu, nu = jax_params_to_torch(adam["mu"]), jax_params_to_torch(
            adam["nu"])
        step = torch.tensor(float(adam["count"]), dtype=torch.float32)
        optimizer = state.optimizers[name]
        saved = optimizer.state_dict()
        saved["state"] = {
            i: {"step": step.clone(), "exp_avg": mu[key],
                "exp_avg_sq": nu[key]}
            for i, (key, _) in enumerate(model.named_parameters())}
        optimizer.load_state_dict(saved)
    state.step = int(restored["step"])
    with np.load(path) as data:
        if GENERATOR_KEY in data.files:
            state.generator.set_state(torch.from_numpy(data[GENERATOR_KEY]))
    return restored["rng"]
