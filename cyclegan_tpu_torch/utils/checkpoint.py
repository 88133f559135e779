"""Write and read the JAX package's ``.npz`` checkpoints
(cyclegan_tpu/utils/checkpoint.py ``save_pytree``, ``load_pytree``).

A checkpoint holds one array per leaf of the saved tree, under its
``/``-joined path, such as ``params/g_AB/down/0/0/conv/w``. A model folder
is a ``model_config.yaml`` beside a ``checkpoint.npz`` holding at least
``params/{g_AB,g_BA,d_A,d_B}``; both packages' ``InferenceSession``s read
it.

The trainer's checkpoint is the JAX ``TrainState``'s tree, so either
package resumes the other's: ``params/<net>/...``; ``opt_state/<net>/...``,
optax's state of the network's optimizer with exactly its leaves
(``optimizer_tree``): adam ``0/count``, ``0/mu/...``, ``0/nu/...`` (torch
Adam's per-parameter ``step``, one count per network, ``exp_avg`` and
``exp_avg_sq``), rmsprop ``0/nu/...`` only (``square_avg``; torch's step
is restored from the train state's ``step``), sgd nothing, adabelief
``count``, ``m/...``, ``s/...``; ``rng``, the JAX key, which the port does
not use and writes through as it was loaded; ``step``. The instance-norm
networks' ``model_state`` has no leaves. The torch generators that draw
the augmentation and the dropout masks are kept under ``GENERATOR_KEY``
and ``DROPOUT_GENERATOR_KEY``, which the JAX loader skips.

Round-1 checkpoints (``model_instances/demo``) stored the ``TrainState``
fields by position, ``[<flat index N>]/...``; ``load_pytree`` reads them
as the JAX loader does, through ``LEGACY_TRAIN_STATE_INDEX``.
"""

from __future__ import annotations

import logging
import os
import shutil
import tempfile
from pathlib import Path
from typing import Any, Dict, Mapping, Union

import numpy as np
import torch
from torch import nn

from cyclegan_tpu_torch.optimizers import AdaBeliefTF
from cyclegan_tpu_torch.weights import (
    jax_params_to_torch,
    load_jax_params,
    models_to_jax_params,
    module_to_jax_params,
)

logger = logging.getLogger(__name__)

GENERATOR_KEY = "torch_augment_generator"
DROPOUT_GENERATOR_KEY = "torch_dropout_generator"

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


def _slot(model: nn.Module, optimizer: torch.optim.Optimizer, name: str):
    """One per-parameter slot of ``optimizer`` as a JAX parameter tree
    (zeros where a parameter has no state yet)."""
    state = optimizer.state
    return module_to_jax_params(model, lambda p: (
        state[p][name].detach().float().cpu().numpy() if p in state else
        np.zeros(tuple(p.shape), np.float32)))


def _count(model: nn.Module, optimizer: torch.optim.Optimizer) -> np.int32:
    """The one step count of a network's optimizer (torch keeps one per
    parameter; optax one per tree)."""
    state = optimizer.state
    steps = {int(state[p]["step"]) for p in model.parameters() if p in state}
    if len(steps) > 1:
        raise ValueError(f"optimizer steps differ across parameters: {steps}")
    return np.int32(steps.pop() if steps else 0)


def optimizer_tree(model: nn.Module, optimizer: torch.optim.Optimizer):
    """optax's state of one network's optimizer, with exactly its leaves:
    adam ``[ScaleByAdamState(count, mu, nu), {}]``, rmsprop
    ``[ScaleByRmsState(nu), {}]`` (no count), sgd ``[{}, {}]`` (no leaf),
    adabelief ``AdaBeliefTfState(count, m, s)`` (not under ``0/``)."""
    if isinstance(optimizer, torch.optim.Adam):
        return [{"count": _count(model, optimizer),
                 "mu": _slot(model, optimizer, "exp_avg"),
                 "nu": _slot(model, optimizer, "exp_avg_sq")}, {}]
    if isinstance(optimizer, torch.optim.RMSprop):
        return [{"nu": _slot(model, optimizer, "square_avg")}, {}]
    if isinstance(optimizer, torch.optim.SGD):
        return [{}, {}]
    if isinstance(optimizer, AdaBeliefTF):
        return {"count": _count(model, optimizer),
                "m": _slot(model, optimizer, "m"),
                "s": _slot(model, optimizer, "s")}
    raise TypeError(f"no optax state for {type(optimizer).__name__}")


def _restore_optimizer(model: nn.Module, optimizer: torch.optim.Optimizer,
                       tree, step: int) -> None:
    """Load optax's state ``tree`` of one network into ``optimizer``; the
    torch step count of RMSprop, which optax does not store, is the train
    state's ``step``."""
    if isinstance(optimizer, torch.optim.SGD):
        return  # nothing stored, nothing to restore
    if isinstance(optimizer, torch.optim.Adam):
        tree = tree[0]
        slots = {"exp_avg": tree["mu"], "exp_avg_sq": tree["nu"]}
    elif isinstance(optimizer, torch.optim.RMSprop):
        tree = dict(tree[0], count=step)
        slots = {"square_avg": tree["nu"]}
    else:
        slots = {"m": tree["m"], "s": tree["s"]}
    slots = {k: jax_params_to_torch(v) for k, v in slots.items()}
    count = torch.tensor(float(tree["count"]), dtype=torch.float32)
    saved = optimizer.state_dict()
    saved["state"] = {
        i: {"step": count.clone(), **{k: v[key] for k, v in slots.items()}}
        for i, (key, _) in enumerate(model.named_parameters())}
    optimizer.load_state_dict(saved)


def train_state_tree(state, rng: np.ndarray) -> dict:
    """The JAX ``TrainState`` tree of a port ``steps.TrainState`` (numpy
    leaves), with the JAX key ``rng``."""
    return {"params": models_to_jax_params(state.models),
            "opt_state": {name: optimizer_tree(model, state.optimizers[name])
                          for name, model in state.models.items()},
            "rng": np.asarray(rng, np.uint32),
            "step": np.int32(state.step)}


def save_train_state(path: Union[str, Path], state, rng: np.ndarray) -> None:
    """Write a ``steps.TrainState`` as the JAX trainer's checkpoint, plus
    the augmentation and dropout generators' states under
    ``GENERATOR_KEY`` and ``DROPOUT_GENERATOR_KEY``."""
    tree = train_state_tree(state, rng)
    tree[GENERATOR_KEY] = state.generator.get_state().numpy()
    tree[DROPOUT_GENERATOR_KEY] = state.dropout_generator.get_state().numpy()
    save_pytree(path, tree)


def load_train_state(path: Union[str, Path], state) -> np.ndarray:
    """Restore a checkpoint of either trainer into ``state`` in place:
    parameters, every optimizer's state, the step and, where the port
    wrote them, the augmentation and dropout generators. Returns the JAX
    key ``rng``."""
    restored = load_pytree(path, train_state_tree(
        state, np.zeros(2, np.uint32)))
    load_jax_params(state.models, restored["params"])
    state.step = int(restored["step"])
    for name, model in state.models.items():
        _restore_optimizer(model, state.optimizers[name],
                           restored["opt_state"][name], state.step)
    with np.load(path) as data:
        for key, generator in ((GENERATOR_KEY, state.generator),
                               (DROPOUT_GENERATOR_KEY,
                                state.dropout_generator)):
            if key not in data.files:
                continue
            saved = torch.from_numpy(data[key])
            if saved.numel() != generator.get_state().numel():
                # a generator of another device type (a CPU run resumed on
                # the card): its stream cannot be carried over
                logger.warning("checkpoint %s is a %d-byte state; the "
                               "%s generator keeps its own", key,
                               saved.numel(), generator.device.type)
                continue
            generator.set_state(saved)
    return restored["rng"]
