"""Write and read the JAX package's ``.npz`` checkpoints
(cyclegan_tpu/utils/checkpoint.py ``save_pytree``, ``load_pytree``).

A checkpoint holds one array per leaf of the saved tree, under its
``/``-joined path, such as ``params/g_AB/down/0/0/conv/w``. A model folder
is a ``model_config.yaml`` beside a ``checkpoint.npz`` holding at least
``params/{g_AB,g_BA,d_A,d_B}``; both packages' ``InferenceSession``s read
it.
"""

from __future__ import annotations

import os
import shutil
import tempfile
from pathlib import Path
from typing import Any, Dict, Mapping, Union

import numpy as np
from torch import nn

from cyclegan_tpu_torch.weights import models_to_jax_params


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
    stored keys (optimizer state, the discriminators) are ignored. A
    missing key raises ``KeyError``, a shape mismatch ``ValueError``."""
    with np.load(path) as data:
        stored = {k: data[k] for k in data.files}

    def restore(node, prefix):
        if isinstance(node, dict):
            return {k: restore(v, prefix + [str(k)]) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [restore(v, prefix + [str(i)]) for i, v in enumerate(node)]
        key = "/".join(prefix)
        if key not in stored:
            raise KeyError(f"checkpoint missing leaf {key!r}")
        value = stored[key]
        leaf = np.asarray(node)
        if tuple(value.shape) != tuple(leaf.shape):
            raise ValueError(f"checkpoint leaf {key!r} has shape "
                             f"{value.shape}, expected {leaf.shape}")
        return value.astype(leaf.dtype)

    return restore(template, [])
