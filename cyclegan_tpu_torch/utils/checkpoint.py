"""Read the JAX package's ``.npz`` checkpoints
(cyclegan_tpu/utils/checkpoint.py ``load_pytree``).

A checkpoint holds one array per leaf of the saved tree, under its
``/``-joined path, such as ``params/g_AB/down/0/0/conv/w``.
"""

from __future__ import annotations

from pathlib import Path
from typing import Any, Union

import numpy as np


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
