"""Carry weights between the JAX package's parameter trees and the port.

The JAX package keeps a network's parameters as nested dicts and lists,
saved under ``/``-joined paths (``down/0/0/conv/w``). The port's modules
are built so that their ``state_dict`` keys are the same paths joined by
``.`` (``down.0.0.conv.w``), with the same shapes: conv weights stay HWIO,
as in the checkpoint and the kernels' signatures. So the bridge renames
and converts, and never transposes. A training state's four networks cross
as one ``params`` tree keyed by network name, as the JAX ``TrainState``
holds them, so one numpy tree seeds both packages.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch
from torch import nn


def jax_params_to_torch(tree: Any) -> Dict[str, torch.Tensor]:
    """Nested dict/list of numpy arrays -> ``state_dict`` of tensors."""
    flat: Dict[str, torch.Tensor] = {}

    def walk(node, prefix):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, prefix + [str(k)])
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(v, prefix + [str(i)])
        else:
            flat[".".join(prefix)] = torch.from_numpy(np.array(node))

    walk(tree, [])
    return flat


def torch_params_to_jax(state_dict: Dict[str, torch.Tensor]) -> Any:
    """The inverse: ``state_dict`` -> nested dicts, with lists where the
    keys of a level are 0..n-1, of numpy arrays."""
    root: Dict[str, Any] = {}
    for key, value in state_dict.items():
        node = root
        parts = key.split(".")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = value.detach().cpu().numpy()

    def listify(node):
        if not isinstance(node, dict):
            return node
        out = {k: listify(v) for k, v in node.items()}
        if out and all(k.isdigit() for k in out) and sorted(
                int(k) for k in out) == list(range(len(out))):
            return [out[str(i)] for i in range(len(out))]
        return out

    return listify(root)


def models_to_jax_params(models: Mapping[str, nn.Module]) -> Dict[str, Any]:
    """Networks by name (a ``TrainState``'s ``models``) -> the JAX
    package's ``params`` tree: {name: nested dicts/lists of numpy}."""
    return {name: torch_params_to_jax(model.state_dict())
            for name, model in models.items()}


def load_jax_params(models: Mapping[str, nn.Module],
                    params: Mapping[str, Any]) -> None:
    """Copy a JAX ``params`` tree ({name: tree}, numpy leaves) into the
    networks of the same names, in place, keeping each parameter's device
    and dtype. Every leaf must match a parameter (``strict``)."""
    for name, model in models.items():
        model.load_state_dict(jax_params_to_torch(params[name]), strict=True)
