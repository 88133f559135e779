"""Carry weights between the JAX package's parameter trees and the port.

The JAX package keeps a network's parameters as nested dicts and lists,
saved under ``/``-joined paths (``down/0/0/conv/w``). The port's modules
are built so that their ``state_dict`` keys are the same paths joined by
``.`` (``down.0.0.conv.w``), with the same shapes: conv weights stay HWIO
(HWOI for transposed convs), as in the checkpoint and the kernels'
signatures. So the bridge renames and converts, and never transposes; the
way back reads the tree off the module's structure. A training state's four networks cross
as one ``params`` tree keyed by network name, as the JAX ``TrainState``
holds them, so one numpy tree seeds both packages. A batch norm's moving
statistics are the modules' buffers and cross as the ``model_state`` tree
in the same way (``down/0/0/norm/moving_mean``); instance-norm networks
have no leaf there.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Mapping, Optional

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


def _numpy(p: torch.Tensor) -> np.ndarray:
    return p.detach().cpu().numpy()


def _module_tree(module: nn.Module, leaf: Callable, buffers: bool) -> Any:
    if isinstance(module, nn.ModuleList):
        return [_module_tree(child, leaf, buffers) for child in module]
    own = (module.named_buffers(recurse=False) if buffers
           else module.named_parameters(recurse=False))
    tree: Dict[str, Any] = {name: leaf(p) for name, p in own}
    for name, child in module.named_children():
        tree[name] = _module_tree(child, leaf, buffers)
    return tree


def module_to_jax_params(module: nn.Module,
                         leaf: Callable[[nn.Parameter], Any] = _numpy) -> Any:
    """One network's parameters in the JAX package's tree, read off the
    module's structure: a ``ModuleList`` is a list, any other module a dict
    of its own parameters and its children. So a block without parameters
    (the PatchGAN's non-affine ``norm``) stays the empty dict the JAX apply
    reads, which a ``state_dict`` cannot show. ``leaf(p)`` gives each
    parameter's entry (by default its value as numpy), so an optimizer's
    per-parameter state takes the same tree."""
    return _module_tree(module, leaf, buffers=False)


def module_to_jax_state(module: nn.Module) -> Any:
    """One network's ``model_state`` tree (its buffers: a batch norm's
    moving statistics), read off the module's structure as
    ``module_to_jax_params`` reads its parameters; without batch norm a
    tree of empty nodes, no leaf."""
    return _module_tree(module, _numpy, buffers=True)


def models_to_jax_params(models: Mapping[str, nn.Module]) -> Dict[str, Any]:
    """Networks by name (a ``TrainState``'s ``models``) -> the JAX
    package's ``params`` tree: {name: nested dicts/lists of numpy}."""
    return {name: module_to_jax_params(model)
            for name, model in models.items()}


def models_to_jax_state(models: Mapping[str, nn.Module]) -> Dict[str, Any]:
    """Networks by name -> the JAX package's ``model_state`` tree."""
    return {name: module_to_jax_state(model)
            for name, model in models.items()}


def load_jax_params(models: Mapping[str, nn.Module],
                    params: Mapping[str, Any],
                    model_state: Optional[Mapping[str, Any]] = None) -> None:
    """Copy a JAX ``params`` tree ({name: tree}, numpy leaves), and its
    ``model_state`` tree where given, into the networks of the same names,
    in place, keeping each tensor's device and dtype. Every leaf must
    match a parameter or buffer and every parameter and buffer a leaf
    (``strict``): a batch-norm network needs its ``model_state``."""
    for name, model in models.items():
        flat = jax_params_to_torch(params[name])
        if model_state is not None:
            flat.update(jax_params_to_torch(model_state[name]))
        model.load_state_dict(flat, strict=True)
