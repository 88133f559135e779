"""Activations by their Keras names (cyclegan_tpu/ops/activations.py)."""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def leaky_relu(x: torch.Tensor, alpha: float = 0.2) -> torch.Tensor:
    return F.leaky_relu(x, negative_slope=alpha)


_ACTIVATIONS = {
    "relu": torch.relu,
    "tanh": torch.tanh,
    "sigmoid": torch.sigmoid,
    "linear": lambda x: x,
    "leaky_relu": leaky_relu,
}


def apply_activation(x: torch.Tensor, name: Optional[str]) -> torch.Tensor:
    """None or 'linear' is the identity; an unknown name raises KeyError."""
    if name is None:
        return x
    return _ACTIVATIONS[name](x)
