"""Model type name -> builder (cyclegan_tpu/models/registry.py)."""

from __future__ import annotations

from typing import Any, Mapping, Optional

import torch
from torch import nn

from cyclegan_tpu_torch.models.resnet import (
    ResNetGenerator,
    SimpleDiscriminator,
)
from cyclegan_tpu_torch.models.unet import UNetGenerator

_BUILDERS = {
    "unet_generator": UNetGenerator,
    "resnet_generator": ResNetGenerator,
    "simple_discriminator": SimpleDiscriminator,
}
_NOT_YET = ("strided_unet",)


def create_model(config: Mapping[str, Any],
                 generator: Optional[torch.Generator] = None) -> nn.Module:
    """Build a model from its config's ``type``. A type of the JAX package
    that is not ported yet raises NotImplementedError; an unknown type
    raises KeyError."""
    kind = config["type"]
    if kind in _BUILDERS:
        return _BUILDERS[kind](config, generator)
    if kind in _NOT_YET:
        raise NotImplementedError(
            f"model type {kind!r} is not ported yet (ROADMAP.md queue 1, "
            f"item 'the other recipes')")
    raise KeyError(kind)
