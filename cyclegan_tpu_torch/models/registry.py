"""Model type name -> builder (cyclegan_tpu/models/registry.py)."""

from __future__ import annotations

from typing import Any, Mapping, Optional

import torch
from torch import nn

from cyclegan_tpu_torch.models.resnet import (
    ResNetGenerator,
    SimpleDiscriminator,
)
from cyclegan_tpu_torch.models.unet import StridedUNet, UNetGenerator

_BUILDERS = {
    "unet_generator": UNetGenerator,
    "strided_unet": StridedUNet,
    "resnet_generator": ResNetGenerator,
    "simple_discriminator": SimpleDiscriminator,
}


def create_model(config: Mapping[str, Any],
                 generator: Optional[torch.Generator] = None) -> nn.Module:
    """Build a model from its config's ``type``; an unknown type raises
    KeyError. Every type of the JAX package is ported; a config option that
    is not (batch norm, dropout in training) raises NotImplementedError."""
    return _BUILDERS[config["type"]](config, generator)
