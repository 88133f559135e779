"""Pre- and post-processing of image batches
(cyclegan_tpu/data/augment.py ``normalize``, ``denormalize_to_uint8``)."""

from __future__ import annotations

import torch


def normalize(images: torch.Tensor) -> torch.Tensor:
    """uint8/float [0, 255] -> float32 [-1, 1]."""
    return images.to(torch.float32) / 127.5 - 1.0


def denormalize_to_uint8(images: torch.Tensor) -> torch.Tensor:
    """[-1, 1] -> uint8 [0, 255], rounded to nearest (half to even, as
    ``jnp.round``), then clipped."""
    scaled = torch.round((images + 1.0) * 127.5)
    return torch.clamp(scaled, 0, 255).to(torch.uint8)
