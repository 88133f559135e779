"""Pre- and post-processing of image batches (cyclegan_tpu/data/augment.py).

The train-time jitter runs on the batch's device: bilinear resize to
size + 50, then a per-sample random crop back to size and a random
horizontal flip. The crop offsets and flips are drawn on the host from an
explicit ``torch.Generator``, so drawing them never waits for the card.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from cyclegan_tpu_torch.ops.resize import resize_bilinear

JITTER_PAD = 50  # resize to (size + 50) before cropping


def normalize(images: torch.Tensor) -> torch.Tensor:
    """uint8/float [0, 255] -> float32 [-1, 1]."""
    return images.to(torch.float32) / 127.5 - 1.0


def denormalize_to_uint8(images: torch.Tensor) -> torch.Tensor:
    """[-1, 1] -> uint8 [0, 255], rounded to nearest (half to even, as
    ``jnp.round``), then clipped."""
    scaled = torch.round((images + 1.0) * 127.5)
    return torch.clamp(scaled, 0, 255).to(torch.uint8)


def draw_jitter(generator: Optional[torch.Generator],
                batch: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-sample crop offsets (row, column), int64 [B, 2] in
    [0, JITTER_PAD], and horizontal flips, bool [B], on the CPU."""
    offsets = torch.randint(0, JITTER_PAD + 1, (batch, 2),
                            generator=generator)
    flips = torch.rand(batch, generator=generator) < 0.5
    return offsets, flips


def jitter_batch(images: torch.Tensor, image_size: int,
                 offsets: torch.Tensor, flips: torch.Tensor) -> torch.Tensor:
    """NHWC uint8 or [-1, 1] float -> [-1, 1] float32 (B, size, size, C):
    resize to size + 50, crop each sample at its offsets, flip it where
    asked. The resize is linear, so normalizing first is the reference's
    normalize-then-jitter order."""
    images = normalize(images) if images.dtype == torch.uint8 else images
    big = image_size + JITTER_PAD
    enlarged = resize_bilinear(images, big, big)
    crops = []
    for sample, (top, left), flip in zip(enlarged, offsets.tolist(),
                                         flips.tolist()):
        crop = sample[top:top + image_size, left:left + image_size]
        crops.append(crop.flip(1) if flip else crop)
    return torch.stack(crops)


def random_jitter_batch(generator: Optional[torch.Generator],
                        images: torch.Tensor,
                        image_size: int) -> torch.Tensor:
    """Train-time augmentation: ``jitter_batch`` at offsets and flips
    drawn from ``generator``."""
    offsets, flips = draw_jitter(generator, images.shape[0])
    return jitter_batch(images, image_size, offsets, flips)


def prepare_eval_batch(images: torch.Tensor) -> torch.Tensor:
    """Validation: normalize only (no jitter)."""
    return normalize(images) if images.dtype == torch.uint8 else images
