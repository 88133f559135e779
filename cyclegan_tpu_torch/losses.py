"""CycleGAN losses (cyclegan_tpu/losses.py; reference cyclegan/losses.py).

Adversarial losses by name: "mse" (LSGAN), "mae", "bce" from logits; the
cycle-consistency and identity losses are weighted L1 means. Every
reduction is a full mean in f32: the train step casts the networks' bf16
outputs to f32 before any loss.
"""

from __future__ import annotations

from typing import Callable

import torch

LossFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


def _mse(y_true: torch.Tensor, y_pred: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.square(y_true - y_pred))


def _mae(y_true: torch.Tensor, y_pred: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.abs(y_true - y_pred))


def _bce_from_logits(y_true: torch.Tensor,
                     logits: torch.Tensor) -> torch.Tensor:
    """Numerically stable sigmoid cross-entropy, as Keras'
    ``BinaryCrossentropy(from_logits=True)``."""
    per_elem = (torch.clamp(logits, min=0.0) - logits * y_true
                + torch.log1p(torch.exp(-torch.abs(logits))))
    return torch.mean(per_elem)


_LOSS_OBJ_MAPS = {"mse": _mse, "mae": _mae, "bce": _bce_from_logits}


def get_loss_obj(loss: str) -> LossFn:
    """Name -> adversarial loss; KeyError on an unknown name."""
    return _LOSS_OBJ_MAPS[loss]


def calc_cycle_loss(real_image, cycled_image, weight=10.0):
    """Weighted L1 cycle-consistency loss."""
    return weight * torch.mean(torch.abs(real_image - cycled_image))


def generator_loss(generated, loss_obj: LossFn, weight: float):
    """Adversarial generator loss against an all-ones target."""
    return weight * loss_obj(torch.ones_like(generated), generated)


def identity_loss(real_image, same_image, weight=5.0):
    """Weighted L1 identity-mapping loss."""
    return weight * torch.mean(torch.abs(real_image - same_image))


def discriminator_loss(real, generated, loss_obj: LossFn, weight: float):
    """Real-vs-ones plus fake-vs-zeros discriminator loss."""
    real_loss = loss_obj(torch.ones_like(real), real)
    generated_loss = loss_obj(torch.zeros_like(generated), generated)
    return weight * (real_loss + generated_loss)


def accuracy(real, fake):
    """Share of the discriminator's outputs on the correct side of 0.5
    (real above, fake at or below), over both batches."""
    predictions = (torch.cat([real, fake], dim=0) > 0.5).to(torch.float32)
    labels = torch.cat([torch.ones_like(real), torch.zeros_like(fake)],
                       dim=0).to(torch.float32)
    return torch.mean((predictions == labels).to(torch.float32))
