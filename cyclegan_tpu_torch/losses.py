"""CycleGAN losses (cyclegan_tpu/losses.py; reference cyclegan/losses.py).

Adversarial losses by name: "mse" (LSGAN), "mae", "bce" from logits; the
cycle-consistency and identity losses are weighted L1 means. Every
reduction is a full mean in f32: the train step casts the networks' bf16
outputs to f32 before any loss.

``loss: ugatit`` is U-GAT-IT's set (the authors' ``UGATIT.py``,
``ugatit_losses``): least squares on each discriminator's four outputs
(global and local logits and CAM logits), the generators' CAM logits as
BCE from logits (translation target 1, identity target 0), L1 cycle and
identity; weights ``adversarial``, ``cycle``, ``identity``, ``cam``.
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
UGATIT = "ugatit"


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


def ugatit_losses(w, real_a, real_b, cycled_a, cycled_b, same_a, same_b,
                  cams, d_real_a, d_real_b, d_fake_a_gen, d_fake_b_gen,
                  d_fake_a_d, d_fake_b_d):
    """(surrogate, metrics) of U-GAT-IT's losses, every input f32. ``cams``:
    the generators' CAM logits (``ab`` of g_AB(a), ``ba`` of g_BA(b), ``aa``
    of g_BA(a), ``bb`` of g_AB(b)); each ``d_*`` a discriminator's four
    outputs, the fakes' through the generator view (``_gen``: parameters
    detached) and the discriminator view (``_d``: fakes detached).

    G_loss_A = adv (sum of d_A's four least squares on g_BA(b) against 1)
    + cycle |g_BA(g_AB(a)) - a| + identity |g_BA(a) - a| + cam (BCE of
    g_BA(b)'s CAM against 1 and g_BA(a)'s against 0); G_loss_B the same the
    other way. ``gAB_loss`` is G_loss_B plus A's cycle term, whose gradient
    reaches g_AB too (``gBA_loss`` likewise), so each generator's gradient
    is that of its metric; ``dA_loss`` = adv (d_A's four outputs: reals
    against 1, fakes against 0). The surrogate G_loss_A + G_loss_B +
    dA_loss + dB_loss has each network's gradient."""
    adv, cyc, idw, camw = (w["adversarial"], w["cycle"], w["identity"],
                           w["cam"])

    def lsq(outs, target):
        return sum(_mse(torch.full_like(y, target), y) for y in outs)

    def bce(logits, target):
        return _bce_from_logits(torch.full_like(logits, target), logits)

    cycle_a = _mae(real_a, cycled_a)
    cycle_b = _mae(real_b, cycled_b)
    g_loss_a = (adv * lsq(d_fake_a_gen, 1.0) + cyc * cycle_a
                + idw * _mae(real_a, same_a)
                + camw * (bce(cams["ba"], 1.0) + bce(cams["aa"], 0.0)))
    g_loss_b = (adv * lsq(d_fake_b_gen, 1.0) + cyc * cycle_b
                + idw * _mae(real_b, same_b)
                + camw * (bce(cams["ab"], 1.0) + bce(cams["bb"], 0.0)))
    da_loss = adv * (lsq(d_real_a, 1.0) + lsq(d_fake_a_d, 0.0))
    db_loss = adv * (lsq(d_real_b, 1.0) + lsq(d_fake_b_d, 0.0))
    metrics = dict(
        gAB_loss=g_loss_b + cyc * cycle_a,
        gBA_loss=g_loss_a + cyc * cycle_b,
        dA_loss=da_loss,
        dB_loss=db_loss,
        dA_acc=accuracy(d_real_a[0], d_fake_a_d[0]),
        dB_acc=accuracy(d_real_b[0], d_fake_b_d[0]),
    )
    return g_loss_a + g_loss_b + da_loss + db_loss, metrics
