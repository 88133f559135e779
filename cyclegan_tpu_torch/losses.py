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

A network family's losses (``get_losses``) take the train step's forward
set as its networks return it, and only they know the outputs' shape:
``(w, real_a, real_b, fake_a, fake_b, cycled_a, cycled_b, same_a, same_b,
disc_real_a, disc_real_b, disc_fake_a_gen, disc_fake_b_gen, disc_fake_a_d,
disc_fake_b_d) -> (surrogate, metrics)``. ``fake_a`` is g_BA(real_b),
``cycled_a`` g_BA(fake_b), ``same_a`` g_BA(real_a) (``_b`` the other way);
each ``disc_fake_*`` is a discriminator on its fake batch through the
generator view (``_gen``: parameters detached) and the discriminator view
(``_d``: fakes detached). The surrogate's gradient with respect to each
network is that of the network's own loss in ``metrics``.
"""

from __future__ import annotations

import functools
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


def get_losses(loss: str) -> Callable:
    """Name -> the family's losses over the forward set (the module
    docstring): ``ugatit_losses`` for ``ugatit``, else ``cyclegan_losses``
    with ``get_loss_obj(loss)``; KeyError on an unknown name."""
    if loss == UGATIT:
        return ugatit_losses
    return functools.partial(cyclegan_losses, get_loss_obj(loss))


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


def cyclegan_losses(loss_obj: LossFn, w, real_a, real_b, fake_a, fake_b,
                    cycled_a, cycled_b, same_a, same_b, disc_real_a,
                    disc_real_b, disc_fake_a_gen, disc_fake_b_gen,
                    disc_fake_a_d, disc_fake_b_d):
    """(surrogate, metrics) of the CycleGAN losses (cyclegan_tpu/steps.py
    ``_forward_losses``), every network output a tensor, cast to f32;
    ``loss_obj`` the adversarial loss, ``fake_a`` and ``fake_b`` unused."""
    f32 = lambda t: t.to(torch.float32)  # noqa: E731
    cycled_a, cycled_b = f32(cycled_a), f32(cycled_b)
    same_a, same_b = f32(same_a), f32(same_b)
    disc_real_a, disc_real_b = f32(disc_real_a), f32(disc_real_b)
    disc_fake_a_gen, disc_fake_b_gen = f32(disc_fake_a_gen), \
        f32(disc_fake_b_gen)
    disc_fake_a_d, disc_fake_b_d = f32(disc_fake_a_d), f32(disc_fake_b_d)

    gab_adv = generator_loss(disc_fake_b_gen, loss_obj, w["generator"])
    gba_adv = generator_loss(disc_fake_a_gen, loss_obj, w["generator"])
    total_cycle = (calc_cycle_loss(real_a, cycled_a, w["cycle"])
                   + calc_cycle_loss(real_b, cycled_b, w["cycle"]))
    id_a = identity_loss(real_a, same_a, w["identity"])
    id_b = identity_loss(real_b, same_b, w["identity"])
    da_loss = discriminator_loss(disc_real_a, disc_fake_a_d, loss_obj,
                                 w["discriminator"])
    db_loss = discriminator_loss(disc_real_b, disc_fake_b_d, loss_obj,
                                 w["discriminator"])
    surrogate = (gab_adv + gba_adv + total_cycle + id_a + id_b + da_loss
                 + db_loss)
    metrics = dict(
        gAB_loss=gab_adv + total_cycle + id_b,
        gBA_loss=gba_adv + total_cycle + id_a,
        dA_loss=da_loss,
        dB_loss=db_loss,
        dA_acc=accuracy(disc_real_a, disc_fake_a_d),
        dB_acc=accuracy(disc_real_b, disc_fake_b_d),
    )
    return surrogate, metrics


def ugatit_losses(w, real_a, real_b, fake_a, fake_b, cycled_a, cycled_b,
                  same_a, same_b, d_real_a, d_real_b, d_fake_a_gen,
                  d_fake_b_gen, d_fake_a_d, d_fake_b_d):
    """(surrogate, metrics) of U-GAT-IT's losses, in f32: each generator
    output is (image, CAM logits), each discriminator output its four
    outputs (global and local logits and CAM logits).

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

    cam_ab, cam_ba, cam_aa, cam_bb = (out[1].float() for out in (
        fake_b, fake_a, same_a, same_b))
    cycled_a, cycled_b, same_a, same_b = (out[0].float() for out in (
        cycled_a, cycled_b, same_a, same_b))
    d_real_a, d_real_b, d_fake_a_gen, d_fake_b_gen, d_fake_a_d, d_fake_b_d = (
        [t.float() for t in outs] for outs in (
            d_real_a, d_real_b, d_fake_a_gen, d_fake_b_gen, d_fake_a_d,
            d_fake_b_d))

    def lsq(outs, target):
        return sum(_mse(torch.full_like(y, target), y) for y in outs)

    def bce(logits, target):
        return _bce_from_logits(torch.full_like(logits, target), logits)

    cycle_a = _mae(real_a, cycled_a)
    cycle_b = _mae(real_b, cycled_b)
    g_loss_a = (adv * lsq(d_fake_a_gen, 1.0) + cyc * cycle_a
                + idw * _mae(real_a, same_a)
                + camw * (bce(cam_ba, 1.0) + bce(cam_aa, 0.0)))
    g_loss_b = (adv * lsq(d_fake_b_gen, 1.0) + cyc * cycle_b
                + idw * _mae(real_b, same_b)
                + camw * (bce(cam_ab, 1.0) + bce(cam_bb, 0.0)))
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
