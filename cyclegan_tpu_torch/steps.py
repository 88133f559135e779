"""CycleGAN train and validate steps (cyclegan_tpu/steps.py).

One train step is the reference's: 6 generator applications, the
discriminators on the real and the fake images, the losses in f32, and ONE
backward of a surrogate scalar whose gradient with respect to each network
equals the reference's four ``tape.gradient`` calls:

- the adversarial generator terms see the discriminators through parameters
  detached from the graph (the generator view), so they update only the
  generators;
- the discriminator terms see the fake images detached (the discriminator
  view), so they update only the discriminators;
- the shared cycle term appears once and flows into both generators.

The JAX package shares one discriminator forward between the two views of
each fake batch with a dual-view custom VJP, whose dead halves XLA drops.
A PyTorch autograd Function fixes which of its inputs need gradients at
forward time, so one shared forward would still run every dX and dW of
both backward views. The port runs the two views as two applications
instead (6 discriminator forwards per step against JAX's 4), and each
application's kernels then skip exactly the dead half: no dW under the
generator view, no input gradient of the first conv under the
discriminator view.

Mixed precision as in JAX: with ``compute_dtype="bfloat16"`` the f32 master
parameters are cast to bf16 inside the differentiated function (the cast's
backward lands the gradients on the masters in f32), the networks run in
bf16, and every loss is computed in f32.

Layout (JAX ``steps.py`` ``tpu_layout``): with ``tpu_layout`` the networks
run on NHCW activations, one transpose of each input batch away, through
the kernels K1-K12; without, on the NHWC batch as it comes, through the
library convolutions and torch ops, with ``pallas_norm`` sending every
instance norm to K13. Both are scoped to the step's forward (the backward
of each op is fixed when the forward runs); the losses are layout-free
means. The port's steps default to ``tpu_layout=True``, its kernel path;
the JAX package's default is the other layout.

Not ported yet (ROADMAP.md queue 1, item 2): ``fuse_apps``, ``paired``,
``remat``, ``steps_per_call``, meshes.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Mapping, Optional, Tuple

import torch
from torch import nn
from torch.func import functional_call

from cyclegan_tpu_torch.losses import (
    accuracy,
    calc_cycle_loss,
    discriminator_loss,
    generator_loss,
    get_loss_obj,
    identity_loss,
)
from cyclegan_tpu_torch.models import create_model
from cyclegan_tpu_torch.ops import cuda_norm, layout
from cyclegan_tpu_torch.optimizers import get_optimizer

NETWORKS = ("g_AB", "g_BA", "d_A", "d_B")
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
_METRIC_OF = {"g_AB": "gAB_loss", "g_BA": "gBA_loss", "d_A": "dA_loss",
              "d_B": "dB_loss"}


@dataclasses.dataclass
class TrainState:
    """Everything one training run updates: the four networks (f32 master
    parameters), their optimizers, the host generator that draws the
    augmentation, and the step count."""

    models: Dict[str, nn.Module]
    optimizers: Dict[str, torch.optim.Optimizer]
    generator: torch.Generator
    step: int = 0


def build_models(model_config: Mapping[str, Any],
                 seed: int = 0) -> Dict[str, nn.Module]:
    """The two generators and the two discriminators of a model config,
    initialized from one seed."""
    gen = torch.Generator().manual_seed(seed)
    return {name: create_model(
        model_config["generator" if name.startswith("g") else
                     "discriminator"], gen) for name in NETWORKS}


def init_train_state(models: Mapping[str, nn.Module],
                     train_config: Mapping[str, Any], seed: int = 0,
                     device: Any = "cuda") -> TrainState:
    """Move the networks to ``device`` in training mode and give each its
    optimizer (``g_opt`` for the generators, ``d_opt`` for the
    discriminators). ``device`` defaults to ``cuda`` and raises where there
    is no card; pass ``"cpu"`` to run the plain versions of the kernels."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("init_train_state: no CUDA device; pass "
                           "device='cpu' to run on the CPU")
    models = {name: models[name].to(device=device, dtype=torch.float32)
              .train() for name in NETWORKS}
    optimizers = {name: get_optimizer(
        train_config["g_opt" if name.startswith("g") else "d_opt"],
        models[name].parameters()) for name in NETWORKS}
    return TrainState(models, optimizers,
                      torch.Generator().manual_seed(seed))


def disc_views(model: nn.Module, params: Mapping[str, torch.Tensor],
               x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The two gradient views of one discriminator on one fake batch
    (cyclegan_tpu/steps.py ``_dual_disc_views``), as two applications:
    ``y_gen = d(stop_grad(params), x)`` pulls its cotangent back only into
    ``x``, ``y_d = d(params, stop_grad(x))`` only into the parameters.
    Forward-identical; each application's kernels skip the dead half."""
    frozen = {k: v.detach() for k, v in params.items()}
    return (functional_call(model, frozen, (x,)),
            functional_call(model, dict(params), (x.detach(),)))


def _forward_losses(models: Mapping[str, nn.Module], loss_obj: Callable,
                    weights: Mapping[str, float], real_a: torch.Tensor,
                    real_b: torch.Tensor, compute_dtype: torch.dtype,
                    stop_grads: bool, tpu_layout: bool = True,
                    pallas_norm: bool = False
                    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The shared forward set and the losses (cyclegan_tpu/steps.py
    ``_forward_losses``, unfused, unpaired, no remat), in the NHCW layout
    with ``tpu_layout`` and in NHWC (K13 for the norms with
    ``pallas_norm``) without. ``real_a``, ``real_b``: NHWC f32 in [-1, 1].
    Returns (surrogate, metrics); with ``stop_grads`` the surrogate's
    gradient per network equals the reference's per-network gradient.
    Without, the two views of each fake batch are one application
    (validation and the reference gradients)."""
    scope = layout.nhcw() if tpu_layout else layout.nhwc()
    with scope, cuda_norm.scope(pallas_norm):
        if tpu_layout:
            real_a = layout.to_nhcw(real_a)
            real_b = layout.to_nhcw(real_b)
        return _forward_losses_scoped(models, loss_obj, weights, real_a,
                                      real_b, compute_dtype, stop_grads)


def _forward_losses_scoped(models, loss_obj, weights, real_a, real_b,
                           compute_dtype, stop_grads):
    a_net = real_a.to(compute_dtype)
    b_net = real_b.to(compute_dtype)
    params = {name: {k: p.to(compute_dtype)
                     for k, p in models[name].named_parameters()}
              for name in NETWORKS}

    def run(name, x):
        return functional_call(models[name], params[name], (x,))

    fake_b = run("g_AB", a_net)
    cycled_a = run("g_BA", fake_b)
    fake_a = run("g_BA", b_net)
    cycled_b = run("g_AB", fake_a)
    same_a = run("g_BA", a_net)
    same_b = run("g_AB", b_net)

    disc_real_a = run("d_A", a_net)
    disc_real_b = run("d_B", b_net)
    if stop_grads:
        disc_fake_a_gen, disc_fake_a_d = disc_views(models["d_A"],
                                                    params["d_A"], fake_a)
        disc_fake_b_gen, disc_fake_b_d = disc_views(models["d_B"],
                                                    params["d_B"], fake_b)
    else:
        disc_fake_a_gen = disc_fake_a_d = run("d_A", fake_a)
        disc_fake_b_gen = disc_fake_b_d = run("d_B", fake_b)

    f32 = lambda t: t.to(torch.float32)  # noqa: E731
    cycled_a, cycled_b = f32(cycled_a), f32(cycled_b)
    same_a, same_b = f32(same_a), f32(same_b)
    disc_real_a, disc_real_b = f32(disc_real_a), f32(disc_real_b)
    disc_fake_a_gen, disc_fake_b_gen = f32(disc_fake_a_gen), \
        f32(disc_fake_b_gen)
    disc_fake_a_d, disc_fake_b_d = f32(disc_fake_a_d), f32(disc_fake_b_d)

    w = weights
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


def _weights(loss_weights: Mapping[str, float]) -> Dict[str, float]:
    return {k: float(v) for k, v in dict(loss_weights).items()}


def make_train_step(loss_name: str, loss_weights: Mapping[str, float],
                    compute_dtype: str = "float32",
                    preprocess: Optional[Callable] = None,
                    tpu_layout: bool = True,
                    pallas_norm: bool = False) -> Callable:
    """The train step ``(state, real_a, real_b) -> metrics``: preprocess
    (``preprocess(generator, a, b) -> (a, b)``, e.g. the jitter), one
    forward set in the layout ``tpu_layout`` picks, ONE backward, four
    optimizer updates, in place on ``state``. After it each parameter's
    ``.grad`` holds the step's gradient. Metrics are detached f32 scalars
    on the batch's device; the step never waits for the card."""
    loss_obj = get_loss_obj(loss_name)
    weights = _weights(loss_weights)
    cdtype = DTYPES[compute_dtype]

    def train_step(state: TrainState, real_a: torch.Tensor,
                   real_b: torch.Tensor) -> Dict[str, torch.Tensor]:
        if preprocess is not None:
            real_a, real_b = preprocess(state.generator, real_a, real_b)
        for opt in state.optimizers.values():
            opt.zero_grad(set_to_none=True)
        surrogate, metrics = _forward_losses(
            state.models, loss_obj, weights, real_a, real_b, cdtype,
            stop_grads=True, tpu_layout=tpu_layout, pallas_norm=pallas_norm)
        surrogate.backward()
        for name in NETWORKS:
            state.optimizers[name].step()
        state.step += 1
        return {k: v.detach() for k, v in metrics.items()}

    return train_step


def make_validate_step(loss_name: str, loss_weights: Mapping[str, float],
                       compute_dtype: str = "float32",
                       preprocess: Optional[Callable] = None,
                       tpu_layout: bool = True,
                       pallas_norm: bool = False) -> Callable:
    """The eval step ``(state, real_a, real_b) -> metrics``: the forward
    set without stop-gradients and without a backward (4 discriminator
    applications), in the layout ``tpu_layout`` picks;
    ``preprocess(images)`` (e.g. ``prepare_eval_batch``) runs first on each
    batch."""
    loss_obj = get_loss_obj(loss_name)
    weights = _weights(loss_weights)
    cdtype = DTYPES[compute_dtype]

    @torch.no_grad()
    def validate_step(state: TrainState, real_a: torch.Tensor,
                      real_b: torch.Tensor) -> Dict[str, torch.Tensor]:
        if preprocess is not None:
            real_a, real_b = preprocess(real_a), preprocess(real_b)
        _, metrics = _forward_losses(state.models, loss_obj, weights,
                                     real_a, real_b, cdtype,
                                     stop_grads=False, tpu_layout=tpu_layout,
                                     pallas_norm=pallas_norm)
        return metrics

    return validate_step


def reference_gradients(models: Mapping[str, nn.Module], loss_name: str,
                        loss_weights: Mapping[str, float],
                        real_a: torch.Tensor, real_b: torch.Tensor
                        ) -> Dict[str, Dict[str, torch.Tensor]]:
    """The naive four-backward gradients, as the reference's four
    ``tape.gradient`` calls compute them (cyclegan_tpu/steps.py
    ``reference_gradients``): one f32 forward without stop-gradients, then
    each network's own total loss differentiated with respect to that
    network alone. For the tests."""
    _, metrics = _forward_losses(models, get_loss_obj(loss_name),
                                 _weights(loss_weights), real_a, real_b,
                                 torch.float32, stop_grads=False)
    grads = {}
    for name in NETWORKS:
        named = list(models[name].named_parameters())
        values = torch.autograd.grad(metrics[_METRIC_OF[name]],
                                     [p for _, p in named],
                                     retain_graph=True)
        grads[name] = {k: g for (k, _), g in zip(named, values)}
    return grads
