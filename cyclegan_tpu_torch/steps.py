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

Options, as the JAX step's:

- ``fuse_apps``: where both generators are ``batchable``, each runs once
  on the batch-concatenated pair, ``g_AB([real_a; real_b])`` and
  ``g_BA([real_b; real_a])``, then on the fakes: 4 generator applications
  instead of 6, two of them at batch 2N.
- ``remat``: each generator application is recomputed in the backward
  (``torch.utils.checkpoint``, non-reentrant), and only those, as JAX
  checkpoints only ``g_ab`` / ``g_ba``. The recompute runs after the
  step's scopes have closed, so each checkpointed application re-enters
  the layout and the ``pallas_norm`` setting it first ran in, and takes
  its dropout masks as inputs, drawn before it.
- ``paired``: three ``torch.func.vmap``ped generator rounds and two
  ``vmap``ped discriminator views over parameters stacked as [g_AB, g_BA]
  and [d_A, d_B] (``_forward_losses_paired``), in NHWC whatever
  ``tpu_layout`` says and without ``fuse_apps``, as in JAX.
- dropout: a train step draws the generators' keep masks from the train
  state's ``dropout_generator`` (on the batch's device), per application,
  in the order the applications run; the discriminators and the validate
  step never drop out, as JAX passes them no key.
- ``make_train_multi_step``: K steps of (K, B, H, W, C) batches, the
  single step's body K times, metrics stacked along K (JAX's
  ``steps_per_call``; no CUDA-graph capture).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Mapping, Optional, Tuple

import torch
from torch import nn
from torch.func import functional_call, vmap
from torch.utils.checkpoint import checkpoint

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
    augmentation, the generator on the networks' device that draws the
    dropout masks, and the step count."""

    models: Dict[str, nn.Module]
    optimizers: Dict[str, torch.optim.Optimizer]
    generator: torch.Generator
    dropout_generator: torch.Generator
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
                      torch.Generator().manual_seed(seed),
                      torch.Generator(device=device).manual_seed(seed))


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


def _dropout_kw(masks) -> Dict[str, Any]:
    return {} if masks is None else {"masks": masks}


def _draw_masks(model: nn.Module, shape, generator: Optional[torch.Generator],
                lead: tuple = ()):
    """A generator application's dropout masks (``dropout_masks``), None
    without a generator or without dropout."""
    draw = getattr(model, "dropout_masks", None)
    if generator is None or draw is None:
        return None
    return draw(tuple(shape), generator, lead)


def _rematerialized(fn: Callable, *args):
    """``fn(*args)`` under a non-reentrant checkpoint whose recompute, run
    by autograd after the step's scopes have closed, re-enters the layout
    and ``pallas_norm`` setting of the first run."""
    name, norm = layout.current(), cuda_norm.is_enabled()

    def run(*inputs):
        with layout.scope(name), cuda_norm.scope(norm):
            return fn(*inputs)

    return checkpoint(run, *args, use_reentrant=False,
                      preserve_rng_state=False)


def _forward_losses(models: Mapping[str, nn.Module], loss_obj: Callable,
                    weights: Mapping[str, float], real_a: torch.Tensor,
                    real_b: torch.Tensor, compute_dtype: torch.dtype,
                    stop_grads: bool, tpu_layout: bool = True,
                    pallas_norm: bool = False, *, fuse_apps: bool = False,
                    remat: bool = False, paired: bool = False,
                    dropout: Optional[torch.Generator] = None
                    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The shared forward set and the losses (cyclegan_tpu/steps.py
    ``_forward_losses``, or ``_forward_losses_paired`` with ``paired``), in
    the NHCW layout with ``tpu_layout`` and in NHWC (K13 for the norms with
    ``pallas_norm``) without. ``real_a``, ``real_b``: NHWC f32 in [-1, 1];
    ``dropout``: the generator of the generators' dropout masks (None: no
    dropout). Returns (surrogate, metrics); with ``stop_grads`` the
    surrogate's gradient per network equals the reference's per-network
    gradient. Without, the two views of each fake batch are one
    application (validation and the reference gradients)."""
    if paired:
        with layout.nhwc(), cuda_norm.scope(pallas_norm):
            return _forward_losses_paired(models, loss_obj, weights, real_a,
                                          real_b, compute_dtype, stop_grads,
                                          remat, dropout)
    scope = layout.nhcw() if tpu_layout else layout.nhwc()
    with scope, cuda_norm.scope(pallas_norm):
        if tpu_layout:
            real_a = layout.to_nhcw(real_a)
            real_b = layout.to_nhcw(real_b)
        return _forward_losses_scoped(models, loss_obj, weights, real_a,
                                      real_b, compute_dtype, stop_grads,
                                      fuse_apps, remat, dropout)


def _cast_params(models, compute_dtype):
    """Each network's parameters cast to the compute dtype: the cast's
    backward lands the gradients on the f32 masters."""
    return {name: {k: p.to(compute_dtype)
                   for k, p in models[name].named_parameters()}
            for name in NETWORKS}


def _forward_losses_scoped(models, loss_obj, weights, real_a, real_b,
                           compute_dtype, stop_grads, fuse_apps=False,
                           remat=False, dropout=None):
    a_net = real_a.to(compute_dtype)
    b_net = real_b.to(compute_dtype)
    params = _cast_params(models, compute_dtype)

    def run(name, x):
        return functional_call(models[name], params[name], (x,))

    def gen(name, x):
        model = models[name]
        masks = _draw_masks(model, x.shape, dropout)

        def apply(x, *masks):
            return functional_call(model, params[name], (x,),
                                   _dropout_kw(list(masks) or None))

        if remat:
            return _rematerialized(apply, x, *(masks or ()))
        return apply(x, *(masks or ()))

    if fuse_apps and all(getattr(models[n], "batchable", False)
                         for n in ("g_AB", "g_BA")):
        n = a_net.shape[0]
        out_ab = gen("g_AB", torch.cat([a_net, b_net]))
        fake_b, same_b = out_ab[:n], out_ab[n:]
        out_ba = gen("g_BA", torch.cat([b_net, a_net]))
        fake_a, same_a = out_ba[:n], out_ba[n:]
        cycled_a = gen("g_BA", fake_b)
        cycled_b = gen("g_AB", fake_a)
    else:
        fake_b = gen("g_AB", a_net)
        cycled_a = gen("g_BA", fake_b)
        fake_a = gen("g_BA", b_net)
        cycled_b = gen("g_AB", fake_a)
        same_a = gen("g_BA", a_net)
        same_b = gen("g_AB", b_net)

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
    return _losses(loss_obj, weights, real_a, real_b, cycled_a, cycled_b,
                   same_a, same_b, disc_real_a, disc_real_b,
                   disc_fake_a_gen, disc_fake_b_gen, disc_fake_a_d,
                   disc_fake_b_d)


def _forward_losses_paired(models, loss_obj, weights, real_a, real_b,
                           compute_dtype, stop_grads, remat=False,
                           dropout=None):
    """The paired twin step (cyclegan_tpu/steps.py
    ``_forward_losses_paired``), in the NHWC scope its caller opens: g_AB
    and g_BA (d_A and d_B) share an architecture, so each pair of
    applications is one ``vmap`` over their stacked parameters, which the
    library convolution runs as one grouped convolution and K13 per
    member. Generator rounds [g_AB(real_a), g_BA(real_b)],
    [g_AB(fake_a), g_BA(fake_b)], [g_AB(real_b), g_BA(real_a)]; the
    discriminators on the stacked reals and, as two applications (the
    generator and the discriminator view), on the stacked fakes."""
    a_net = real_a.to(compute_dtype)
    b_net = real_b.to(compute_dtype)
    params = _cast_params(models, compute_dtype)

    def stack(first, second):
        return {k: torch.stack([params[first][k], params[second][k]])
                for k in params[first]}

    pg, pd = stack("g_AB", "g_BA"), stack("d_A", "d_B")
    g_model, d_model = models["g_AB"], models["d_A"]

    def g_apply(p, x, masks):
        return functional_call(g_model, p, (x,), _dropout_kw(masks))

    def d_apply(p, x):
        return functional_call(d_model, p, (x,))

    def round_(first, second):
        x = torch.stack([first, second])
        masks = _draw_masks(g_model, first.shape, dropout, lead=(2,))
        vg = vmap(g_apply, in_dims=(0, 0, None if masks is None else 0))
        if remat:
            return _rematerialized(lambda x, *m: vg(pg, x, list(m) or None),
                                   x, *(masks or ()))
        return vg(pg, x, masks)

    vd = vmap(d_apply)
    fake_b, fake_a = round_(a_net, b_net).unbind(0)
    cycled_b, cycled_a = round_(fake_a, fake_b).unbind(0)
    same_b, same_a = round_(b_net, a_net).unbind(0)

    fakes = torch.stack([fake_a, fake_b])
    disc_real_a, disc_real_b = vd(pd, torch.stack([a_net, b_net])).unbind(0)
    if stop_grads:
        frozen = {k: v.detach() for k, v in pd.items()}
        d_fake_gen = vd(frozen, fakes)
        d_fake_d = vd(pd, fakes.detach())
    else:
        d_fake_gen = d_fake_d = vd(pd, fakes)
    disc_fake_a_gen, disc_fake_b_gen = d_fake_gen.unbind(0)
    disc_fake_a_d, disc_fake_b_d = d_fake_d.unbind(0)
    return _losses(loss_obj, weights, real_a, real_b, cycled_a, cycled_b,
                   same_a, same_b, disc_real_a, disc_real_b,
                   disc_fake_a_gen, disc_fake_b_gen, disc_fake_a_d,
                   disc_fake_b_d)


def _losses(loss_obj, w, real_a, real_b, cycled_a, cycled_b, same_a, same_b,
            disc_real_a, disc_real_b, disc_fake_a_gen, disc_fake_b_gen,
            disc_fake_a_d, disc_fake_b_d):
    """(surrogate, metrics) from the forward set's outputs, in f32."""
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


def _weights(loss_weights: Mapping[str, float]) -> Dict[str, float]:
    return {k: float(v) for k, v in dict(loss_weights).items()}


def make_train_step(loss_name: str, loss_weights: Mapping[str, float],
                    compute_dtype: str = "float32",
                    preprocess: Optional[Callable] = None,
                    tpu_layout: bool = True,
                    pallas_norm: bool = False, remat: bool = False,
                    paired: bool = False,
                    fuse_apps: bool = False) -> Callable:
    """The train step ``(state, real_a, real_b) -> metrics``: preprocess
    (``preprocess(generator, a, b) -> (a, b)``, e.g. the jitter), one
    forward set in the layout ``tpu_layout`` picks (with the options of
    the module docstring), ONE backward, four optimizer updates, in place
    on ``state``. After it each parameter's ``.grad`` holds the step's
    gradient. Metrics are detached f32 scalars on the batch's device; the
    step never waits for the card."""
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
            stop_grads=True, tpu_layout=tpu_layout, pallas_norm=pallas_norm,
            fuse_apps=fuse_apps, remat=remat, paired=paired,
            dropout=state.dropout_generator)
        surrogate.backward()
        for name in NETWORKS:
            state.optimizers[name].step()
        state.step += 1
        return {k: v.detach() for k, v in metrics.items()}

    return train_step


def make_train_multi_step(loss_name: str, loss_weights: Mapping[str, float],
                          compute_dtype: str = "float32",
                          preprocess: Optional[Callable] = None,
                          **options) -> Callable:
    """K train steps per call (cyclegan_tpu/steps.py
    ``make_train_multi_step``): ``(state, real_a, real_b) -> metrics``
    with (K, B, H, W, C) batches runs ``make_train_step``'s step (same
    ``options``) on each of the K batch pairs in turn and returns each
    metric stacked along a leading K axis. The per-step math, generator
    draws included, is that of K single steps."""
    single = make_train_step(loss_name, loss_weights, compute_dtype,
                             preprocess, **options)

    def multi_step(state: TrainState, real_a: torch.Tensor,
                   real_b: torch.Tensor) -> Dict[str, torch.Tensor]:
        if real_a.shape[0] != real_b.shape[0] or real_a.dim() != 5:
            raise ValueError(f"multi step takes (K, B, H, W, C) batches of "
                             f"one K, got {tuple(real_a.shape)} and "
                             f"{tuple(real_b.shape)}")
        steps = [single(state, a, b) for a, b in zip(real_a, real_b)]
        return {k: torch.stack([m[k] for m in steps]) for k in steps[0]}

    return multi_step


def make_validate_step(loss_name: str, loss_weights: Mapping[str, float],
                       compute_dtype: str = "float32",
                       preprocess: Optional[Callable] = None,
                       tpu_layout: bool = True,
                       pallas_norm: bool = False,
                       fuse_apps: bool = False) -> Callable:
    """The eval step ``(state, real_a, real_b) -> metrics``: the forward
    set without stop-gradients, dropout or a backward (4 discriminator
    applications), in the layout ``tpu_layout`` picks, ``fuse_apps`` as
    the train step's; ``preprocess(images)`` (e.g.
    ``prepare_eval_batch``) runs first on each batch."""
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
                                     pallas_norm=pallas_norm,
                                     fuse_apps=fuse_apps)
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
