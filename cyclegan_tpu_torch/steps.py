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
  single step K times (each through its graph where the step takes one),
  metrics stacked along K (JAX's ``steps_per_call``).

CUDA graph (``make_train_step``): on a card, the second call of an input
shape captures one graph of the step's ``zero_grad``, forward set, f32
losses and backward (``_grads``), and every call of that shape replays it:
the host launches a step's 800-odd kernels once. The jitter before it and
the optimizer updates and batch-stat commit after it stay eager, as does
the whole step where the graph would not hold (``make_train_step``).

Network families: every family runs the one forward set above, each
network's output passed on as the network returns it, and the family's
losses (``losses.get_losses`` of the loss name) are the only code that
knows the outputs' shape. U-GAT-IT (``loss: ugatit``,
``models/ugatit.py``): each generator returns (image, CAM logits), each
discriminator four outputs, and the losses are ``losses.ugatit_losses``;
each discriminator application in a train step runs one power iteration
per spectral-normalised weight, an in-place write of its ``u`` buffer
that the step's CUDA graph replays (the validate step runs the networks
in eval mode: no iteration). After the optimizer updates every generator
``rho`` is clipped into [0, 1]. A mesh, ``paired``, ``fuse_apps`` and
``remat`` are refused for it.

Batch norm (``normalization: batchnorm``): every application of a train
step normalizes with its own batch's statistics, and all of them read the
same old moving statistics (``ops/norm.py`` ``batch_stats``). As in JAX
(``steps.py`` ``_forward_losses``' ``new_model_state``), one
application's new moving statistics are kept per network and committed
once, after the optimizer updates: g_AB's cycle pass ``g_AB(fake_a)``,
g_BA's translation pass ``g_BA(real_b)``, each discriminator's
application to the fake batch (the parameter view of ``disc_views``);
identity and real-batch passes, the recompute of ``remat`` and the
``paired`` step (which keeps the old statistics, as JAX's does) commit
nothing. The validate step normalizes with the moving statistics.

Parallelism (JAX ``steps.py`` ``mesh``, ``mesh_axis``, ``spatial_axis``,
``shard_map_dp``): with a ``parallel.Mesh`` each rank runs the step on its
block of the batch, its data slice and, with a spatial axis of more than
one rank, its H strip (``ops/spatialctx.py``: conv halos and norm sums
exchanged explicitly, the kernels on local blocks). After the one backward,
every gradient, flattened into one buffer, is summed over the mesh with
one ``all_reduce`` and divided by its size, and so are the metrics: JAX's
``pmean`` over the data and spatial axes. There is no DDP wrapper: the step
applies each network several times before its one backward. Random draws,
as JAX draws them: without ``shard_map_dp`` each data rank draws the whole
global batch's jitter (and dropout masks, over the whole image) from the
state's generators and keeps its own rows, which is the single-device
draw; with it, each rank's per-step generators are derived from one draw
of the state's and its data index (its data and spatial index for the
dropout masks, so strips differ). The spatial ranks of one sample gather
its H axis, jitter the whole images identically and keep their strips
(a strip of a resized image is not the resize of a strip). A train-mode
batch norm's statistics span the whole mesh without ``shard_map_dp`` (the
global batch's, as JAX's sharded mean gives) and one data shard's strips
with it (JAX's per-shard statistics); with it and more than one data
rank, rank 0's new moving statistics are broadcast, so the replicas stay
equal (JAX's shard_map returns one shard's). Spatial sharding with
``tpu_layout`` needs ``shard_map_dp``, as in JAX
(``_check_spatial_kernel_exclusion``). ``paired`` runs under a spatial
axis too: its ``vmap`` maps over the strip's collectives, which fold the
twins into the batch and run once (``ops/spatialctx.py``).
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import math
from typing import Any, Callable, Dict, Mapping, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch import nn
from torch.func import functional_call, vmap
from torch.utils.checkpoint import checkpoint

from cyclegan_tpu_torch import kernels, tracing
from cyclegan_tpu_torch.losses import UGATIT, get_losses
from cyclegan_tpu_torch.models import create_model, generated_image
from cyclegan_tpu_torch.ops import cuda_norm, layout, spatialctx
from cyclegan_tpu_torch.ops import norm as norm_ops
from cyclegan_tpu_torch.optimizers import get_optimizer
from cyclegan_tpu_torch.parallel import spatial as spatial_mesh

NETWORKS = ("g_AB", "g_BA", "d_A", "d_B")
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
_METRIC_OF = {"g_AB": "gAB_loss", "g_BA": "gBA_loss", "d_A": "dA_loss",
              "d_B": "dB_loss"}


@dataclasses.dataclass
class TrainState:
    """Everything one training run updates: the four networks (f32 master
    parameters, and a batch norm's f32 moving statistics as buffers),
    their optimizers, the host generator that draws the
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
               x: torch.Tensor, sink: Optional[dict] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The two gradient views of one discriminator on one fake batch
    (cyclegan_tpu/steps.py ``_dual_disc_views``), as two applications:
    ``y_gen = d(stop_grad(params), x)`` pulls its cotangent back only into
    ``x``, ``y_d = d(params, stop_grad(x))`` only into the parameters.
    Forward-identical; each application's kernels skip the dead half. A
    batch norm's new statistics go to ``sink`` from the second."""
    frozen = {k: v.detach() for k, v in params.items()}
    y_gen = functional_call(model, frozen, (x,))
    with _keeping(sink):
        return y_gen, functional_call(model, dict(params), (x.detach(),))


def _keeping(sink: Optional[dict]):
    """The scope of an application whose batch-norm statistics are kept
    (into ``sink``), in train mode; none where ``sink`` is None."""
    if sink is None:
        return contextlib.nullcontext()
    return norm_ops.batch_stats(True, sink)


def _dropout_kw(masks) -> Dict[str, Any]:
    return {} if masks is None else {"masks": masks}


def _draw_masks(model: nn.Module, shape, generator: Optional[torch.Generator],
                lead: tuple = (), block=None):
    """A generator application's dropout masks (``dropout_masks``), None
    without a generator or without dropout. With ``block``, ((data ranks,
    data index), (strips, strip index)), they are drawn for the global
    batch of whole images and this rank's block of each is kept."""
    draw = getattr(model, "dropout_masks", None)
    if generator is None or draw is None:
        return None
    if block is None:
        return draw(tuple(shape), generator, lead)
    (n_data, i_data), (n_sp, i_sp) = block
    h_axis = layout.spatial_axes()[0]
    whole = list(shape)
    whole[0] *= n_data
    whole[h_axis] *= n_sp
    masks = draw(tuple(whole), generator, lead)
    if masks is None:
        return None
    b_axis, h_axis = len(lead), len(lead) + h_axis
    return [m.narrow(b_axis, i_data * (m.shape[b_axis] // n_data),
                     m.shape[b_axis] // n_data)
            .narrow(h_axis, i_sp * (m.shape[h_axis] // n_sp),
                    m.shape[h_axis] // n_sp) for m in masks]


def _rematerialized(fn: Callable, *args):
    """``fn(*args)`` under a non-reentrant checkpoint whose recompute, run
    by autograd after the step's scopes have closed, re-enters the layout,
    ``pallas_norm`` setting and batch-norm mode of the first run; only
    the first run reports to the batch-norm sink, the recompute keeps no
    statistics."""
    name, norm = layout.current(), cuda_norm.is_enabled()
    train, sink = norm_ops.batch_mode()
    strips, batch = spatialctx.current(), norm_ops.current_batch_group()
    sinks = [sink]

    def run(*inputs):
        with layout.scope(name), cuda_norm.scope(norm), \
                spatialctx.scope(strips), norm_ops.batch_group(*batch), \
                norm_ops.batch_stats(train, sinks.pop() if sinks else None):
            return fn(*inputs)

    return checkpoint(run, *args, use_reentrant=False,
                      preserve_rng_state=False)


def _forward_losses(models: Mapping[str, nn.Module], losses: Callable,
                    weights: Mapping[str, float], real_a: torch.Tensor,
                    real_b: torch.Tensor, compute_dtype: torch.dtype,
                    stop_grads: bool, tpu_layout: bool = True,
                    pallas_norm: bool = False, *, fuse_apps: bool = False,
                    remat: bool = False, paired: bool = False,
                    dropout: Optional[torch.Generator] = None,
                    dropout_block=None, train: bool = True,
                    stats: Optional[dict] = None
                    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The shared forward set and the losses (cyclegan_tpu/steps.py
    ``_forward_losses``, or ``_forward_losses_paired`` with ``paired``), in
    the NHCW layout with ``tpu_layout`` and in NHWC (K13 for the norms with
    ``pallas_norm``) without. ``losses``: the family's losses over the
    forward set (``losses.get_losses``). ``real_a``, ``real_b``: NHWC f32
    in [-1, 1];
    ``dropout``: the generator of the generators' dropout masks (None: no
    dropout), ``dropout_block`` this rank's block of them on a mesh
    (``_draw_masks``). Returns (surrogate, metrics); with ``stop_grads`` the
    surrogate's gradient per network equals the reference's per-network
    gradient. Without, the two views of each fake batch are one
    application (validation and the reference gradients).

    Batch norms normalize with each batch's statistics with ``train``,
    else with the moving statistics. ``stats``, a dict, receives each
    network's kept application's new moving statistics ({network: {norm
    block: (mean, var)}}, the module docstring), for
    ``ops/norm.commit_batch_stats``; the paired step keeps none."""
    if paired:
        with layout.nhwc(), cuda_norm.scope(pallas_norm), \
                norm_ops.batch_stats(train):
            return _forward_losses_paired(models, losses, weights, real_a,
                                          real_b, compute_dtype, stop_grads,
                                          remat, dropout, dropout_block)
    scope = layout.nhcw() if tpu_layout else layout.nhwc()
    with scope, cuda_norm.scope(pallas_norm), norm_ops.batch_stats(train):
        if tpu_layout:
            real_a = layout.to_nhcw(real_a)
            real_b = layout.to_nhcw(real_b)
        return _forward_losses_scoped(models, losses, weights, real_a,
                                      real_b, compute_dtype, stop_grads,
                                      fuse_apps, remat, dropout,
                                      dropout_block, stats)


def _cast_params(models, compute_dtype):
    """Each network's parameters cast to the compute dtype: the cast's
    backward lands the gradients on the f32 masters. Buffers (a batch
    norm's moving statistics) stay f32, as JAX's ``model_state``."""
    return {name: {k: p.to(compute_dtype)
                   for k, p in models[name].named_parameters()}
            for name in NETWORKS}


def _forward_losses_scoped(models, losses, weights, real_a, real_b,
                           compute_dtype, stop_grads, fuse_apps=False,
                           remat=False, dropout=None, dropout_block=None,
                           stats=None):
    a_net = real_a.to(compute_dtype)
    b_net = real_b.to(compute_dtype)
    params = _cast_params(models, compute_dtype)

    def sink(name):
        """Network ``name``'s kept statistics' sink, where kept."""
        if stats is None:
            return None
        return stats.setdefault(name, {})

    def run(name, x):
        return functional_call(models[name], params[name], (x,))

    def gen(name, x, keep=False):
        model = models[name]
        masks = _draw_masks(model, x.shape, dropout, block=dropout_block)

        def apply(x, *masks):
            return functional_call(model, params[name], (x,),
                                   _dropout_kw(list(masks) or None))

        with _keeping(sink(name) if keep else None):
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
    else:  # batch norm keeps g_BA's translation and g_AB's cycle pass
        fake_b = gen("g_AB", a_net)
        cycled_a = gen("g_BA", generated_image(fake_b))
        fake_a = gen("g_BA", b_net, keep=True)
        cycled_b = gen("g_AB", generated_image(fake_a), keep=True)
        same_a = gen("g_BA", a_net)
        same_b = gen("g_AB", b_net)

    disc_real_a = run("d_A", a_net)
    disc_real_b = run("d_B", b_net)
    image_a, image_b = generated_image(fake_a), generated_image(fake_b)
    if stop_grads:
        disc_fake_a_gen, disc_fake_a_d = disc_views(
            models["d_A"], params["d_A"], image_a, sink("d_A"))
        disc_fake_b_gen, disc_fake_b_d = disc_views(
            models["d_B"], params["d_B"], image_b, sink("d_B"))
    else:
        disc_fake_a_gen = disc_fake_a_d = run("d_A", image_a)
        disc_fake_b_gen = disc_fake_b_d = run("d_B", image_b)
    return losses(weights, real_a, real_b, fake_a, fake_b, cycled_a,
                  cycled_b, same_a, same_b, disc_real_a, disc_real_b,
                  disc_fake_a_gen, disc_fake_b_gen, disc_fake_a_d,
                  disc_fake_b_d)


def _forward_losses_paired(models, losses, weights, real_a, real_b,
                           compute_dtype, stop_grads, remat=False,
                           dropout=None, dropout_block=None):
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
        masks = _draw_masks(g_model, first.shape, dropout, (2,),
                            dropout_block)
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
    return losses(weights, real_a, real_b, fake_a, fake_b, cycled_a,
                  cycled_b, same_a, same_b, disc_real_a, disc_real_b,
                  disc_fake_a_gen, disc_fake_b_gen, disc_fake_a_d,
                  disc_fake_b_d)


def _weights(loss_weights: Mapping[str, float]) -> Dict[str, float]:
    return {k: float(v) for k, v in dict(loss_weights).items()}


def _check_spatial_kernel_exclusion(spatial_axis: Optional[str],
                                    tpu_layout: bool) -> None:
    """The JAX package's one structural constraint of its step builders:
    its partitioner cannot split the kernels, so spatial sharding with
    ``tpu_layout`` needs the explicit path, ``shard_map_dp``."""
    if spatial_axis is not None and tpu_layout:
        raise ValueError(
            "spatial_axis and tpu_layout are mutually exclusive without "
            "shard_map_dp, as in the JAX package (Pallas custom calls are "
            "opaque to the SPMD partitioner); pass shard_map_dp=True to "
            "run the kernels on H-sharded strips")


_SEED_MIX = 0x9E3779B97F4A7C15  # odd 64-bit constant (golden ratio)


def _derived_seed(seed: int, index: int, stream: int) -> int:
    return (seed + _SEED_MIX * (2 * index + stream + 1)) % (1 << 63)


class _Parallel:
    """A step's mesh: its data axis (or axes, the first outermost), its
    spatial axis where that has more than one rank, and ``shard_map_dp``.
    Averages go over the data and spatial axes (``group``, ``size``)."""

    def __init__(self, mesh, mesh_axis, spatial_axis, shard_map_dp):
        self.mesh = mesh
        data_axes = ((mesh_axis,) if isinstance(mesh_axis, str)
                     else tuple(mesh_axis))
        self.spatial_axis = (spatial_axis if mesh.axis_size(spatial_axis)
                             > 1 else None)
        self.shard_map_dp = bool(shard_map_dp)
        self.data_size = math.prod(mesh.axis_size(a) for a in data_axes)
        self.data_index = 0
        for a in data_axes:
            self.data_index = self.data_index * mesh.axis_size(a) \
                + mesh.index(a)
        self.n_sp = mesh.axis_size(self.spatial_axis)
        self.sp_index = mesh.index(self.spatial_axis)
        axes = data_axes + ((self.spatial_axis,) if self.spatial_axis
                            else ())
        self.group = mesh.group(axes)
        self.size = self.data_size * self.n_sp

    @contextlib.contextmanager
    def scope(self):
        """The strip's spatial scope, and the batch norms' group: the
        spatial ranks of this data shard with ``shard_map_dp``, the whole
        mesh without."""
        if self.shard_map_dp:
            bn = (self.mesh.group(self.spatial_axis), self.n_sp)
        else:
            bn = (self.group, self.size)
        with spatial_mesh.scope(self.mesh, self.spatial_axis), \
                norm_ops.batch_group(*bn):
            yield

    def mean(self, tensors: Sequence[torch.Tensor]) -> list:
        """Each tensor's mean over the mesh: one all-reduce of them all,
        flattened into one f32 buffer."""
        flat = torch.cat([t.reshape(-1).float() for t in tensors])
        dist.all_reduce(flat, group=self.group)
        flat /= self.size
        return [v.view(t.shape).to(t.dtype) for v, t in
                zip(flat.split([t.numel() for t in tensors]), tensors)]

    def average_grads(self, models: Mapping[str, nn.Module]) -> None:
        grads = [p.grad for name in NETWORKS
                 for p in models[name].parameters() if p.grad is not None]
        for g, mean in zip(grads, self.mean(grads)):
            g.copy_(mean)

    def broadcast_stats(self, stats: Mapping[str, dict]) -> None:
        """Rank 0's committed moving statistics to every rank."""
        owners = [o for kept in stats.values() for o in kept]
        if not owners:
            return
        flat = torch.cat([torch.cat([o.moving_mean, o.moving_var])
                          for o in owners])
        dist.broadcast(flat, src=0, group=self.group)
        for o, part in zip(owners, flat.split([2 * o.moving_mean.numel()
                                               for o in owners])):
            mean, var = part.chunk(2)
            o.moving_mean.copy_(mean)
            o.moving_var.copy_(var)

    def draws(self, state, batch: int):
        """One step's random draws for a local batch of ``batch``: (jitter
        generator, jitter rows, dropout generator, dropout block), the rows
        for ``preprocess`` (``augment.draw_jitter``'s) and the block for
        ``_draw_masks``. Without ``shard_map_dp`` the state's generators,
        drawing for the global batch, of which this rank keeps its block;
        with it, generators derived from one draw of the state's and this
        rank's index, drawing its own."""
        if self.shard_map_dp:
            seed = int(torch.randint(0, 1 << 62, (), generator=state.generator))
            jitter = torch.Generator().manual_seed(
                _derived_seed(seed, self.data_index, 0))
            dropout = torch.Generator(
                device=state.dropout_generator.device).manual_seed(
                _derived_seed(seed, self.data_index * self.n_sp
                              + self.sp_index, 1))
            return jitter, None, dropout, None
        return (state.generator,
                (batch * self.data_size, batch * self.data_index),
                state.dropout_generator,
                ((self.data_size, self.data_index),
                 (self.n_sp, self.sp_index)))


def _parallel(mesh, mesh_axis, spatial_axis, shard_map_dp, tpu_layout
              ) -> Optional[_Parallel]:
    """The step builders' checks, as JAX's, and the mesh of the step."""
    if shard_map_dp and mesh is None:
        raise ValueError("shard_map_dp requires a mesh")
    if not shard_map_dp:
        _check_spatial_kernel_exclusion(spatial_axis, tpu_layout)
    if mesh is None:
        return None
    return _Parallel(mesh, mesh_axis, spatial_axis, shard_map_dp)


def _preprocessed(preprocess, par, generator, rows, real_a, real_b):
    """The preprocess of a step on a mesh, its draws for ``rows``: under a
    spatial axis on the whole images (gathered, then each strip kept)."""
    if par.spatial_axis is None:
        return preprocess(generator, real_a, real_b, rows=rows)
    a, b = preprocess(generator, spatialctx.gather_h(real_a),
                      spatialctx.gather_h(real_b), rows=rows)
    return spatialctx.slice_local_h(a), spatialctx.slice_local_h(b)


class CudaGraph:
    """The seam between the train step and CUDA graphs, which a test can
    stand a class of the same three members in for. ``usable(device)``:
    whether a step on ``device`` can be captured (on a card).
    ``capture(fn)`` calls ``fn`` with the work it issues to the card
    recorded into one graph and not run, on a side stream that waits for
    the current one (torch's default stream cannot be captured), and
    returns what ``fn`` returned: tensors in the graph's private memory,
    which each ``replay()`` rewrites. A capture can take memory from the
    card but not give the caching allocator's back, so first, as
    ``torch.cuda.graph`` does, it waits for the stream (counted as a
    ``sync``), collects garbage and empties the cache: the memory of
    graphs whose steps are gone returns to the card there.
    ``replay()`` runs the graph on the current stream, without a sync."""

    @staticmethod
    def usable(device: torch.device) -> bool:
        return device.type == "cuda"

    def __init__(self):
        self.graph = torch.cuda.CUDAGraph()

    def capture(self, fn: Callable):
        torch.cuda.current_stream().synchronize()
        tracing.count("sync")
        gc.collect()
        torch.cuda.empty_cache()
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            self.graph.capture_begin()
            try:
                out = fn()
            finally:
                self.graph.capture_end()
        torch.cuda.current_stream().wait_stream(side)
        return out

    def replay(self) -> None:
        self.graph.replay()


def _held(models: Mapping[str, nn.Module]) -> Tuple[list, list]:
    """(the parameters, the parameters and buffers) of the four networks,
    in one walk of their modules (``parameters()`` and ``buffers()`` walk
    them twice, a millisecond of host time a step): what a graph of the
    step reads and writes."""
    params, held = [], []
    for name in NETWORKS:
        for module in models[name].modules():
            params += [p for p in module._parameters.values()
                       if p is not None]
            held += [b for b in module._buffers.values() if b is not None]
    return params, params + held


class _Captured:
    """One input shape's graph of a step's ``grads(state, a, b)`` (zero_grad,
    forward set, losses, backward): the two static inputs it reads, what it
    writes (the metrics, the kept batch statistics and each parameter's
    gradient), the addresses of the parameters and buffers it was
    captured on, and the kernel launches and paths of one step, which the
    wrappers counted while it was captured and nothing counts on a
    replay."""

    def __init__(self, state: TrainState, grads: Callable,
                 real_a: torch.Tensor, real_b: torch.Tensor):
        params, held = _held(state.models)
        self.addresses = [t.data_ptr() for t in held]
        self.inputs = tuple(torch.empty(x.shape, dtype=x.dtype,
                                        device=x.device).copy_(x)
                            for x in (real_a, real_b))
        launches, paths = dict(kernels.launches), kernels.paths.copy()
        self.graph = CudaGraph()
        self.out = self.graph.capture(lambda: (
            *grads(state, *self.inputs), [p.grad for p in params]))
        self.launches = {k: kernels.launches[k] - n
                         for k, n in launches.items()}
        self.paths = kernels.paths - paths

    def parameters(self, state: TrainState) -> Optional[list]:
        """``state``'s parameters, where its parameters and buffers are
        where the graph reads and writes them; else None."""
        params, held = _held(state.models)
        if [t.data_ptr() for t in held] != self.addresses:
            return None
        return params

    def count(self) -> None:
        """One step's kernel launches and paths."""
        for name, n in self.launches.items():
            kernels.launches[name] += n
        kernels.paths.update(self.paths)

    def run(self, params: list, real_a: torch.Tensor, real_b: torch.Tensor):
        """(metrics, kept batch statistics) of one step on the batch pair:
        the pair copied in, the graph replayed, the metrics copied out,
        and each parameter's ``.grad`` the gradient the graph writes."""
        for static, x in zip(self.inputs, (real_a, real_b)):
            static.copy_(x)
        self.graph.replay()
        metrics, stats, grads = self.out
        for p, g in zip(params, grads):
            if p.grad is not g:
                p.grad = g
        return {k: v.clone() for k, v in metrics.items()}, stats


def _ugatit_options(loss_name: str, mesh, **options) -> None:
    """A ValueError where the step is U-GAT-IT's and a mesh or one of
    ``options`` is set, which its step does not take."""
    if loss_name != UGATIT:
        return
    refused = [k for k, v in options.items() if v]
    if mesh is not None:
        refused.insert(0, "mesh")
    if refused:
        raise ValueError(f"loss {UGATIT!r}: the U-GAT-IT step takes no "
                         f"{', '.join(refused)} (a mesh, an H-sharded "
                         f"spatial axis, paired, fuse_apps and remat are "
                         f"out of its scope)")


def _clip_rhos(models: Mapping[str, nn.Module]) -> None:
    """Clip every ``rho`` of the networks that have them (``rhos()``: the
    U-GAT-IT generator's AdaLIN and ILN) into [0, 1], in place."""
    rhos = [p for m in models.values() for p in getattr(m, "rhos", list)()]
    if rhos:
        with torch.no_grad():
            torch._foreach_clamp_min_(rhos, 0.0)
            torch._foreach_clamp_max_(rhos, 1.0)


def make_train_step(loss_name: str, loss_weights: Mapping[str, float],
                    compute_dtype: str = "float32",
                    preprocess: Optional[Callable] = None,
                    tpu_layout: bool = True,
                    pallas_norm: bool = False, remat: bool = False,
                    paired: bool = False,
                    fuse_apps: bool = False, mesh=None,
                    mesh_axis="data", spatial_axis: Optional[str] = None,
                    shard_map_dp: bool = False) -> Callable:
    """The train step ``(state, real_a, real_b) -> metrics``: preprocess
    (``preprocess(generator, a, b) -> (a, b)``, e.g. the jitter), one
    forward set in the layout ``tpu_layout`` picks (with the options of
    the module docstring) and the losses of ``loss_name``'s family
    (``losses.get_losses``), ONE backward, four optimizer updates, in
    place on ``state``. After it each parameter's ``.grad`` holds the step's
    gradient, and each batch norm's kept moving statistics are committed
    after the updates (the module docstring). Metrics are detached f32
    scalars on the batch's device, each step's its own; the step never
    waits for the card. Each call is a ``tracing`` root ``train_step``
    with the spans ``jitter`` and ``optimizer`` (the updates and
    batch-stat commit; on an eager step zero_grad too), and ``forward``
    and ``backward`` on an eager step.

    CUDA graph: per input shape and dtype (after the preprocess), the
    first call runs eager (it builds the kernels, picks the library's
    plans and sets autograd up), the second captures ``_grads`` in one
    graph (``CudaGraph``) and replays it, every later call replays it.
    The jitter's output is copied into the graph's two static inputs;
    the metrics are copied out of it after each replay. A replayed step
    has span ``replay`` (input copy, replay, metric copy) and counter
    ``graph_replay``; the capturing one span ``capture`` (its zero_grad,
    forward and backward spans under it), counter ``graph_capture`` and
    one ``sync`` (``CudaGraph.capture`` waits for the stream).
    The wrappers count a step's kernel launches and paths while it is
    captured, and each replay adds them again. The graph holds the
    addresses of the parameters and buffers: the optimizers update them
    in place, and ``utils/checkpoint.load_train_state`` copies into them
    (``load_state_dict``), so they stay where they were; where they move
    (new tensors put into the models) the step captures again. After a
    replay each parameter's ``.grad`` is the gradient the graph writes,
    in the graph's memory, whatever was assigned to it in between. The
    graph's memory lives as long as the step function. The eager step
    stays, for the whole call, on:

    - a device other than a card (``CudaGraph.usable``);
    - a mesh: its data and spatial collectives run inside the forward
      and backward, and the gradient all-reduce after them;
    - generators that draw dropout masks: they draw from the state's
      generator on the card inside the forward, and a replay would
      repeat one step's masks;
    - ``remat`` and ``paired``: the checkpoint's recompute inside the
      backward and the ``vmap``ped applications are not tried under
      capture.

    With ``mesh`` (``parallel.Mesh``), the batch is this rank's block
    (batch over ``mesh_axis``, H over ``spatial_axis``) and the gradients
    and metrics are averaged over the mesh (the module docstring). There
    the preprocess is called as ``preprocess(generator, a, b, rows=rows)``
    and draws for ``rows`` (``augment.random_jitter_batch``'s: the global
    batch's draw and this rank's rows of it, or None)."""
    _ugatit_options(loss_name, mesh, paired=paired, fuse_apps=fuse_apps,
                    remat=remat)
    losses = get_losses(loss_name)
    weights = _weights(loss_weights)
    cdtype = DTYPES[compute_dtype]
    par = _parallel(mesh, mesh_axis, spatial_axis, shard_map_dp, tpu_layout)
    graphs: Dict[tuple, Optional[_Captured]] = {}

    def train_step(state: TrainState, real_a: torch.Tensor,
                   real_b: torch.Tensor) -> Dict[str, torch.Tensor]:
        with tracing.span("train_step"):
            return _step(state, real_a, real_b)

    def _grads(state, real_a, real_b, dropout=None, block=None):
        """zero_grad, the forward set with its f32 losses and ONE backward:
        what a graph of the step holds. (metrics, kept batch stats)."""
        with tracing.span("optimizer"):
            for opt in state.optimizers.values():
                opt.zero_grad(set_to_none=True)
        stats = {}
        with tracing.span("forward"):
            surrogate, metrics = _forward_losses(
                state.models, losses, weights, real_a, real_b, cdtype,
                stop_grads=True, tpu_layout=tpu_layout,
                pallas_norm=pallas_norm, fuse_apps=fuse_apps, remat=remat,
                paired=paired, dropout=dropout, dropout_block=block,
                stats=stats)
        with tracing.span("backward"):
            surrogate.backward()
        return {k: v.detach() for k, v in metrics.items()}, stats

    def _graphed(state, real_a, real_b):
        """(metrics, stats) through the shape's graph, captured on its
        second call; None where the step runs eager."""
        if remat or paired or not CudaGraph.usable(real_a.device) or any(
                getattr(state.models[n], "use_dropout", False)
                for n in ("g_AB", "g_BA")):
            return None
        key = (real_a.device, real_a.shape, real_a.dtype, real_b.shape,
               real_b.dtype)
        if key not in graphs:
            graphs[key] = None
            return None
        captured = graphs[key]
        params = None if captured is None else captured.parameters(state)
        if params is not None:
            with tracing.span("replay"):
                tracing.count("graph_replay")
                captured.count()
                return captured.run(params, real_a, real_b)
        graphs[key] = captured = None  # the old graph's memory goes first
        with tracing.span("capture"):
            tracing.count("graph_capture")
            graphs[key] = captured = _Captured(state, _grads, real_a,
                                               real_b)
            return captured.run(captured.parameters(state), real_a, real_b)

    def _step(state, real_a, real_b):
        if par is not None:
            with par.scope():
                generator, rows, dropout, block = par.draws(
                    state, real_a.shape[0])
                if preprocess is not None:
                    with tracing.span("jitter"):
                        real_a, real_b = _preprocessed(
                            preprocess, par, generator, rows, real_a, real_b)
                metrics, stats = _grads(state, real_a, real_b, dropout,
                                        block)
            par.average_grads(state.models)
            metrics = dict(zip(metrics, par.mean(list(metrics.values()))))
        else:
            if preprocess is not None:
                with tracing.span("jitter"):
                    real_a, real_b = preprocess(state.generator, real_a,
                                                real_b)
            out = _graphed(state, real_a, real_b)
            metrics, stats = (out if out is not None else _grads(
                state, real_a, real_b, state.dropout_generator))
        with tracing.span("optimizer"):
            for name in NETWORKS:
                state.optimizers[name].step()
            _clip_rhos(state.models)
            for kept in stats.values():
                norm_ops.commit_batch_stats(kept)
        if par is not None and par.shard_map_dp and par.data_size > 1:
            par.broadcast_stats(stats)
        state.step += 1
        return metrics

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
    draws included, is that of K single steps (on a mesh too: the options
    include ``mesh``, ``mesh_axis``, ``spatial_axis`` and
    ``shard_map_dp``, and the batches are this rank's blocks)."""
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
                       fuse_apps: bool = False, mesh=None,
                       mesh_axis="data", spatial_axis: Optional[str] = None,
                       shard_map_dp: bool = False) -> Callable:
    """The eval step ``(state, real_a, real_b) -> metrics``: the forward
    set without stop-gradients, dropout or a backward (4 discriminator
    applications), batch norms on their moving statistics, the networks
    in eval mode (a spectral norm's ``u`` stays), in the layout
    ``tpu_layout`` picks, ``fuse_apps`` as the train step's;
    ``preprocess(images)`` (e.g. ``prepare_eval_batch``, elementwise, so
    right on a strip) runs first on each batch. With ``mesh`` the batches
    are this rank's blocks and the metrics are averaged over the mesh."""
    _ugatit_options(loss_name, mesh, fuse_apps=fuse_apps)
    losses = get_losses(loss_name)
    weights = _weights(loss_weights)
    cdtype = DTYPES[compute_dtype]
    par = _parallel(mesh, mesh_axis, spatial_axis, shard_map_dp, tpu_layout)

    @torch.no_grad()
    def validate_step(state: TrainState, real_a: torch.Tensor,
                      real_b: torch.Tensor) -> Dict[str, torch.Tensor]:
        if preprocess is not None:
            real_a, real_b = preprocess(real_a), preprocess(real_b)
        modes = [(m, m.training) for m in state.models.values()]
        try:
            for m, _ in modes:
                m.eval()
            with contextlib.nullcontext() if par is None else par.scope():
                _, metrics = _forward_losses(
                    state.models, losses, weights, real_a, real_b, cdtype,
                    stop_grads=False, tpu_layout=tpu_layout,
                    pallas_norm=pallas_norm, fuse_apps=fuse_apps,
                    train=False)
        finally:
            for m, mode in modes:
                m.train(mode)
        if par is not None:
            metrics = dict(zip(metrics, par.mean(list(metrics.values()))))
        return metrics

    return validate_step


def reference_gradients(models: Mapping[str, nn.Module], loss_name: str,
                        loss_weights: Mapping[str, float],
                        real_a: torch.Tensor, real_b: torch.Tensor
                        ) -> Dict[str, Dict[str, torch.Tensor]]:
    """The naive four-backward gradients, as the reference's four
    ``tape.gradient`` calls compute them (cyclegan_tpu/steps.py
    ``reference_gradients``): one f32 forward in train mode without
    stop-gradients, then
    each network's own total loss differentiated with respect to that
    network alone. For the tests."""
    _, metrics = _forward_losses(models, get_losses(loss_name),
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
