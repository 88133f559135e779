"""Instance norm and batch norm (cyclegan_tpu/ops/norm.py ``instance_norm``,
``batch_norm_stats``), with the activation that follows them. Epsilon 1e-3
as tensorflow_addons' InstanceNormalization and Keras' BatchNormalization.

- NHCW: norm and activation fused, K2 forward and K6 backward on the card
  (``ops/cuda_norm_act.py``), their plain versions on the CPU.
- NHWC with ``cuda_norm.scope(True)`` (``pallas_norm``): K13 or its plain
  version (``ops/cuda_norm.py``), then the activation.
- NHWC otherwise: torch ops, the counterpart of the JAX package's XLA path:
  f32 takes the two-pass variance, bf16 the single sweep E[x^2] - mean^2,
  both with f32 statistics; then the activation. Autograd differentiates
  them.

Under an H-sharded scope (``ops/spatialctx.py``; JAX ``norm.py:32-60``)
an instance norm is the torch-op norm in either layout, its local sums
summed over the spatial group with count = local x strips
(``spatialctx.all_reduce_sum``, differentiable), and never K2 or K13,
whose statistics are one strip's. A train-mode batch norm sums its
statistics, in the forward and in its closed-form backward, over the group
that ``batch_group`` scopes: the train step gives it the whole mesh where
the JAX package computes global batch statistics (data parallelism
without ``dp_shard_map``), the spatial group where it computes them per
data shard (``dp_shard_map``, JAX ``norm.py:108-130``).
"""

from __future__ import annotations

import contextlib
import math
import threading
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from cyclegan_tpu_torch.ops import cuda_norm, layout, spatialctx
from cyclegan_tpu_torch.ops.cuda_norm_act import (
    TFA_EPSILON,
    instance_norm_act,
)


def _xla_instance_norm(x, gamma, beta, eps):
    """The torch-op instance norm. Under an H-sharded scope its local sums
    are summed over the spatial group (one all-reduce of both sums in bf16,
    one a pass in f32) with count = local x strips; outside one
    ``all_reduce_sum`` returns its input and the count is the image's."""
    axes = layout.spatial_axes()
    group = spatialctx.group()
    count = x.shape[axes[0]] * x.shape[axes[1]] * spatialctx.n_shards()
    xf = x.float()
    if x.dtype == torch.bfloat16:
        sums = spatialctx.all_reduce_sum(torch.stack([
            xf.sum(dim=axes, keepdim=True),
            (xf * xf).sum(dim=axes, keepdim=True)]), group) / count
        mean = sums[0]
        var = torch.clamp(sums[1] - mean * mean, min=0.0)
    else:
        mean = spatialctx.all_reduce_sum(
            xf.sum(dim=axes, keepdim=True), group) / count
        var = spatialctx.all_reduce_sum(
            ((xf - mean) ** 2).sum(dim=axes, keepdim=True), group) / count
    y = (xf - mean) * torch.rsqrt(var + eps)
    if gamma is not None:
        y = y * layout.channel_param(gamma)
    if beta is not None:
        y = y + layout.channel_param(beta)
    return y.to(x.dtype)


def activation(y: torch.Tensor, act: str, alpha: float) -> torch.Tensor:
    """The activation after an NHWC norm: relu, leaky_relu or none."""
    if act == "relu":
        return torch.relu(y)
    if act == "leaky_relu":
        return F.leaky_relu(y, negative_slope=alpha)
    if act == "none":
        return y
    raise ValueError(f"activation {act!r} not in ['leaky_relu', 'none', "
                     f"'relu']")


def instance_norm(x: torch.Tensor, gamma: Optional[torch.Tensor] = None,
                  beta: Optional[torch.Tensor] = None,
                  eps: float = TFA_EPSILON, act: str = "none",
                  alpha: float = 0.2) -> torch.Tensor:
    sharded = spatialctx.is_active()  # K2 and K13 see one strip's statistics
    if layout.is_nhcw() and not sharded:
        return instance_norm_act(x, gamma, beta, eps, act, alpha)
    if cuda_norm.is_enabled() and not sharded:
        y = cuda_norm.instance_norm_nhwc(x, gamma, beta, eps)
    else:
        y = _xla_instance_norm(x, gamma, beta, eps)
    return activation(y, act, alpha)


BN_EPSILON = 1e-3
BN_MOMENTUM = 0.99  # Keras: new = old * momentum + batch * (1 - momentum)


class _BatchStats(threading.local):
    train = False
    sink: Optional[Dict[Any, Tuple[torch.Tensor, torch.Tensor]]] = None
    group = None  # the ranks whose batches the statistics span
    ranks = 1


_BN = _BatchStats()


@contextlib.contextmanager
def batch_stats(train: bool = True, sink: Optional[dict] = None):
    """Scope the batch norms' mode on this thread: ``train`` normalizes
    with the batch's statistics, else with the moving ones; ``sink`` (a
    dict, or None to discard) receives each norm's new moving statistics,
    ``{owner: (mean, var)}``."""
    prev = _BN.train, _BN.sink
    _BN.train, _BN.sink = train, sink
    try:
        yield sink
    finally:
        _BN.train, _BN.sink = prev


def batch_mode() -> Tuple[bool, Optional[dict]]:
    """The scope's (train, sink)."""
    return _BN.train, _BN.sink


@contextlib.contextmanager
def batch_group(group, ranks: int):
    """Scope the process group over whose ``ranks`` equal batches a
    train-mode batch norm computes its statistics (None: this rank's
    batch alone)."""
    prev = _BN.group, _BN.ranks
    _BN.group, _BN.ranks = (group, int(ranks)) if ranks > 1 else (None, 1)
    try:
        yield
    finally:
        _BN.group, _BN.ranks = prev


def current_batch_group() -> Tuple[Any, int]:
    return _BN.group, _BN.ranks


def _summed(t: torch.Tensor, group) -> torch.Tensor:
    """t summed over ``group`` in place (not differentiated: inside a
    Function)."""
    if group is not None:
        torch.distributed.all_reduce(t, group=group)
    return t


def commit_batch_stats(sink: dict) -> None:
    """Write the statistics a ``batch_stats`` sink received into their
    owners' ``moving_mean`` and ``moving_var``."""
    with torch.no_grad():
        for owner, (mean, var) in sink.items():
            owner.moving_mean.copy_(mean)
            owner.moving_var.copy_(var)


def batch_norm_stats(x: torch.Tensor, gamma: Optional[torch.Tensor],
                     beta: Optional[torch.Tensor], moving_mean: torch.Tensor,
                     moving_var: torch.Tensor, train: bool,
                     eps: float = BN_EPSILON, momentum: float = BN_MOMENTUM
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Keras BatchNormalization per channel over the batch and spatial
    axes, in f32: ``(y in x.dtype, new_moving_mean, new_moving_var)``. In
    train mode the batch statistics normalize and the moving ones take
    Keras' momentum step (the new statistics are detached: state, not
    differentiated); else the moving statistics normalize and pass through
    unchanged."""
    axes = (0,) + layout.spatial_axes()
    xf = x.float()
    if train:
        mean = xf.mean(dim=axes)
        var = ((xf - layout.channel_param(mean)) ** 2).mean(dim=axes)
        new_mean = moving_mean * momentum + mean.detach() * (1.0 - momentum)
        new_var = moving_var * momentum + var.detach() * (1.0 - momentum)
    else:
        mean, var = moving_mean, moving_var
        new_mean, new_var = moving_mean, moving_var
    y = (xf - layout.channel_param(mean)) * torch.rsqrt(
        layout.channel_param(var) + eps)
    if gamma is not None:
        y = y * layout.channel_param(gamma)
    if beta is not None:
        y = y + layout.channel_param(beta)
    return y.to(x.dtype), new_mean, new_var


class BatchNormAct(torch.autograd.Function):
    """Train-mode batch norm and its activation, ``batch_norm_stats``'
    math with the backward in closed form: ``apply(x, gamma, beta, axes,
    act, alpha, eps) -> (y in x.dtype, batch mean, batch variance)``, the
    statistics f32 with the reduced ``axes`` kept as size 1 (not
    differentiated). Autograd through the forward's ops keeps f32 copies
    of x for the backward and runs about 40 kernels a norm; this keeps x
    and y in their dtype, and with xc = x - mean, g the output's gradient
    through the activation and n the count reduced over:

        y     = act(xc * (rstd gamma) + beta)
        dbeta = sum(g),  dgamma = rstd sum(g xc)
        dx    = rstd gamma (g - dbeta / n - xc rstd dgamma / n)

    (x_hat never materialized), each line a few passes over x. The
    activation's gradient is read off y (relu: y > 0; leaky_relu: y >= 0,
    else alpha), so the pre-activation is not kept either.

    With a ``group`` of ``ranks`` (``batch_group``), the statistics span
    every rank's equal batch: the forward sums Σx and Σxc² over the group,
    the backward sums dbeta and dgamma over it for dx (n counts every
    rank's elements) and keeps this rank's own for the parameters' grads,
    which the train step then averages."""

    generate_vmap_rule = True

    @staticmethod
    def forward(x, gamma, beta, axes, act, alpha, eps, group=None, ranks=1):
        xf = x.float()
        n = math.prod(xf.shape[a] for a in axes) * ranks
        mean = _summed(xf.sum(dim=axes, keepdim=True), group) / n
        xc = xf - mean
        var = _summed((xc * xc).sum(dim=axes, keepdim=True), group) / n
        scale = torch.rsqrt(var + eps)
        if gamma is not None:
            scale = scale * gamma.reshape(mean.shape)
        z = (xc * scale if beta is None
             else torch.addcmul(beta.reshape(mean.shape).float(), xc, scale))
        return activation(z, act, alpha).to(x.dtype), mean, var

    @staticmethod
    def setup_context(ctx, inputs, output):
        x, gamma, beta, axes, act, alpha, eps, group, ranks = inputs
        y, mean, var = output
        ctx.mark_non_differentiable(mean, var)
        ctx.save_for_backward(x, gamma, y, mean, var)
        ctx.axes, ctx.act, ctx.alpha, ctx.eps = axes, act, alpha, eps
        ctx.group, ctx.ranks = group, ranks
        ctx.beta_dtype = None if beta is None else beta.dtype

    @staticmethod
    def backward(ctx, gy, _gmean, _gvar):
        x, gamma, y, mean, var = ctx.saved_tensors
        axes = ctx.axes
        g = gy.float()
        if ctx.act == "relu":
            g = torch.where(y > 0, g, 0.0)
        elif ctx.act == "leaky_relu":
            g = torch.where(y >= 0, g, g * ctx.alpha)
        xc = x.float() - mean
        n = xc.numel() // mean.numel() * ctx.ranks
        rstd = torch.rsqrt(var + ctx.eps)
        sum_g = g.sum(dim=axes, keepdim=True)
        dgamma_c = rstd * (g * xc).sum(dim=axes, keepdim=True)
        k1 = rstd if gamma is None else rstd * gamma.reshape(mean.shape)
        # dx reads the sums over every rank
        all_g, all_gamma = _summed(torch.stack([sum_g, dgamma_c]), ctx.group)
        dx = torch.addcmul(torch.addcmul(-k1 * all_g / n, g, k1), xc,
                           -k1 * rstd * all_gamma / n)
        dgamma = dbeta = None
        if gamma is not None and ctx.needs_input_grad[1]:
            dgamma = dgamma_c.reshape(gamma.shape).to(gamma.dtype)
        if ctx.beta_dtype is not None and ctx.needs_input_grad[2]:
            dbeta = sum_g.reshape(-1).to(ctx.beta_dtype)
        return (dx.to(x.dtype), dgamma, dbeta, None, None, None, None, None,
                None)


def batch_norm(x: torch.Tensor, gamma: Optional[torch.Tensor],
               beta: Optional[torch.Tensor], moving_mean: torch.Tensor,
               moving_var: torch.Tensor, owner: Any, act: str = "none",
               alpha: float = 0.2) -> torch.Tensor:
    """Batch norm then the activation, in the scope's mode
    (``batch_stats``): in train mode ``BatchNormAct``, and the new moving
    statistics (Keras' momentum step from the old ones) go to the scope's
    sink under ``owner``; else ``batch_norm_stats`` on the moving
    statistics."""
    if not _BN.train:
        y, _, _ = batch_norm_stats(x, gamma, beta, moving_mean, moving_var,
                                   False)
        return activation(y, act, alpha)
    y, mean, var = BatchNormAct.apply(x, gamma, beta,
                                      (0,) + layout.spatial_axes(), act,
                                      alpha, BN_EPSILON, _BN.group,
                                      _BN.ranks)
    if _BN.sink is not None:
        m = BN_MOMENTUM
        _BN.sink[owner] = (moving_mean * m + mean.reshape(-1) * (1.0 - m),
                           moving_var * m + var.reshape(-1) * (1.0 - m))
    return y
