"""Fused instance norm + activation on NHCW activations and its gradient:
kernels K2 (forward) and K6 (backward), their plain versions, and the
autograd Function that joins them.

Replaces cyclegan_tpu/ops/pallas_norm_act.py ``instance_norm_act``: its
forward kernels ``_fwd_call`` and ``_fwd_stream_call`` (K2,
``kernels/csrc/norm_act.cu``) and its backward kernels ``_bwd_call`` and
``_bwd_stream_call`` (K6, ``kernels/csrc/norm_act_bwd.cu``). The TPU split
into VMEM-resident and streamed kernels at 3 MB slabs was a VMEM artefact;
each CUDA kernel is one design for every slab size.

Bound on the H100: bytes (about 8 flops per element forward, 20 backward).
Each kernel reads its operands from device memory once (norm_act.cuh): a
thread keeps its 16-byte slots of a plane in registers for the sums and the
output pass; small planes share a CTA, large ones split their rows over a
thread-block cluster that exchanges f32 partial sums through distributed
shared memory, in a fixed order. ``norm_act_geometry`` is the kernels'
geometry rule; the C entry points refuse a launch whose geometry differs.

Statistics as in the JAX package: bf16 input takes one sweep,
var = max(E[x^2] - E[x]^2, 0); f32 input takes two passes. Then
out = act((x - mu) * gamma * rstd + beta). The forward can write mu and
rstd (f32 [B, C]) for the backward, as the Pallas forward writes its
residuals; the backward writes dx and t1 = sum dv, t2 = sum dv * xhat per
(sample, channel), and dgamma, dbeta are their sums over the batch (torch
sums, as JAX's are XLA sums).
"""

from __future__ import annotations

import functools
from typing import Optional

import torch

from cyclegan_tpu_torch import kernels
from cyclegan_tpu_torch.kernels import F as CF
from cyclegan_tpu_torch.kernels import I, P

TFA_EPSILON = 1e-3
_ACTS = {"none": 0, "relu": 1, "leaky_relu": 2}

# K2's and K6's CTA (norm_act.cuh): threads, the slots of each operand a
# thread keeps in registers, and the largest (portable) cluster
NA_THREADS, NA_SLOTS, NA_MAX_CLUSTER = 256, 4, 8


def norm_act_geometry(b: int, h: int, c: int, w: int, esize: int,
                      operands: int, aligned: bool = True) -> dict:
    """How K2 (``operands`` 1: x) and K6 (2: x and gz) cut a launch on x
    [b, h, c, w] of ``esize``-byte elements; norm_act.cuh ``na::geometry``
    is the same rule. A slot is ``vec`` elements: 16 bytes where W allows
    and the pointers are 16-byte ``aligned``, else one. A plane of h x q
    slots (q = w / vec) that fits one CTA's ``NA_THREADS`` x ``nv`` kept
    slots shares it with up to 8 ``channels`` (a power of two dividing c,
    at least a warp each); a larger plane splits its rows over a
    ``cluster`` of up to 8 CTAs (at most h / 2), ``rows`` each, doubled
    until a CTA's share fits. ``slots``: the most a thread walks;
    ``resident``: they fit its registers, 16 bytes each (else each pass
    reads them from device memory again). ``tiles``: plane groups, each a
    CTA's or a cluster's."""
    v16 = 16 // esize
    vec = v16 if aligned and w % v16 == 0 else 1
    q = w // vec
    nv = NA_SLOTS
    cap = NA_THREADS * nv
    plane = h * q
    channels = cluster = 1
    if plane <= cap:
        while (2 * channels <= NA_THREADS // 32 and c % (2 * channels) == 0
               and 2 * channels * plane <= cap):
            channels *= 2
    else:
        while (cluster < NA_MAX_CLUSTER and 2 * cluster <= h
               and -(-h // cluster) * q > cap):
            cluster *= 2
    rows = -(-h // cluster)
    tpc = NA_THREADS // channels
    slots = -(-rows * q // tpc)
    return {"vec": vec, "q": q, "nv": nv, "channels": channels,
            "cluster": cluster, "rows": rows, "tpc": tpc, "slots": slots,
            "resident": int(slots <= nv and vec == v16),
            "tiles": b * (c // channels)}


@functools.lru_cache(maxsize=None)
def _geometry_args(shape, esize, operands, aligned):
    """The geometry arguments a launch passes: vec, channels, cluster,
    rows, slots, resident."""
    geo = norm_act_geometry(*shape, esize, operands, aligned)
    return tuple(geo[k] for k in ("vec", "channels", "cluster", "rows",
                                  "slots", "resident"))


def _launch_geometry(tensors, operands):
    """``_geometry_args`` of a launch on ``tensors`` (x first)."""
    x = tensors[0]
    aligned = all(t.data_ptr() % 16 == 0 for t in tensors)
    return _geometry_args(tuple(x.shape), x.element_size(), operands,
                          aligned)


def _check(x, gamma, beta, act):
    if x.dim() != 4:
        raise ValueError(f"instance_norm_act takes x [B,H,C,W], got "
                         f"{tuple(x.shape)}")
    for p in (gamma, beta):
        if p is not None and tuple(p.shape) != (x.shape[2],):
            raise ValueError(f"per-channel parameter {tuple(p.shape)} for "
                             f"{x.shape[2]} channels")
    if act not in _ACTS:
        raise ValueError(f"activation {act!r} not in {sorted(_ACTS)}")


def _affine(gamma, beta):
    """gamma, beta as f32 [C, 1] (1 and 0 when absent)."""
    g = 1.0 if gamma is None else gamma.float()[:, None]
    b = 0.0 if beta is None else beta.float()[:, None]
    return g, b


def instance_norm_act_plain(x: torch.Tensor, gamma: Optional[torch.Tensor],
                            beta: Optional[torch.Tensor],
                            eps: float = TFA_EPSILON, act: str = "relu",
                            alpha: float = 0.2, with_stats: bool = False):
    """The kernel's function with explicit f32 sums over (H, W). With
    ``with_stats``, returns (out, mu, rstd), the statistics f32 [B, C]."""
    _check(x, gamma, beta, act)
    xf = x.float()
    n = x.shape[1] * x.shape[3]
    mu = xf.sum(dim=(1, 3), keepdim=True) / n                 # [B,1,C,1]
    if x.dtype == torch.float32:
        var = ((xf - mu) ** 2).sum(dim=(1, 3), keepdim=True) / n
    else:
        sq = (xf * xf).sum(dim=(1, 3), keepdim=True) / n
        var = torch.clamp(sq - mu * mu, min=0.0)
    rstd = torch.rsqrt(var + eps)
    g, b = _affine(gamma, beta)
    v = (xf - mu) * (g * rstd) + b
    if act == "relu":
        v = torch.clamp(v, min=0.0)
    elif act == "leaky_relu":
        v = torch.where(v >= 0.0, v, v * alpha)
    out = v.to(x.dtype)
    if with_stats:
        return out, mu[:, 0, :, 0], rstd[:, 0, :, 0]
    return out


def instance_norm_act_cuda(x: torch.Tensor, gamma: Optional[torch.Tensor],
                           beta: Optional[torch.Tensor],
                           eps: float = TFA_EPSILON, act: str = "relu",
                           alpha: float = 0.2, with_stats: bool = False):
    """Launch K2 on CUDA tensors (with ``with_stats``, it also writes mu and
    rstd and this returns (out, mu, rstd))."""
    _check(x, gamma, beta, act)
    kernels.check_cuda("instance_norm_act", x, gamma, beta)
    B, H, C, W = x.shape
    out = torch.empty_like(x)
    mu = rstd = None
    if with_stats:
        mu = torch.empty((B, C), dtype=torch.float32, device=x.device)
        rstd = torch.empty_like(mu)
    fn = kernels.function(
        "norm_act", f"instance_norm_act_{kernels.dtype_suffix(x)}",
        [P, P, P, P, P, P, I, I, I, I, CF, I, CF] + [I] * 6 + [P])
    err = fn(kernels.ptr(x), kernels.ptr(gamma), kernels.ptr(beta),
             kernels.ptr(out), kernels.ptr(mu), kernels.ptr(rstd), B, H, C, W,
             float(eps), _ACTS[act], float(alpha),
             *_launch_geometry((x, out), 1), kernels.stream())
    kernels.check("norm_act", err)
    kernels.launches["instance_norm_act"] += 1
    return (out, mu, rstd) if with_stats else out


def _instance_norm_act(x, gamma, beta, eps, act, alpha, with_stats):
    """K2 or its plain version, by the tensor's device."""
    if x.is_cuda:
        return instance_norm_act_cuda(x, gamma, beta, eps, act, alpha,
                                      with_stats=with_stats)
    if x.device.type == "cpu":
        return instance_norm_act_plain(x, gamma, beta, eps, act, alpha,
                                       with_stats=with_stats)
    raise ValueError(f"instance_norm_act: no kernel for device {x.device}")


def _check_bwd(x, gz, mu, rstd):
    if gz.shape != x.shape:
        raise ValueError(f"gradient {tuple(gz.shape)} for x {tuple(x.shape)}")
    stats = (x.shape[0], x.shape[2])
    for s in (mu, rstd):
        if tuple(s.shape) != stats or s.dtype != torch.float32:
            raise ValueError(f"statistics {tuple(s.shape)} {s.dtype}, "
                             f"expected f32 {stats}")


def instance_norm_act_bwd_plain(x, gz, gamma, beta, mu, rstd,
                                act: str = "relu", alpha: float = 0.2):
    """(dx, t1, t2) with explicit f32 sums: xhat = (x - mu) rstd,
    v = gamma xhat + beta, dv = gz act'(v) where act' is 1 only for v > 0
    under relu (pallas_norm_act.py ``_act_grad``), t1 = sum dv,
    t2 = sum dv xhat, dx = gamma rstd (dv - t1/n - xhat t2/n)."""
    _check(x, gamma, beta, act)
    _check_bwd(x, gz, mu, rstd)
    n = x.shape[1] * x.shape[3]
    m = mu[:, None, :, None]
    r = rstd[:, None, :, None]
    g, b = _affine(gamma, beta)
    xhat = (x.float() - m) * r
    v = xhat * g + b
    if act == "relu":
        slope = (v > 0.0).float()
    elif act == "leaky_relu":
        slope = torch.where(v >= 0.0, 1.0, alpha)
    else:
        slope = torch.ones_like(v)
    dv = gz.float() * slope
    t1 = dv.sum(dim=(1, 3))                                   # [B, C]
    t2 = (dv * xhat).sum(dim=(1, 3))
    dx = (g * r) * (dv - t1[:, None, :, None] / n
                    - xhat * (t2[:, None, :, None] / n))
    return dx.to(x.dtype), t1, t2


def instance_norm_act_bwd_cuda(x, gz, gamma, beta, mu, rstd,
                               act: str = "relu", alpha: float = 0.2):
    """Launch K6 on CUDA tensors; returns (dx, t1, t2)."""
    _check(x, gamma, beta, act)
    _check_bwd(x, gz, mu, rstd)
    kernels.check_cuda("instance_norm_act_bwd", x, gz, gamma, beta)
    kernels.check_cuda("instance_norm_act_bwd", mu, rstd)
    B, H, C, W = x.shape
    dx = torch.empty_like(x)
    t1 = torch.empty((B, C), dtype=torch.float32, device=x.device)
    t2 = torch.empty_like(t1)
    fn = kernels.function(
        "norm_act_bwd", f"norm_act_bwd_{kernels.dtype_suffix(x)}",
        [P, P, P, P, P, P, P, P, P, I, I, I, I, I, CF] + [I] * 6 + [P])
    err = fn(kernels.ptr(x), kernels.ptr(gz), kernels.ptr(gamma),
             kernels.ptr(beta), kernels.ptr(mu), kernels.ptr(rstd),
             kernels.ptr(dx), kernels.ptr(t1), kernels.ptr(t2), B, H, C, W,
             _ACTS[act], float(alpha), *_launch_geometry((x, gz, dx), 2),
             kernels.stream())
    kernels.check("norm_act_bwd", err)
    kernels.launches["instance_norm_act_bwd"] += 1
    return dx, t1, t2


def instance_norm_act_bwd(x, gz, gamma, beta, mu, rstd, act="relu",
                          alpha=0.2):
    """K6 or its plain version, by the tensor's device."""
    if x.is_cuda:
        return instance_norm_act_bwd_cuda(x, gz, gamma, beta, mu, rstd, act,
                                          alpha)
    if x.device.type == "cpu":
        return instance_norm_act_bwd_plain(x, gz, gamma, beta, mu, rstd, act,
                                           alpha)
    raise ValueError(f"instance_norm_act_bwd: no kernel for device "
                     f"{x.device}")


class InstanceNormAct(torch.autograd.Function):
    """z = act(instance_norm(x) * gamma + beta); forward K2 (which keeps mu
    and rstd), backward K6, dgamma = sum_b t2 and dbeta = sum_b t1 in the
    parameters' dtype, as the Pallas VJP returns them."""

    @staticmethod
    def forward(ctx, x, gamma, beta, eps, act, alpha):
        z, mu, rstd = _instance_norm_act(x, gamma, beta, eps, act, alpha,
                                         with_stats=True)
        ctx.save_for_backward(x, gamma, beta, mu, rstd)
        ctx.act, ctx.alpha = act, alpha
        return z

    @staticmethod
    def backward(ctx, gz):
        x, gamma, beta, mu, rstd = ctx.saved_tensors
        dx, t1, t2 = instance_norm_act_bwd(x, gz.contiguous(), gamma, beta,
                                           mu, rstd, ctx.act, ctx.alpha)
        dgamma = dbeta = None
        if ctx.needs_input_grad[1]:
            dgamma = t2.sum(dim=0).to(gamma.dtype)
        if ctx.needs_input_grad[2]:
            dbeta = t1.sum(dim=0).to(beta.dtype)
        return (dx if ctx.needs_input_grad[0] else None), dgamma, dbeta, \
            None, None, None


def instance_norm_act(x: torch.Tensor, gamma: Optional[torch.Tensor],
                      beta: Optional[torch.Tensor], eps: float = TFA_EPSILON,
                      act: str = "relu", alpha: float = 0.2) -> torch.Tensor:
    """x [B,H,C,W] NHCW; gamma, beta [C] or None (non-affine);
    differentiable in x, gamma and beta."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (x, gamma, beta)):
        return InstanceNormAct.apply(x.contiguous(), gamma, beta, eps, act,
                                     alpha)
    return _instance_norm_act(x.contiguous(), gamma, beta, eps, act, alpha,
                              with_stats=False)
