"""Fused instance norm + activation on NHCW activations: kernel K2 and its
plain version.

Replaces cyclegan_tpu/ops/pallas_norm_act.py ``instance_norm_act`` (its
forward kernels ``_fwd_call`` and ``_fwd_stream_call``). The TPU split into
a VMEM-resident and a streamed kernel at 3 MB slabs was a VMEM artefact;
``kernels/csrc/norm_act.cu`` is one design for every slab size.

Bound on the H100: bytes (about 8 flops per element; x read once, the
output written once). One block per (sample, channel) plane reduces in f32
and sweeps the plane again to write; the re-read mostly hits L2.

Statistics as in the JAX package: bf16 input takes one sweep,
var = max(E[x^2] - E[x]^2, 0); f32 input takes two passes. Then
out = act((x - mu) * gamma * rstd + beta).
"""

from __future__ import annotations

from typing import Optional

import torch

from cyclegan_tpu_torch import kernels
from cyclegan_tpu_torch.kernels import F as CF
from cyclegan_tpu_torch.kernels import I, P

TFA_EPSILON = 1e-3
_ACTS = {"none": 0, "relu": 1, "leaky_relu": 2}


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


def instance_norm_act_plain(x: torch.Tensor, gamma: Optional[torch.Tensor],
                            beta: Optional[torch.Tensor],
                            eps: float = TFA_EPSILON, act: str = "relu",
                            alpha: float = 0.2) -> torch.Tensor:
    """The kernel's function with explicit f32 sums over (H, W)."""
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
    g = 1.0 if gamma is None else gamma.float()[:, None]
    b = 0.0 if beta is None else beta.float()[:, None]
    v = (xf - mu) * (g * rstd) + b
    if act == "relu":
        v = torch.clamp(v, min=0.0)
    elif act == "leaky_relu":
        v = torch.where(v >= 0.0, v, v * alpha)
    return v.to(x.dtype)


def instance_norm_act_cuda(x: torch.Tensor, gamma: Optional[torch.Tensor],
                           beta: Optional[torch.Tensor],
                           eps: float = TFA_EPSILON, act: str = "relu",
                           alpha: float = 0.2) -> torch.Tensor:
    """Launch K2 on CUDA tensors."""
    _check(x, gamma, beta, act)
    kernels.check_cuda("instance_norm_act", x, gamma, beta)
    B, H, C, W = x.shape
    out = torch.empty_like(x)
    fn = kernels.function(
        "norm_act", f"instance_norm_act_{kernels.dtype_suffix(x)}",
        [P, P, P, P, I, I, I, I, CF, I, CF, P])
    err = fn(kernels.ptr(x), kernels.ptr(gamma), kernels.ptr(beta),
             kernels.ptr(out), B, H, C, W, float(eps), _ACTS[act],
             float(alpha), kernels.stream())
    kernels.check("norm_act", err)
    kernels.launches["instance_norm_act"] += 1
    return out


def instance_norm_act(x: torch.Tensor, gamma: Optional[torch.Tensor],
                      beta: Optional[torch.Tensor], eps: float = TFA_EPSILON,
                      act: str = "relu", alpha: float = 0.2) -> torch.Tensor:
    """x [B,H,C,W] NHCW; gamma, beta [C] or None (non-affine)."""
    if x.is_cuda:
        return instance_norm_act_cuda(x, gamma, beta, eps, act, alpha)
    if x.device.type == "cpu":
        return instance_norm_act_plain(x, gamma, beta, eps, act, alpha)
    raise ValueError(f"instance_norm_act: no kernel for device {x.device}")
