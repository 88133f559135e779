"""Instance norm (cyclegan_tpu/ops/norm.py ``instance_norm``), with the
activation that follows it. Epsilon 1e-3 as tensorflow_addons'
InstanceNormalization.

- NHCW: norm and activation fused, K2 forward and K6 backward on the card
  (``ops/cuda_norm_act.py``), their plain versions on the CPU.
- NHWC with ``cuda_norm.scope(True)`` (``pallas_norm``): K13 or its plain
  version (``ops/cuda_norm.py``), then the activation.
- NHWC otherwise: torch ops, the counterpart of the JAX package's XLA path:
  f32 takes the two-pass variance, bf16 the single sweep E[x^2] - mean^2,
  both with f32 statistics; then the activation. Autograd differentiates
  them.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from cyclegan_tpu_torch.ops import cuda_norm, layout
from cyclegan_tpu_torch.ops.cuda_norm_act import (
    TFA_EPSILON,
    instance_norm_act,
)


def _xla_instance_norm(x, gamma, beta, eps):
    axes = layout.spatial_axes()
    xf = x.float()
    mean = xf.mean(dim=axes, keepdim=True)
    if x.dtype == torch.bfloat16:
        var = torch.clamp((xf * xf).mean(dim=axes, keepdim=True)
                          - mean * mean, min=0.0)
    else:
        var = ((xf - mean) ** 2).mean(dim=axes, keepdim=True)
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
    if layout.is_nhcw():
        return instance_norm_act(x, gamma, beta, eps, act, alpha)
    if cuda_norm.is_enabled():
        y = cuda_norm.instance_norm_nhwc(x, gamma, beta, eps)
    else:
        y = _xla_instance_norm(x, gamma, beta, eps)
    return activation(y, act, alpha)
