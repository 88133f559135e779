"""Shared layer helpers (cyclegan_tpu/models/base.py ``init_conv``,
``init_norm``, ``apply_norm_act``).

Parameters live in ``nn.ParameterDict``s whose names are the JAX package's
(``w``, ``b``, ``gamma``, ``beta``), so a model's ``state_dict`` keys are
the checkpoint's paths joined by ``.`` (see ``cyclegan_tpu_torch.weights``).
A batch norm's moving statistics are buffers of the same block
(``moving_mean``, ``moving_var``, f32), so its ``state_dict`` keys are the
checkpoint's ``model_state`` paths.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from cyclegan_tpu_torch.ops import instance_norm
from cyclegan_tpu_torch.ops.norm import batch_norm
from cyclegan_tpu_torch.ops.init import normal_002


def init_conv(generator: Optional[torch.Generator], kernel: int, in_c: int,
              out_c: int, use_bias: bool = True, kernel_init=normal_002,
              transpose: bool = False) -> nn.ParameterDict:
    """Conv parameters: ``w`` HWIO [K, K, in_c, out_c] (TF-style HWOI
    [K, K, out_c, in_c] for a transposed conv), ``b`` zeros."""
    shape = ((kernel, kernel, out_c, in_c) if transpose
             else (kernel, kernel, in_c, out_c))
    params = nn.ParameterDict({
        "w": nn.Parameter(kernel_init(shape, generator)),
    })
    if use_bias:
        params["b"] = nn.Parameter(torch.zeros(out_c))
    return params


def init_norm(norm_type: str, channels: int,
              affine: bool = True) -> nn.ParameterDict:
    """Norm parameters: ``gamma`` ones, ``beta`` zeros where affine; a
    batch norm also holds the buffers ``moving_mean`` (zeros) and
    ``moving_var`` (ones), f32."""
    params = nn.ParameterDict()
    if affine:
        params["gamma"] = nn.Parameter(torch.ones(channels))
        params["beta"] = nn.Parameter(torch.zeros(channels))
    if norm_type.lower() == "batchnorm":
        params.register_buffer("moving_mean", torch.zeros(channels))
        params.register_buffer("moving_var", torch.ones(channels))
    return params



def apply_norm_act(params: nn.ParameterDict, x: torch.Tensor,
                   act: str = "relu", alpha: float = 0.2) -> torch.Tensor:
    """Norm then activation. Instance norm: in NHCW one fused op (K2 on
    the card), in NHWC the norm (K13 with ``pallas_norm``, else torch ops)
    and then the activation. Batch norm: torch ops in both layouts, in the
    mode ``ops/norm.py`` ``batch_stats`` scopes. Under an H-sharded scope
    the fused K2 (and K13) is off, since its statistics would be one
    strip's: ``instance_norm`` sums them over the strips in torch ops
    (JAX ``base.py:133-140``)."""
    gamma = params["gamma"] if "gamma" in params else None
    beta = params["beta"] if "beta" in params else None
    if hasattr(params, "moving_mean"):
        return batch_norm(x, gamma, beta, params.moving_mean,
                          params.moving_var, params, act, alpha)
    return instance_norm(x, gamma, beta, act=act, alpha=alpha)
