"""Shared layer helpers (cyclegan_tpu/models/base.py ``init_conv``,
``init_norm``, ``apply_norm_act``).

Parameters live in ``nn.ParameterDict``s whose names are the JAX package's
(``w``, ``b``, ``gamma``, ``beta``), so a model's ``state_dict`` keys are
the checkpoint's paths joined by ``.`` (see ``cyclegan_tpu_torch.weights``).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from cyclegan_tpu_torch.ops import instance_norm
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
    """Instance-norm parameters: ``gamma`` ones, ``beta`` zeros."""
    if norm_type.lower() == "batchnorm":
        raise NotImplementedError(
            "normalization: batchnorm is not ported yet (ROADMAP.md "
            "queue 1, item 5)")
    params = nn.ParameterDict()
    if affine:
        params["gamma"] = nn.Parameter(torch.ones(channels))
        params["beta"] = nn.Parameter(torch.zeros(channels))
    return params


def apply_norm_act(params: nn.ParameterDict, x: torch.Tensor,
                   act: str = "relu", alpha: float = 0.2) -> torch.Tensor:
    """Instance norm then activation: in NHCW one fused op (K2 on the
    card), in NHWC the norm (K13 with ``pallas_norm``, else torch ops) and
    then the activation (``ops/norm.py``)."""
    return instance_norm(x, params["gamma"] if "gamma" in params else None,
                         params["beta"] if "beta" in params else None,
                         act=act, alpha=alpha)
