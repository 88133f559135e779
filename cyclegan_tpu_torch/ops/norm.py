"""Instance norm on NHCW activations (cyclegan_tpu/ops/norm.py
``instance_norm``), fused with the activation that follows it: the
tensor's device picks K2 (forward) and K6 (backward) or their plain
versions (``ops/cuda_norm_act.py``).
Epsilon 1e-3 as tensorflow_addons' InstanceNormalization.
"""

from __future__ import annotations

from typing import Optional

import torch

from cyclegan_tpu_torch.ops.cuda_norm_act import (
    TFA_EPSILON,
    instance_norm_act,
)


def instance_norm(x: torch.Tensor, gamma: Optional[torch.Tensor] = None,
                  beta: Optional[torch.Tensor] = None,
                  eps: float = TFA_EPSILON, act: str = "none",
                  alpha: float = 0.2) -> torch.Tensor:
    return instance_norm_act(x, gamma, beta, eps, act, alpha)
