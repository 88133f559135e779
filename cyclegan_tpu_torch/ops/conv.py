"""Convolution on NHCW activations with HWIO weights
(cyclegan_tpu/ops/conv.py ``conv2d``).

The port takes stride-1 'SAME' convolutions only, which is every conv of
the pooled U-Net; the tensor's device picks K1 (forward, input gradient) and
K5 (weight gradient) or their plain versions (``ops/cuda_conv.py``).
"""

from __future__ import annotations

from typing import Optional

import torch

from cyclegan_tpu_torch.ops.cuda_conv import conv_same


def conv2d(x: torch.Tensor, kernel: torch.Tensor,
           bias: Optional[torch.Tensor] = None, stride: int = 1,
           padding: str = "SAME") -> torch.Tensor:
    if stride != 1 or padding != "SAME":
        raise NotImplementedError(
            f"conv2d(stride={stride}, padding={padding!r}): only stride-1 "
            f"SAME is ported (ROADMAP.md queue 1, later slices)")
    return conv_same(x, kernel, bias)
