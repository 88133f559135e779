"""The NHCW activation layout (cyclegan_tpu/ops/layout.py).

The port keeps the JAX kernels' ``[B, H, C, W]`` layout through the
generator, with one transpose in and one out, so each kernel here takes
what its TPU counterpart took. Parameters are layout-free.
"""

from __future__ import annotations

import torch


def to_nhcw(x: torch.Tensor) -> torch.Tensor:
    """NHWC -> NHCW, contiguous."""
    return x.transpose(2, 3).contiguous()


def from_nhcw(x: torch.Tensor) -> torch.Tensor:
    """NHCW -> NHWC, contiguous."""
    return x.transpose(2, 3).contiguous()


def channel_param(p: torch.Tensor) -> torch.Tensor:
    """Shape a per-channel vector [C] to broadcast over NHCW: [C, 1]."""
    return p[:, None]
