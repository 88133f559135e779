"""The NHCW activation layout (cyclegan_tpu/ops/layout.py).

The port keeps the JAX kernels' ``[B, H, C, W]`` layout through the
generator, with one transpose in and one out, so each kernel here takes
what its TPU counterpart took. Parameters are layout-free.
"""

from __future__ import annotations

from typing import Sequence

import torch

from cyclegan_tpu_torch.ops.cuda_concat import concat2_nhcw


def to_nhcw(x: torch.Tensor) -> torch.Tensor:
    """NHWC -> NHCW, contiguous."""
    return x.transpose(2, 3).contiguous()


def from_nhcw(x: torch.Tensor) -> torch.Tensor:
    """NHCW -> NHWC, contiguous."""
    return x.transpose(2, 3).contiguous()


def concat_channels(xs: Sequence[torch.Tensor]) -> torch.Tensor:
    """Concat over the channel axis (2). Two pieces go through K11 and its
    split K12 (``cuda_concat.concat2_nhcw``) on the card and their plain
    versions on the CPU; any other number is ``torch.cat``, as the JAX
    package sends it to ``jnp.concatenate``."""
    if len(xs) == 2:
        return concat2_nhcw(*xs)
    return torch.cat(list(xs), dim=2)


def channel_param(p: torch.Tensor) -> torch.Tensor:
    """Shape a per-channel vector [C] to broadcast over NHCW: [C, 1]."""
    return p[:, None]
