"""Reflection padding on NHCW activations (cyclegan_tpu/ops/pad.py
``reflection_pad2d``).

REFLECT semantics, as the reference's ReflectionPadding2D: the edge is not
repeated, so padded row -1 is row 1. Only the plain versions of the reflect
convolution's kernels and the tests use it; on the card K9 and K9-dW read
their input through the reflected index map instead.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F


def reflection_pad2d(x: torch.Tensor,
                     padding: Tuple[int, int] = (1, 1)) -> torch.Tensor:
    """x [B, H, C, W] -> [B, H + 2 h_pad, C, W + 2 w_pad];
    ``padding = (w_pad, h_pad)`` as the JAX function takes it."""
    w_pad, h_pad = padding
    if not (h_pad < x.shape[1] and w_pad < x.shape[3]):
        raise ValueError(f"reflect padding {padding} needs pads smaller "
                         f"than the image {tuple(x.shape)}")
    nchw = x.permute(0, 2, 1, 3)
    out = F.pad(nchw, (w_pad, w_pad, h_pad, h_pad), mode="reflect")
    return out.permute(0, 2, 1, 3).contiguous()
