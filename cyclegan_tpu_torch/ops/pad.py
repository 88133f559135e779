"""Reflection padding (cyclegan_tpu/ops/pad.py ``reflection_pad2d``).

REFLECT semantics, as the reference's ReflectionPadding2D: the edge is not
repeated, so padded row -1 is row 1. In NHWC it pads the reflect
convolution's input (``ops/conv.py``); in NHCW only the plain versions of
the reflect convolution's kernels and the tests use it, since on the card
K9 and K9-dW read their input through the reflected index map.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from cyclegan_tpu_torch.ops import layout


def _reflect_index(n: int, p: int, device) -> torch.Tensor:
    """Source rows of an axis of n reflect-padded by p on both sides."""
    idx = torch.arange(-p, n + p, device=device).abs()
    return torch.where(idx > n - 1, 2 * (n - 1) - idx, idx)


def _check(x, padding, h_axis, w_axis):
    w_pad, h_pad = padding
    if not (h_pad < x.shape[h_axis] and w_pad < x.shape[w_axis]):
        raise ValueError(f"reflect padding {padding} needs pads smaller "
                         f"than the image {tuple(x.shape)}")


def reflection_pad2d_nhcw(x: torch.Tensor,
                          padding: Tuple[int, int] = (1, 1)) -> torch.Tensor:
    """x [B, H, C, W] -> [B, H + 2 h_pad, C, W + 2 w_pad], whatever the
    layout scope (the reflect kernels' plain versions take NHCW)."""
    _check(x, padding, 1, 3)
    w_pad, h_pad = padding
    out = F.pad(x.permute(0, 2, 1, 3), (w_pad, w_pad, h_pad, h_pad),
                mode="reflect")
    return out.permute(0, 2, 1, 3).contiguous()


def reflection_pad2d(x: torch.Tensor,
                     padding: Tuple[int, int] = (1, 1)) -> torch.Tensor:
    """Pad H by h_pad and W by w_pad on both sides, ``padding = (w_pad,
    h_pad)`` as the JAX function takes it; x in the current layout."""
    if layout.is_nhcw():
        return reflection_pad2d_nhcw(x, padding)
    _check(x, padding, 1, 2)
    w_pad, h_pad = padding
    # gather rows, then columns: the result stays NHWC
    rows = _reflect_index(x.shape[1], h_pad, x.device)
    cols = _reflect_index(x.shape[2], w_pad, x.device)
    return x.index_select(1, rows).index_select(2, cols)
