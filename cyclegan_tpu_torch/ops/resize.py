"""Resize ops (cyclegan_tpu/ops/resize.py): the up-path junction on NHCW
activations, K4 and K8 or their plain versions by the tensor's device
(``ops/cuda_concat.py``), and the input pipeline's bilinear resize."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from cyclegan_tpu_torch.ops.cuda_concat import concat_up2_nhcw


def upsample_concat(skip: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """concat over channels of (skip, nearest-2x upsample of x)."""
    return concat_up2_nhcw(skip, x)


def resize_bilinear(x: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """NHWC bilinear resize as ``tf.image.resize``'s default: half-pixel
    centres, no antialiasing (``jax.image.resize(..., "bilinear",
    antialias=False)`` in the JAX package), computed in f32. Floating input
    keeps its dtype; other input comes back f32."""
    y = F.interpolate(x.to(torch.float32).permute(0, 3, 1, 2),
                      size=(height, width), mode="bilinear",
                      align_corners=False, antialias=False)
    y = y.permute(0, 2, 3, 1).contiguous()
    return y.to(x.dtype) if x.is_floating_point() else y
