"""Resize ops (cyclegan_tpu/ops/resize.py): the U-Net's up-path junction
and the input pipeline's bilinear resize.

The junction concats the skip and the nearest-2x upsample of x over the
channels. In NHCW it is one op, K4 and K8 or their plain versions by the
tensor's device (``ops/cuda_concat.py``); in NHWC the upsample is a
broadcast and reshape and the concat ``torch.cat``, as in the JAX
package."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from cyclegan_tpu_torch.ops import layout
from cyclegan_tpu_torch.ops.cuda_concat import concat_up2_nhcw


def upsample_nearest_2x(x: torch.Tensor) -> torch.Tensor:
    """Nearest-neighbour 2x upsample of an NHWC tensor (Keras
    ``UpSampling2D()``)."""
    n, h, w, c = x.shape
    return x[:, :, None, :, None, :].expand(n, h, 2, w, 2, c).reshape(
        n, 2 * h, 2 * w, c)


def upsample_concat(skip: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """concat over channels of (skip, nearest-2x upsample of x)."""
    if layout.is_nhcw():
        return concat_up2_nhcw(skip, x)
    return layout.concat_channels([skip, upsample_nearest_2x(x)])


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
