"""The pooled U-Net's up-path junction, concat(skip, upsample2x(x)) over
channels on NHCW activations: kernel K4 and its plain version.

Replaces cyclegan_tpu/ops/pallas_concat.py ``concat_up2_nhcw`` (its
``_concat_up2_call``), ``kernels/csrc/concat_up2.cu``.

Bound on the H100: bytes; the op is a copy. Fusing the upsample into the
concat saves a write and a read of the upsampled tensor. One thread per
output element, coalesced writes; values are copied unconverted, so the
kernel is exact.
"""

from __future__ import annotations

import torch

from cyclegan_tpu_torch import kernels
from cyclegan_tpu_torch.kernels import I, P


def _check(skip, x):
    if (skip.dim() != 4 or x.dim() != 4 or skip.shape[0] != x.shape[0]
            or skip.shape[1] != 2 * x.shape[1]
            or skip.shape[3] != 2 * x.shape[3]):
        raise ValueError(f"concat_up2 takes skip [B,2h,C1,2w] and x "
                         f"[B,h,C2,w], got {tuple(skip.shape)} and "
                         f"{tuple(x.shape)}")


def concat_up2_plain(skip: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Nearest 2x upsample by expand + reshape, then a channel concat."""
    _check(skip, x)
    B, h, C2, w = x.shape
    up = x[:, :, None, :, :, None].expand(B, h, 2, C2, w, 2)
    return torch.cat([skip, up.reshape(B, 2 * h, C2, 2 * w)], dim=2)


def concat_up2_cuda(skip: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Launch K4 on CUDA tensors."""
    _check(skip, x)
    kernels.check_cuda("concat_up2", skip, x)
    B, H, C1, W = skip.shape
    C2 = x.shape[2]
    out = torch.empty((B, H, C1 + C2, W), dtype=x.dtype, device=x.device)
    fn = kernels.function("concat_up2",
                          f"concat_up2_{kernels.dtype_suffix(x)}",
                          [P, P, P, I, I, I, I, I, P])
    err = fn(kernels.ptr(skip), kernels.ptr(x), kernels.ptr(out), B, H, C1,
             C2, W, kernels.stream())
    kernels.check("concat_up2", err)
    kernels.launches["concat_up2"] += 1
    return out


def concat_up2_nhcw(skip: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """skip [B,2h,C1,2w], x [B,h,C2,w] -> [B,2h,C1+C2,2w], skip first."""
    if x.is_cuda:
        return concat_up2_cuda(skip, x)
    if x.device.type == "cpu":
        return concat_up2_plain(skip, x)
    raise ValueError(f"concat_up2: no kernel for device {x.device}")
