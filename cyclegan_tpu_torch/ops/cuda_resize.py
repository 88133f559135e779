"""Scaled 2x2 block sum on NHCW activations (the average pool): kernel K3
and its plain version.

Replaces cyclegan_tpu/ops/pallas_resize.py ``avg_pool2x2_nhcw`` (its
``_sum2x2_call``), ``kernels/csrc/sum2x2.cu``.

Bound on the H100: bytes (3 flops per 5 elements moved). One thread per
output element with coalesced reads of the two input rows; the sum is f32,
row pair first and column pair second as in the Pallas kernel, so the
kernel and the plain version agree exactly.
"""

from __future__ import annotations

import torch

from cyclegan_tpu_torch import kernels
from cyclegan_tpu_torch.kernels import F as CF
from cyclegan_tpu_torch.kernels import I, P


def _check(x):
    if x.dim() != 4 or x.shape[1] % 2 or x.shape[3] % 2:
        raise ValueError(f"sum2x2 takes x [B,H,C,W] with even H and W, got "
                         f"{tuple(x.shape)}")


def sum2x2_plain(x: torch.Tensor, scale: float = 1.0) -> torch.Tensor:
    """[B,H,C,W] -> [B,H/2,C,W/2] by reshapes and f32 adds."""
    _check(x)
    B, H, C, W = x.shape
    v = x.float().reshape(B, H // 2, 2, C, W // 2, 2)
    rows = v[:, :, 0] + v[:, :, 1]                  # [B,H/2,C,W/2,2]
    return ((rows[..., 0] + rows[..., 1]) * scale).to(x.dtype)


def sum2x2_cuda(x: torch.Tensor, scale: float = 1.0) -> torch.Tensor:
    """Launch K3 on a CUDA tensor."""
    _check(x)
    kernels.check_cuda("sum2x2", x)
    B, H, C, W = x.shape
    out = torch.empty((B, H // 2, C, W // 2), dtype=x.dtype, device=x.device)
    fn = kernels.function("sum2x2", f"sum2x2_{kernels.dtype_suffix(x)}",
                          [P, P, I, I, I, I, CF, P])
    err = fn(kernels.ptr(x), kernels.ptr(out), B, H, C, W, float(scale),
             kernels.stream())
    kernels.check("sum2x2", err)
    kernels.launches["sum2x2"] += 1
    return out


def sum2x2(x: torch.Tensor, scale: float = 1.0) -> torch.Tensor:
    if x.is_cuda:
        return sum2x2_cuda(x, scale)
    if x.device.type == "cpu":
        return sum2x2_plain(x, scale)
    raise ValueError(f"sum2x2: no kernel for device {x.device}")


def avg_pool2x2_nhcw(x: torch.Tensor) -> torch.Tensor:
    """2x2 average pool, stride 2, NHCW."""
    return sum2x2(x, 0.25)
