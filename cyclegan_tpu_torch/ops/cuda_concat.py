"""The pooled U-Net's up-path junction, concat(skip, upsample2x(x)) over
channels on NHCW activations, and its adjoint: kernels K4 and K8, their
plain versions, and the autograd Function that joins them.

Replaces cyclegan_tpu/ops/pallas_concat.py ``concat_up2_nhcw``: its forward
``_concat_up2_call`` (K4, ``kernels/csrc/concat_up2.cu``) and its backward
``_split_pool2_call`` (K8, ``kernels/csrc/split_pool2.cu``).

Bound on the H100: bytes; the forward is a copy, the backward a copy plus
2x2 sums. Fusing the upsample into the concat saves a write and a read of
the upsampled tensor, and fusing the split with the sums saves the same in
the backward. One thread per output element, coalesced writes. K4 copies
values unconverted and K8 adds in f32 in the Pallas order (row pair, then
column pair), so both equal their plain versions exactly.
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


def _concat_up2(skip, x):
    if x.is_cuda:
        return concat_up2_cuda(skip, x)
    if x.device.type == "cpu":
        return concat_up2_plain(skip, x)
    raise ValueError(f"concat_up2: no kernel for device {x.device}")


def _check_split(g, c1):
    if g.dim() != 4 or g.shape[1] % 2 or g.shape[3] % 2 \
            or not 0 < c1 < g.shape[2]:
        raise ValueError(f"split_pool2 takes g [B,H,C1+C2,W] with even H and "
                         f"W and 0 < C1 < C, got {tuple(g.shape)} and "
                         f"C1 = {c1}")


def split_pool2_plain(g: torch.Tensor, c1: int):
    """(dskip, dx): the first c1 channels of g, and the f32 2x2 block sums
    of the rest, row pair first."""
    _check_split(g, c1)
    B, H, C, W = g.shape
    v = g[:, :, c1:].float().reshape(B, H // 2, 2, C - c1, W // 2, 2)
    rows = v[:, :, 0] + v[:, :, 1]
    return g[:, :, :c1].contiguous(), (rows[..., 0] + rows[..., 1]).to(g.dtype)


def split_pool2_cuda(g: torch.Tensor, c1: int):
    """Launch K8 on a CUDA tensor; returns (dskip, dx)."""
    _check_split(g, c1)
    kernels.check_cuda("split_pool2", g)
    B, H, C, W = g.shape
    dskip = torch.empty((B, H, c1, W), dtype=g.dtype, device=g.device)
    dx = torch.empty((B, H // 2, C - c1, W // 2), dtype=g.dtype,
                     device=g.device)
    fn = kernels.function("split_pool2",
                          f"split_pool2_{kernels.dtype_suffix(g)}",
                          [P, P, P, I, I, I, I, I, P])
    err = fn(kernels.ptr(g), kernels.ptr(dskip), kernels.ptr(dx), B, H, c1,
             C - c1, W, kernels.stream())
    kernels.check("split_pool2", err)
    kernels.launches["split_pool2"] += 1
    return dskip, dx


def split_pool2(g: torch.Tensor, c1: int):
    if g.is_cuda:
        return split_pool2_cuda(g, c1)
    if g.device.type == "cpu":
        return split_pool2_plain(g, c1)
    raise ValueError(f"split_pool2: no kernel for device {g.device}")


class ConcatUp2(torch.autograd.Function):
    """The junction: forward K4, backward K8."""

    @staticmethod
    def forward(ctx, skip, x):
        ctx.c1 = skip.shape[2]
        return _concat_up2(skip, x)

    @staticmethod
    def backward(ctx, g):
        return split_pool2(g.contiguous(), ctx.c1)


def concat_up2_nhcw(skip: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """skip [B,2h,C1,2w], x [B,h,C2,w] -> [B,2h,C1+C2,2w], skip first;
    differentiable in both."""
    return ConcatUp2.apply(skip.contiguous(), x.contiguous())
