"""The U-Nets' channel concats on NHCW activations and their adjoints:
kernels K4, K8, K11 and K12, their plain versions, and the autograd
Functions that join them.

- The pooled U-Net's up-path junction, concat(skip, upsample2x(x)), replaces
  cyclegan_tpu/ops/pallas_concat.py ``concat_up2_nhcw``: its forward
  ``_concat_up2_call`` (K4, ``kernels/csrc/concat_up2.cu``) and its backward
  ``_split_pool2_call`` (K8, ``kernels/csrc/split_pool2.cu``). Fusing the
  upsample into the concat saves a write and a read of the upsampled
  tensor, and fusing the split with the sums saves the same in the
  backward. K4 and K8 walk row pairs in 16-byte units where
  ``concat_up2_geometry`` allows (K4 reads x once and widens it in
  registers into both rows; K8 reads g once and sums each 16 bytes of a
  row pair into 8 bytes of dx), else one element a unit. K4 copies values
  unconverted and K8 adds in f32 in the Pallas order (row pair, then
  column pair), so both equal their plain versions exactly.
- The plain two-piece channel concat (``ops/layout.concat_channels``)
  replaces ``concat2_nhcw``: its forward ``_concat2_call`` (K11) and its
  backward ``_split2_call`` (K12), both in ``kernels/csrc/concat2.cu``: row
  segmented copies in 16-byte units where the lengths and pointers allow.
  K12 reads the gradient once and writes both pieces. Exact.

Bound on the H100: bytes; the forwards are copies, the backwards copies
plus (K8) 2x2 sums. There is no gate: any W and C run, in bf16 and f32.
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


JUNCTION_THREADS = 256
MAX_ROW_BLOCKS = 65535  # gridDim.y limit


def concat_up2_geometry(b: int, h: int, c1: int, c2: int, w: int,
                        esize: int, aligned: bool = True) -> dict:
    """K4's launch for out [b, h, c1 + c2, w] (skip's shape with c1 + c2
    channels) of ``esize``-byte elements, the rule of
    ``kernels/csrc/concat_up2.cu``: the vector path where every pointer is
    16-byte ``aligned``, a skip row (n1 = c1 w elements) is whole 16-byte
    units and an x row (m = c2 w/2) whole 8-byte ones; else one element a
    unit. A row pair's units are 2 ``skip_units`` then ``x_units``, each
    x unit widened into both rows; ``grid`` is (unit blocks, row-pair
    blocks). K8 (``kernels/csrc/split_pool2.cu``), the adjoint, takes the
    same rule and units for g of that shape, each x unit then a dx unit
    summed from both rows."""
    n1, m = c1 * w, c2 * (w // 2)
    vs, vx = 16 // esize, 8 // esize
    vec = aligned and n1 % vs == 0 and m % vx == 0
    if not vec:
        vs = vx = 1
    units = 2 * (n1 // vs) + m // vx
    pairs = b * (h // 2)
    return {"vec": vec, "vs": vs, "vx": vx, "skip_units": n1 // vs,
            "x_units": m // vx, "pairs": pairs,
            "grid": (-(-units // JUNCTION_THREADS),
                     min(pairs, MAX_ROW_BLOCKS))}


def concat_up2_cuda(skip: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Launch K4 on CUDA tensors, on the path ``concat_up2_geometry``
    chooses from their sizes and pointers."""
    _check(skip, x)
    kernels.check_cuda("concat_up2", skip, x)
    B, H, C1, W = skip.shape
    C2 = x.shape[2]
    out = torch.empty((B, H, C1 + C2, W), dtype=x.dtype, device=x.device)
    aligned = all(t.data_ptr() % 16 == 0 for t in (skip, x, out))
    geo = concat_up2_geometry(B, H, C1, C2, W, x.element_size(), aligned)
    fn = kernels.function("concat_up2",
                          f"concat_up2_{kernels.dtype_suffix(x)}",
                          [P, P, P, I, I, I, I, I, I, P])
    err = fn(kernels.ptr(skip), kernels.ptr(x), kernels.ptr(out), B, H, C1,
             C2, W, int(geo["vec"]), kernels.stream())
    kernels.check("concat_up2", err)
    kernels.launches["concat_up2"] += 1
    kernels.paths["concat_up2." + ("vector" if geo["vec"] else "element")] += 1
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
    """Launch K8 on a CUDA tensor, on the path ``concat_up2_geometry``
    (K4's units, run backward) chooses from its sizes and pointers;
    returns (dskip, dx)."""
    _check_split(g, c1)
    kernels.check_cuda("split_pool2", g)
    B, H, C, W = g.shape
    dskip = torch.empty((B, H, c1, W), dtype=g.dtype, device=g.device)
    dx = torch.empty((B, H // 2, C - c1, W // 2), dtype=g.dtype,
                     device=g.device)
    aligned = all(t.data_ptr() % 16 == 0 for t in (g, dskip, dx))
    geo = concat_up2_geometry(B, H, c1, C - c1, W, g.element_size(),
                              aligned)
    fn = kernels.function("split_pool2",
                          f"split_pool2_{kernels.dtype_suffix(g)}",
                          [P, P, P, I, I, I, I, I, I, P])
    err = fn(kernels.ptr(g), kernels.ptr(dskip), kernels.ptr(dx), B, H, c1,
             C - c1, W, int(geo["vec"]), kernels.stream())
    kernels.check("split_pool2", err)
    kernels.launches["split_pool2"] += 1
    kernels.paths["split_pool2." + ("vector" if geo["vec"] else "element")] \
        += 1
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


def _check2(a, b):
    if (a.dim() != 4 or b.dim() != 4 or a.shape[:2] != b.shape[:2]
            or a.shape[3] != b.shape[3] or a.dtype != b.dtype):
        raise ValueError(f"concat2 takes a [B,H,C1,W] and b [B,H,C2,W] of "
                         f"one dtype, got {tuple(a.shape)} {a.dtype} and "
                         f"{tuple(b.shape)} {b.dtype}")


def concat2_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a ++ b over channels (dim 2)."""
    _check2(a, b)
    return torch.cat([a, b], dim=2)


def concat2_cuda(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Launch K11 on CUDA tensors."""
    _check2(a, b)
    kernels.check_cuda("concat2", a, b)
    B, H, C1, W = a.shape
    C2 = b.shape[2]
    out = torch.empty((B, H, C1 + C2, W), dtype=a.dtype, device=a.device)
    fn = kernels.function("concat2", f"concat2_{kernels.dtype_suffix(a)}",
                          [P, P, P, I, I, I, P])
    err = fn(kernels.ptr(a), kernels.ptr(b), kernels.ptr(out), B * H,
             C1 * W, C2 * W, kernels.stream())
    kernels.check("concat2", err)
    kernels.launches["concat2"] += 1
    return out


def _concat2(a, b):
    if a.is_cuda:
        return concat2_cuda(a, b)
    if a.device.type == "cpu":
        return concat2_plain(a, b)
    raise ValueError(f"concat2: no kernel for device {a.device}")


def _check_split2(g, c1):
    if g.dim() != 4 or not 0 < c1 < g.shape[2]:
        raise ValueError(f"split2 takes g [B,H,C,W] and 0 < C1 < C, got "
                         f"{tuple(g.shape)} and C1 = {c1}")


def split2_plain(g: torch.Tensor, c1: int):
    """(g[:, :, :c1], g[:, :, c1:]), each contiguous."""
    _check_split2(g, c1)
    return g[:, :, :c1].contiguous(), g[:, :, c1:].contiguous()


def split2_cuda(g: torch.Tensor, c1: int):
    """Launch K12 on a CUDA tensor; returns (da, db)."""
    _check_split2(g, c1)
    kernels.check_cuda("split2", g)
    B, H, C, W = g.shape
    da = torch.empty((B, H, c1, W), dtype=g.dtype, device=g.device)
    db = torch.empty((B, H, C - c1, W), dtype=g.dtype, device=g.device)
    fn = kernels.function("concat2", f"split2_{kernels.dtype_suffix(g)}",
                          [P, P, P, I, I, I, P])
    err = fn(kernels.ptr(g), kernels.ptr(da), kernels.ptr(db), B * H,
             c1 * W, (C - c1) * W, kernels.stream())
    kernels.check("concat2", err)
    kernels.launches["split2"] += 1
    return da, db


def split2(g: torch.Tensor, c1: int):
    if g.is_cuda:
        return split2_cuda(g, c1)
    if g.device.type == "cpu":
        return split2_plain(g, c1)
    raise ValueError(f"split2: no kernel for device {g.device}")


class Concat2(torch.autograd.Function):
    """The channel concat: forward K11, backward K12."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.c1 = a.shape[2]
        return _concat2(a, b)

    @staticmethod
    def backward(ctx, g):
        return split2(g.contiguous(), ctx.c1)


def concat2_nhcw(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a [B,H,C1,W] ++ b [B,H,C2,W] -> [B,H,C1+C2,W]; differentiable in
    both."""
    return Concat2.apply(a.contiguous(), b.contiguous())
