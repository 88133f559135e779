"""The 2x2 average pool on NHCW activations and its gradient: kernels K3
(scaled 2x2 block sum) and K7 (scaled 2x duplication), their plain
versions, and the autograd Function that joins them.

Replaces cyclegan_tpu/ops/pallas_resize.py ``avg_pool2x2_nhcw``: its
forward ``_sum2x2_call`` (K3, ``kernels/csrc/sum2x2.cu``) and its backward
``_dup2x2_call`` at scale 1/4 (K7, ``kernels/csrc/dup2x2.cu``).

Bound on the H100: bytes (under one flop per element moved). Both walk
NHCW rows by units with no channel or column index (``row_units.cuh``).
K3 reads 16 bytes of each row of an x row pair a unit and writes their 8
bytes of pair sums where ``sum2x2_geometry`` allows (an NHCW output row
pools element pairs of two x rows), else one element a unit. K7 walks x's
rows in 8-byte units where ``dup2x2_geometry`` allows, each widened in
registers into both output rows (an NHCW output row is x's row with every
element twice), else one element a unit. K3 adds in f32, row pair first
and column pair second as the Pallas kernel, then scales, and K7
multiplies in f32; both round once, so both kernels equal their plain
versions exactly.
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


POOL_THREADS = 256
MAX_ROW_BLOCKS = 65535  # gridDim.y limit


def sum2x2_geometry(b: int, h: int, c: int, w: int, esize: int,
                    aligned: bool = True) -> dict:
    """K3's launch for x [b, h, c, w] of ``esize``-byte elements, the rule
    of ``kernels/csrc/sum2x2.cu``: the vector path where both pointers are
    16-byte ``aligned`` and an x row (c w elements) is whole 16-byte
    units, that is, an output row (m = c w/2 elements) whole 8-byte units;
    else one element a unit. Each of the b h/2 output rows has ``units``
    units of ``vx`` elements, each pooled from 2 vx elements of both x
    rows of its pair; ``grid`` is (unit blocks, row blocks)."""
    m = c * (w // 2)
    vx = 8 // esize
    vec = aligned and m % vx == 0
    if not vec:
        vx = 1
    rows = b * (h // 2)
    return {"vec": vec, "vx": vx, "units": m // vx, "rows": rows,
            "grid": (-(-(m // vx) // POOL_THREADS),
                     min(rows, MAX_ROW_BLOCKS))}


def sum2x2_cuda(x: torch.Tensor, scale: float = 1.0) -> torch.Tensor:
    """Launch K3 on a CUDA tensor, on the path ``sum2x2_geometry`` chooses
    from its size and pointers."""
    _check(x)
    kernels.check_cuda("sum2x2", x)
    B, H, C, W = x.shape
    out = torch.empty((B, H // 2, C, W // 2), dtype=x.dtype, device=x.device)
    aligned = all(t.data_ptr() % 16 == 0 for t in (x, out))
    geo = sum2x2_geometry(B, H, C, W, x.element_size(), aligned)
    fn = kernels.function("sum2x2", f"sum2x2_{kernels.dtype_suffix(x)}",
                          [P, P, I, I, I, I, CF, I, P])
    err = fn(kernels.ptr(x), kernels.ptr(out), B, H, C, W, float(scale),
             int(geo["vec"]), kernels.stream())
    kernels.check("sum2x2", err)
    kernels.launches["sum2x2"] += 1
    kernels.paths["sum2x2." + ("vector" if geo["vec"] else "element")] += 1
    return out


def sum2x2(x: torch.Tensor, scale: float = 1.0) -> torch.Tensor:
    return kernels.dispatch("sum2x2", sum2x2_cuda, sum2x2_plain, x, scale)


def _check_dup(x):
    if x.dim() != 4:
        raise ValueError(f"dup2x2 takes x [B,h,C,w], got {tuple(x.shape)}")


def dup2x2_plain(x: torch.Tensor, scale: float = 1.0) -> torch.Tensor:
    """[B,h,C,w] -> [B,2h,C,2w]: each element times ``scale`` in f32,
    rounded once, then repeated over a 2x2 block by expand + reshape."""
    _check_dup(x)
    B, h, C, w = x.shape
    v = (x.float() * scale).to(x.dtype)
    return v[:, :, None, :, :, None].expand(B, h, 2, C, w, 2).reshape(
        B, 2 * h, C, 2 * w)


DUP_THREADS = 256


def dup2x2_geometry(b: int, h: int, c: int, w: int, esize: int,
                    aligned: bool = True) -> dict:
    """K7's launch for x [b, h, c, w] of ``esize``-byte elements, the rule
    of ``kernels/csrc/dup2x2.cu``: the vector path where both pointers are
    16-byte ``aligned`` and an x row (m = c w elements) is whole 8-byte
    units; else one element a unit. Each of the b h rows of x has
    ``units`` units of ``vx`` elements, each widened into both output
    rows; ``grid`` is (unit blocks, row blocks)."""
    m = c * w
    vx = 8 // esize
    vec = aligned and m % vx == 0
    if not vec:
        vx = 1
    rows = b * h
    return {"vec": vec, "vx": vx, "units": m // vx, "rows": rows,
            "grid": (-(-(m // vx) // DUP_THREADS),
                     min(rows, MAX_ROW_BLOCKS))}


def dup2x2_cuda(x: torch.Tensor, scale: float = 1.0) -> torch.Tensor:
    """Launch K7 on a CUDA tensor, on the path ``dup2x2_geometry``
    chooses from its size and pointers."""
    _check_dup(x)
    kernels.check_cuda("dup2x2", x)
    B, h, C, w = x.shape
    out = torch.empty((B, 2 * h, C, 2 * w), dtype=x.dtype, device=x.device)
    aligned = all(t.data_ptr() % 16 == 0 for t in (x, out))
    geo = dup2x2_geometry(B, h, C, w, x.element_size(), aligned)
    fn = kernels.function("dup2x2", f"dup2x2_{kernels.dtype_suffix(x)}",
                          [P, P, I, I, I, I, CF, I, P])
    err = fn(kernels.ptr(x), kernels.ptr(out), B, h, C, w, float(scale),
             int(geo["vec"]), kernels.stream())
    kernels.check("dup2x2", err)
    kernels.launches["dup2x2"] += 1
    kernels.paths["dup2x2." + ("vector" if geo["vec"] else "element")] += 1
    return out


def dup2x2(x: torch.Tensor, scale: float = 1.0) -> torch.Tensor:
    return kernels.dispatch("dup2x2", dup2x2_cuda, dup2x2_plain, x, scale)


class AvgPool2x2(torch.autograd.Function):
    """2x2 average pool: forward K3 at scale 1/4, backward K7 at 1/4."""

    @staticmethod
    def forward(ctx, x):
        return sum2x2(x, 0.25)

    @staticmethod
    def backward(ctx, g):
        return dup2x2(g.contiguous(), 0.25)


def avg_pool2x2_nhcw(x: torch.Tensor) -> torch.Tensor:
    """2x2 average pool, stride 2, NHCW; differentiable."""
    return AvgPool2x2.apply(x.contiguous())
