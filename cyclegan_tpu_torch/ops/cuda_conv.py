"""Stride-1 TF-'SAME' convolution on NHCW activations and its gradients:
kernels K1 (forward and input gradient) and K5 (weight gradient), their
plain versions, and the autograd Function that joins them.

Replaces cyclegan_tpu/ops/pallas_conv.py ``conv2d_same_nhcw`` (its
``_conv_fwd_call`` and custom VJP, whose dW is ``_conv_dw_call``) and
``conv1x1_nhcw`` (``_conv1x1_call``, its dW ``_conv1x1_dw_call``):

- K1, ``kernels/csrc/conv_same.cu``, takes every K, K = 1 included, an
  optional bias added to the f32 sum, and the zero padding before the image
  as an argument: the forward pads (K-1)/2 before, the input gradient (K1 on
  dY with flipped, ci<->co-swapped weights) K-1-(K-1)/2, which is 2 for k4.
- K5, ``kernels/csrc/conv_dw.cu``, sums patches(x)^T . dY over B*H*W in f32
  for every K: a split reduction whose splits are added in a fixed order.

Bound on the H100: operations (16-100 multiply-adds per byte moved at the
generator's shapes). Both kernels run on the CUDA cores in f32 with their
operands staged in shared memory and register tiles; see the sources. They
do not use the tensor cores yet.

``conv_same`` is the differentiable op: ``ConvSame`` launches the kernels
for CUDA tensors and takes the plain versions only for tensors on the CPU,
forward and backward alike. The bias gradient is a torch sum, as JAX adds
the bias outside the kernel (cyclegan_tpu/ops/conv.py).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from cyclegan_tpu_torch import kernels
from cyclegan_tpu_torch.kernels import I, P

# K5's block tile (conv_dw.cu MT, NT) and the blocks it aims to keep in flight
_DW_TILE_M, _DW_TILE_N, _DW_BLOCKS = 64, 32, 8 * 132


def tf_same_pad(k: int):
    """TF 'SAME' (before, after) padding at stride 1: (1, 2) for k4."""
    before = (k - 1) // 2
    return before, k - 1 - before


def _check_shapes(x, w, bias, pad):
    if x.dim() != 4 or w.dim() != 4:
        raise ValueError(f"conv_same takes x [B,H,C,W] and w [K,K,C,Cout], "
                         f"got {tuple(x.shape)} and {tuple(w.shape)}")
    if w.shape[0] != w.shape[1] or w.shape[2] != x.shape[2]:
        raise ValueError(f"weights {tuple(w.shape)} do not fit input "
                         f"{tuple(x.shape)} (square HWIO with C = "
                         f"{x.shape[2]} expected)")
    if bias is not None and tuple(bias.shape) != (w.shape[3],):
        raise ValueError(f"bias {tuple(bias.shape)} for {w.shape[3]} "
                         f"output channels")
    if pad is not None and not 0 <= pad <= w.shape[0] - 1:
        raise ValueError(f"pad {pad} outside [0, {w.shape[0] - 1}]")


def _pad_before(w, pad):
    return tf_same_pad(int(w.shape[0]))[0] if pad is None else int(pad)


def conv_same_plain(x: torch.Tensor, w: torch.Tensor,
                    bias: Optional[torch.Tensor] = None,
                    pad: Optional[int] = None) -> torch.Tensor:
    """The kernel's function in PyTorch ops: explicit zero pad (``pad``
    before, the rest after; TF SAME if None), then a VALID conv in f32, then
    one rounding to the input dtype."""
    _check_shapes(x, w, bias, pad)
    k = int(w.shape[0])
    before = _pad_before(w, pad)
    after = k - 1 - before
    xf = x.float().permute(0, 2, 1, 3)                    # NCHW view
    xf = F.pad(xf, (before, after, before, after))
    wf = w.float().permute(3, 2, 0, 1)                    # OIHW
    y = F.conv2d(xf, wf, None if bias is None else bias.float())
    return y.permute(0, 2, 1, 3).contiguous().to(x.dtype)


def conv_same_cuda(x: torch.Tensor, w: torch.Tensor,
                   bias: Optional[torch.Tensor] = None,
                   pad: Optional[int] = None) -> torch.Tensor:
    """Launch K1 on CUDA tensors."""
    _check_shapes(x, w, bias, pad)
    kernels.check_cuda("conv_same", x, w, bias)
    B, H, C, W = x.shape
    K, Cout = int(w.shape[0]), int(w.shape[3])
    out = torch.empty((B, H, Cout, W), dtype=x.dtype, device=x.device)
    fn = kernels.function("conv_same", f"conv_same_{kernels.dtype_suffix(x)}",
                          [P, P, P, P, I, I, I, I, I, I, I, P])
    err = fn(kernels.ptr(x), kernels.ptr(w), kernels.ptr(bias),
             kernels.ptr(out), B, H, C, W, Cout, K, _pad_before(w, pad),
             kernels.stream())
    kernels.check("conv_same", err)
    kernels.launches["conv_same"] += 1
    return out


def _conv_same(x, w, bias=None, pad=None):
    """K1 or its plain version, by the tensor's device; not differentiable."""
    if x.is_cuda:
        return conv_same_cuda(x, w, bias, pad=pad)
    if x.device.type == "cpu":
        return conv_same_plain(x, w, bias, pad=pad)
    raise ValueError(f"conv_same: no kernel for device {x.device}")


def _check_dw(x, g, k, pad):
    if (x.dim() != 4 or g.dim() != 4 or x.shape[0] != g.shape[0]
            or x.shape[1] != g.shape[1] or x.shape[3] != g.shape[3]):
        raise ValueError(f"conv_dw takes x [B,H,C,W] and g [B,H,Cout,W], "
                         f"got {tuple(x.shape)} and {tuple(g.shape)}")
    if not 0 <= pad <= k - 1:
        raise ValueError(f"pad {pad} outside [0, {k - 1}]")


def dw_of_padded(xp: torch.Tensor, g: torch.Tensor, k: int) -> torch.Tensor:
    """dW [K,K,C,Cout] f32 of a VALID stride-1 conv of the padded input
    xp [B, H+K-1, C, W+K-1]: per tap, the f32 contraction of the shifted
    input with g [B, H, Cout, W] over (B, H, W)."""
    B, H, _, W = g.shape
    xf, gf = xp.float(), g.float()
    dw = torch.empty((k, k, xp.shape[2], g.shape[2]), dtype=torch.float32,
                     device=xp.device)
    for dy in range(k):
        for dx in range(k):
            dw[dy, dx] = torch.einsum("bhcw,bhow->co",
                                      xf[:, dy:dy + H, :, dx:dx + W], gf)
    return dw


def conv_dw_plain(x: torch.Tensor, g: torch.Tensor, k: int,
                  pad: int) -> torch.Tensor:
    """dW [K,K,C,Cout] f32 of a stride-1 conv that padded ``pad`` before,
    with zeros."""
    _check_dw(x, g, k, pad)
    xp = F.pad(x.float(), (pad, k - 1 - pad, 0, 0, pad, k - 1 - pad))
    return dw_of_padded(xp, g, k)


def dw_splits(k: int, c: int, cout: int, rows: int) -> int:
    """How many slices of the B*H rows K5 splits its sum into: enough
    blocks to fill the card, never more slices than rows."""
    tiles = math.ceil(k * k * c / _DW_TILE_M) * math.ceil(cout / _DW_TILE_N)
    return max(1, min(rows, math.ceil(_DW_BLOCKS / tiles)))


def conv_dw_cuda(x: torch.Tensor, g: torch.Tensor, k: int,
                 pad: int) -> torch.Tensor:
    """Launch K5 on CUDA tensors; returns dW [K,K,C,Cout] in f32."""
    _check_dw(x, g, k, pad)
    kernels.check_cuda("conv_dw", x, g)
    B, H, C, W = x.shape
    Cout = int(g.shape[2])
    splits = dw_splits(k, C, Cout, B * H)
    part = torch.empty((splits, k * k * C, Cout), dtype=torch.float32,
                       device=x.device)
    dw = torch.empty((k, k, C, Cout), dtype=torch.float32, device=x.device)
    fn = kernels.function("conv_dw", f"conv_dw_{kernels.dtype_suffix(x)}",
                          [P, P, P, P, I, I, I, I, I, I, I, I, P])
    err = fn(kernels.ptr(x), kernels.ptr(g), kernels.ptr(part),
             kernels.ptr(dw), B, H, C, W, Cout, k, pad, splits,
             kernels.stream())
    kernels.check("conv_dw", err)
    kernels.launches["conv_dw"] += 1
    return dw


def conv_dw(x: torch.Tensor, g: torch.Tensor, k: int,
            pad: int) -> torch.Tensor:
    """K5 or its plain version, by the tensor's device."""
    if x.is_cuda:
        return conv_dw_cuda(x, g, k, pad)
    if x.device.type == "cpu":
        return conv_dw_plain(x, g, k, pad)
    raise ValueError(f"conv_dw: no kernel for device {x.device}")


class ConvSame(torch.autograd.Function):
    """y = conv_same(x, w, bias); dX by K1, dW by K5, each only where its
    input needs a gradient. dW comes back in the weights' dtype, as the
    Pallas VJP returns it (bf16 in bf16 mode, before autograd's cast to the
    f32 master)."""

    @staticmethod
    def forward(ctx, x, w, bias):
        ctx.save_for_backward(x, w)
        ctx.bias_dtype = None if bias is None else bias.dtype
        return _conv_same(x, w, bias)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g = g.contiguous()
        k = int(w.shape[0])
        before = tf_same_pad(k)[0]
        dx = dw = db = None
        if ctx.needs_input_grad[0]:
            w_t = w.flip(0, 1).transpose(2, 3).contiguous()
            dx = _conv_same(g, w_t, pad=k - 1 - before)
        if ctx.needs_input_grad[1]:
            dw = conv_dw(x, g, k, before).to(w.dtype)
        if ctx.needs_input_grad[2]:
            db = g.float().sum(dim=(0, 1, 3)).to(ctx.bias_dtype)
        return dx, dw, db


def conv_same(x: torch.Tensor, w: torch.Tensor,
              bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x [B,H,C,W] NHCW, w [K,K,C,Cout] HWIO -> [B,H,Cout,W]; differentiable
    in x, w and bias."""
    return ConvSame.apply(x.contiguous(), w.contiguous(), bias)
