"""Stride-1 TF-'SAME' convolution on NHCW activations: kernel K1 and its
plain version.

Replaces cyclegan_tpu/ops/pallas_conv.py ``conv2d_same_nhcw`` (its
``_conv_fwd_call``) and ``conv1x1_nhcw`` (its ``_conv1x1_call``): one CUDA
kernel, ``kernels/csrc/conv_same.cu``, takes every K, K = 1 included, with an
optional bias added to the f32 sum.

Bound on the H100: operations (16-100 multiply-adds per byte moved at the
generator's shapes). The kernel is a direct convolution on the CUDA cores:
input windows and weights staged in shared memory, sixteen output channels
of one pixel per thread in registers; see the source for the tiling. It
does not use the tensor cores yet.

``conv_same`` launches the kernel for a CUDA tensor and takes the plain
version only for a tensor on the CPU.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from cyclegan_tpu_torch import kernels
from cyclegan_tpu_torch.kernels import I, P


def tf_same_pad(k: int):
    """TF 'SAME' (before, after) padding at stride 1: (1, 2) for k4."""
    before = (k - 1) // 2
    return before, k - 1 - before


def _check_shapes(x, w, bias):
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


def conv_same_plain(x: torch.Tensor, w: torch.Tensor,
                    bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The kernel's function in PyTorch ops: explicit TF-SAME pad, then a
    VALID conv in f32, then one rounding to the input dtype."""
    _check_shapes(x, w, bias)
    before, after = tf_same_pad(int(w.shape[0]))
    xf = x.float().permute(0, 2, 1, 3)                    # NCHW view
    xf = F.pad(xf, (before, after, before, after))
    wf = w.float().permute(3, 2, 0, 1)                    # OIHW
    y = F.conv2d(xf, wf, None if bias is None else bias.float())
    return y.permute(0, 2, 1, 3).contiguous().to(x.dtype)


def conv_same_cuda(x: torch.Tensor, w: torch.Tensor,
                   bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Launch K1 on CUDA tensors."""
    _check_shapes(x, w, bias)
    kernels.check_cuda("conv_same", x, w, bias)
    B, H, C, W = x.shape
    K, Cout = int(w.shape[0]), int(w.shape[3])
    out = torch.empty((B, H, Cout, W), dtype=x.dtype, device=x.device)
    fn = kernels.function("conv_same", f"conv_same_{kernels.dtype_suffix(x)}",
                          [P, P, P, P, I, I, I, I, I, I, P])
    err = fn(kernels.ptr(x), kernels.ptr(w), kernels.ptr(bias),
             kernels.ptr(out), B, H, C, W, Cout, K, kernels.stream())
    kernels.check("conv_same", err)
    kernels.launches["conv_same"] += 1
    return out


def conv_same(x: torch.Tensor, w: torch.Tensor,
              bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x [B,H,C,W] NHCW, w [K,K,C,Cout] HWIO -> [B,H,Cout,W]."""
    if x.is_cuda:
        return conv_same_cuda(x, w, bias)
    if x.device.type == "cpu":
        return conv_same_plain(x, w, bias)
    raise ValueError(f"conv_same: no kernel for device {x.device}")
