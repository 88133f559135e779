"""Reflect-padded stride-1 convolution on NHCW activations and its
gradients: kernels K9 (forward), K9-dW (weight gradient) and K10 (the fold
of the input gradient), their plain versions, and the autograd Function
that joins them with K1.

Replaces cyclegan_tpu/ops/pallas_conv.py ``conv2d_reflect_nhcw``, a custom
VJP built from two Pallas calls:

- forward: a reflect pad by K//2, then ``_conv_fwd_call`` on the padded
  input. K9 (``conv_reflect`` in ``kernels/csrc/conv_same.cu``) is K1's
  design on the reflect-padded input: in bf16 its pack kernel writes the
  padded, channel-grouped copy through the reflected index map
  (``cuda_conv.conv_tc_pack_plain(..., reflect=True)`` is its plain
  version) and the tensor-core product runs at pad 0; in f32 (counted
  under ``conv_same_simt`` as well) the CUDA-core design stages its input
  window through the same map, with no copy. Odd K only, K//2 < H and
  K//2 < W.
- dW: ``_conv_dw_call`` on the reflect-padded input. K9-dW
  (``conv_reflect_dw`` in ``kernels/csrc/conv_dw.cu``) in bf16 is K5's
  tap-ring design at pad K//2 with the reflect pad an index map of its
  loads: reflected rows, and reflected columns at the W edges, with no
  padded copy (JAX pads in XLA); in f32, and in bf16 outside K5's domain,
  it is K5's CUDA-core design staging its im2col tile through the same
  map. Paths counted as ``conv_reflect_dw.ring`` / ``.simt``.
- dX: ``_conv_fwd_call`` as the full correlation of dY with the flipped,
  ci<->co-swapped weights over the padded domain (side H + 2p), then a fold
  of the halo rows and columns back through the reflect map. Here K1
  computes that correlation at pad p and grow p, writing the zero pad of
  dY itself (these launches count under ``conv_same``), and K10
  (``kernels/csrc/reflect_fold.cu``) folds it: a thread makes a 16-byte
  unit of one output row where ``reflect_fold_geometry`` allows (else one
  element), adding its source rows and, at a channel's edges, the halo
  columns in the order the plain version adds them, so K10 is exact
  against it.

Bound on the H100: K9 and K9-dW by operations, as K1 and K5; K10 by bytes.
The bias gradient is a torch sum, as ``ConvSame``'s.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from cyclegan_tpu_torch import kernels
from cyclegan_tpu_torch.kernels import I, P
from cyclegan_tpu_torch.ops import cuda_conv
from cyclegan_tpu_torch.ops.pad import reflection_pad2d_nhcw


def _check_pad(k: int, h: int, w: int) -> None:
    if k % 2 != 1:
        raise ValueError(f"reflect conv takes odd kernels, got {k}")
    if not (k // 2 < h and k // 2 < w):
        raise ValueError(f"reflect pad {k // 2} needs an image larger than "
                         f"{h}x{w}")


def _check(x, w, bias):
    cuda_conv._check_shapes(x, w, bias, None)
    _check_pad(int(w.shape[0]), int(x.shape[1]), int(x.shape[3]))


def conv_reflect_plain(x: torch.Tensor, w: torch.Tensor,
                       bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The kernel's function in PyTorch ops: reflect pad by K//2, a VALID
    conv in f32 (bias in the f32 sum), one rounding to the input dtype."""
    _check(x, w, bias)
    p = int(w.shape[0]) // 2
    xp = reflection_pad2d_nhcw(x.float(), (p, p)).permute(0, 2, 1, 3)
    y = F.conv2d(xp, w.float().permute(3, 2, 0, 1),
                 None if bias is None else bias.float())
    return y.permute(0, 2, 1, 3).contiguous().to(x.dtype)


def conv_reflect_simt_cuda(x: torch.Tensor, w: torch.Tensor,
                           bias: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
    """Launch K9's CUDA-core design on CUDA tensors, f32 or bf16, counted
    under ``conv_same_simt``."""
    _check(x, w, bias)
    kernels.check_cuda("conv_reflect", x, w, bias)
    return cuda_conv._launch_conv(
        f"conv_reflect_simt_{kernels.dtype_suffix(x)}", "conv_same_simt", x,
        w, bias)


def conv_reflect_cuda(x: torch.Tensor, w: torch.Tensor,
                      bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Launch K9 on CUDA tensors: the tensor-core design where
    ``cuda_conv.conv_tc_domain`` holds, else the CUDA-core one."""
    _check(x, w, bias)
    kernels.check_cuda("conv_reflect", x, w, bias)
    if cuda_conv.conv_tc_domain(x):
        out = cuda_conv._launch_conv("conv_reflect_bf16", "conv_reflect", x,
                                     w, bias, pack=True)
    else:
        out = conv_reflect_simt_cuda(x, w, bias)
        kernels.launches["conv_reflect"] += 1
    return out


def _conv_reflect(x, w, bias=None):
    """K9 or its plain version, by the tensor's device; not
    differentiable."""
    return kernels.dispatch("conv_reflect", conv_reflect_cuda,
                            conv_reflect_plain, x, w, bias)


def _check_dw(x, g, k):
    cuda_conv._check_dw(x, g, k, k // 2)
    _check_pad(k, int(x.shape[1]), int(x.shape[3]))


def conv_reflect_dw_plain(x: torch.Tensor, g: torch.Tensor,
                          k: int) -> torch.Tensor:
    """dW [K,K,C,Cout] f32: patches of the reflect-padded x against g,
    summed over (B, H, W)."""
    _check_dw(x, g, k)
    return cuda_conv.dw_of_padded(
        reflection_pad2d_nhcw(x.float(), (k // 2, k // 2)), g, k)


def conv_reflect_dw_simt_cuda(x: torch.Tensor, g: torch.Tensor,
                              k: int) -> torch.Tensor:
    """Launch K9-dW's CUDA-core design on CUDA tensors, f32 or bf16,
    counted under ``conv_dw_simt``; returns dW [K,K,C,Cout] in f32."""
    _check_dw(x, g, k)
    kernels.check_cuda("conv_reflect_dw", x, g)
    suffix = "f32" if kernels.dtype_suffix(x) == "f32" else "simt_bf16"
    dw = cuda_conv._launch_dw(
        f"conv_reflect_dw_{suffix}", x, g, k,
        cuda_conv.dw_splits(k, int(x.shape[2]), int(g.shape[2]),
                            int(x.shape[0] * x.shape[1])))
    kernels.launches["conv_dw_simt"] += 1
    kernels.paths["conv_reflect_dw.simt"] += 1
    return dw


def conv_reflect_dw_cuda(x: torch.Tensor, g: torch.Tensor,
                         k: int) -> torch.Tensor:
    """Launch K9-dW on CUDA tensors: K5's tap-ring design through the
    reflected index map where ``cuda_conv.dw_tma_domain`` holds, else the
    CUDA-core design; returns dW [K,K,C,Cout] in f32."""
    _check_dw(x, g, k)
    kernels.check_cuda("conv_reflect_dw", x, g)
    if cuda_conv.dw_tma_domain(x, g, k, k // 2, reflect=True):
        dw = cuda_conv._tma_dw("conv_reflect_dw_bf16", x, g, k, k // 2)
    else:
        dw = conv_reflect_dw_simt_cuda(x, g, k)
    kernels.launches["conv_reflect_dw"] += 1
    return dw


def conv_reflect_dw(x: torch.Tensor, g: torch.Tensor, k: int) -> torch.Tensor:
    """K9-dW or its plain version, by the tensor's device."""
    return kernels.dispatch("conv_reflect_dw", conv_reflect_dw_cuda,
                            conv_reflect_dw_plain, x, g, k)


def _fold_shape(dxp, p):
    if dxp.dim() != 4:
        raise ValueError(f"reflect_fold takes dxp [B,H+2p,C,W+2p], got "
                         f"{tuple(dxp.shape)}")
    h, w = dxp.shape[1] - 2 * p, dxp.shape[3] - 2 * p
    if not (0 <= p < h and p < w):
        raise ValueError(f"reflect_fold: pad {p} does not fit "
                         f"{tuple(dxp.shape)}")
    return h, w


def reflect_fold_plain(dxp: torch.Tensor, p: int) -> torch.Tensor:
    """The adjoint of reflect padding by p, in f32 in the kernel's order:
    H first (interior, top halo, bottom halo), then W likewise; one
    rounding to the input dtype."""
    h, w = _fold_shape(dxp, p)
    src = dxp.float()
    t = src[:, p:p + h].clone()
    t[:, 1:1 + p] += src[:, :p].flip(1)
    t[:, h - 1 - p:h - 1] += src[:, p + h:].flip(1)
    out = t[..., p:p + w].clone()
    out[..., 1:1 + p] += t[..., :p].flip(3)
    out[..., w - 1 - p:w - 1] += t[..., p + w:].flip(3)
    return out.to(dxp.dtype)


FOLD_THREADS = 256
MAX_ROW_BLOCKS = 65535  # gridDim.y limit


def reflect_fold_geometry(b: int, h: int, c: int, w: int, p: int,
                          esize: int, aligned: bool = True) -> dict:
    """K10's launch for dx [b, h, c, w] from dxp [b, h+2p, c, w+2p] of
    ``esize``-byte elements, the rule of ``kernels/csrc/reflect_fold.cu``:
    a thread makes one unit of ``v`` output elements of one channel. The
    vector path (16-byte units) where both pointers are 16-byte
    ``aligned``, w is whole units, p < v (a channel's halo columns then lie
    in its first and last unit) and dxp is whole units (a window's second
    unit stays inside it); else one element a unit. ``units`` per output
    row; ``grid`` is (unit blocks, row blocks)."""
    v = 16 // esize
    n = b * (h + 2 * p) * c * (w + 2 * p)
    vec = aligned and w % v == 0 and p < v and n % v == 0
    if not vec:
        v = 1
    units = c * (w // v)
    return {"vec": vec, "v": v, "units": units,
            "grid": (-(-units // FOLD_THREADS), min(b * h, MAX_ROW_BLOCKS))}


def reflect_fold_cuda(dxp: torch.Tensor, p: int) -> torch.Tensor:
    """Launch K10 on a CUDA tensor, on the path ``reflect_fold_geometry``
    chooses from its sizes and pointers."""
    h, w = _fold_shape(dxp, p)
    kernels.check_cuda("reflect_fold", dxp)
    B, C = int(dxp.shape[0]), int(dxp.shape[2])
    dx = torch.empty((B, h, C, w), dtype=dxp.dtype, device=dxp.device)
    aligned = dxp.data_ptr() % 16 == 0 and dx.data_ptr() % 16 == 0
    geo = reflect_fold_geometry(B, h, C, w, p, dxp.element_size(), aligned)
    fn = kernels.function("reflect_fold",
                          f"reflect_fold_{kernels.dtype_suffix(dxp)}",
                          [P, P, I, I, I, I, I, I, P])
    err = fn(kernels.ptr(dxp), kernels.ptr(dx), B, h, C, w, p,
             int(geo["vec"]), kernels.stream())
    kernels.check("reflect_fold", err)
    kernels.launches["reflect_fold"] += 1
    kernels.paths["reflect_fold." + ("vector" if geo["vec"] else "element")] += 1
    return dx


def reflect_fold(dxp: torch.Tensor, p: int) -> torch.Tensor:
    """K10 or its plain version, by the tensor's device."""
    return kernels.dispatch("reflect_fold", reflect_fold_cuda,
                            reflect_fold_plain, dxp, p)


def padded_dx(g: torch.Tensor, w_t: torch.Tensor, p: int) -> torch.Tensor:
    """dXp [B, H+2p, Cin, W+2p], the full correlation of dY [B, H, Cout, W]
    with the flipped, ci<->co-swapped weights w_t: K1 (or its plain
    version on the CPU) at pad p and grow p, which pads dY with zeros
    itself."""
    return cuda_conv._conv_same(g, w_t, pad=p, grow=p)


class ConvReflect(torch.autograd.Function):
    """y = conv_reflect(x, w, bias); forward K9, dX by K1 (dXp) then K10,
    dW by K9-dW, each only where its input needs a gradient. dW comes back
    in the weights' dtype, as the Pallas VJP returns it."""

    @staticmethod
    def forward(ctx, x, w, bias):
        ctx.save_for_backward(x, w)
        ctx.bias_dtype = None if bias is None else bias.dtype
        return _conv_reflect(x, w, bias)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g = g.contiguous()
        k = int(w.shape[0])
        p = k // 2
        dx = dw = db = None
        if ctx.needs_input_grad[0]:
            w_t = w.flip(0, 1).transpose(2, 3).contiguous()
            dx = reflect_fold(padded_dx(g, w_t, p), p)
        if ctx.needs_input_grad[1]:
            dw = conv_reflect_dw(x, g, k).to(w.dtype)
        if ctx.needs_input_grad[2]:
            db = g.float().sum(dim=(0, 1, 3)).to(ctx.bias_dtype)
        return dx, dw, db


def conv_reflect(x: torch.Tensor, w: torch.Tensor,
                 bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x [B,H,C,W] NHCW, w [K,K,C,Cout] HWIO, odd K -> [B,H,Cout,W];
    differentiable in x, w and bias."""
    return ConvReflect.apply(x.contiguous(), w.contiguous(), bias)
