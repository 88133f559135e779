"""Convolution with HWIO weights on activations in the current layout
(cyclegan_tpu/ops/conv.py ``conv2d``, ``conv2d_reflect``,
``conv2d_transpose``).

In NHWC every conv is the library convolution (cuDNN on the card, ATen on
the CPU) on the channels_last NCHW view of the activation, as the JAX
package runs that layout in XLA. In NHCW, where the JAX package runs a
Pallas kernel, the port runs a hand-written one, chosen by the tensor's
device and nothing else:

- stride-1 TF-'SAME' ``conv2d``: K1 forward and input gradient, K5 weight
  gradient (``ops/cuda_conv.py``);
- ``conv2d_reflect`` (reflect pad K//2 + VALID, odd K): K9, K1 + K10 and
  K9-dW (``ops/cuda_reflect.py``), for every such conv. The JAX package
  sends the ResNet trunk's 128->128 k3 convs to XLA (its gate
  ``profitable_reflect`` wants W % 128 == 0 and cin <= 64, a TPU tiling
  matter); the port has no gate, so K9 takes all of them.

The stride-2 ``conv2d`` (TF 'SAME', asymmetric) and ``conv2d_transpose``
(TF ``Conv2DTranspose(padding='same')``, output H*s) run where the JAX
package runs them: in XLA, outside any Pallas kernel. Their counterpart is
the library convolution (cuDNN on the card, ATen on the CPU), as a plain
matrix product outside a kernel stays ``torch.matmul``; they are not kernels
of the port. Both pad explicitly, since TF's padding is asymmetric where
PyTorch's is not, and run f32 with TF32 off in forward and backward, as the
JAX f32 path runs ``Precision.HIGHEST``.
"""

from __future__ import annotations

import contextlib
import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from cyclegan_tpu_torch.ops import layout
from cyclegan_tpu_torch.ops.cuda_conv import conv_same
from cyclegan_tpu_torch.ops.cuda_reflect import conv_reflect
from cyclegan_tpu_torch.ops.pad import reflection_pad2d


def _same_pad(size: int, kernel: int, stride: int) -> Tuple[int, int]:
    """TF 'SAME' (before, after) padding of one axis: output
    ceil(size / stride), the odd pad after."""
    out = math.ceil(size / stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


@contextlib.contextmanager
def _full_f32(dtype: torch.dtype):
    """cuDNN without TF32 for f32 operands."""
    if dtype != torch.float32:
        yield
        return
    previous = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = previous


class LibraryConv(torch.autograd.Function):
    """``aten.convolution`` on NCHW and its ``convolution_backward``, each
    under ``_full_f32``: autograd's own backward would run under whatever
    TF32 setting holds when it runs. Under ``torch.func.vmap`` (the paired
    step's stacked twin networks) it runs the library's own batching rule
    for a convolution: the stacked members as one grouped convolution, as
    XLA lowers the JAX package's ``vmap``."""

    @staticmethod
    def forward(x, w, bias, stride, padding, transposed, output_padding,
                groups):
        with _full_f32(x.dtype):
            return torch.ops.aten.convolution(
                x, w, bias, [stride] * 2, [padding] * 2, [1, 1], transposed,
                [output_padding] * 2, groups)

    @staticmethod
    def setup_context(ctx, inputs, output):
        x, w, bias, stride, padding, transposed, output_padding, groups = \
            inputs
        ctx.save_for_backward(x, w)
        ctx.conf = ([stride] * 2, [padding] * 2, transposed,
                    [output_padding] * 2, groups)
        ctx.has_bias = bias is not None

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        stride, padding, transposed, output_padding, groups = ctx.conf
        out_c = w.shape[1] * groups if transposed else w.shape[0]
        mask = [ctx.needs_input_grad[0], ctx.needs_input_grad[1],
                ctx.has_bias and ctx.needs_input_grad[2]]
        with _full_f32(x.dtype):
            dx, dw, db = torch.ops.aten.convolution_backward(
                g, x, w, [out_c], stride, padding, [1, 1], transposed,
                output_padding, groups, mask)
        return dx, dw, db, None, None, None, None, None

    @staticmethod
    def vmap(info, in_dims, x, w, bias, stride, padding, transposed,
             output_padding, groups):
        """G stacked members: x [G, B, C, H, W] becomes [B, G*C, H, W]
        channels_last, w [G, ...] the G*groups groups of one weight, and
        the output [B, G*O, H', W'] is viewed back as [G, B, O, H', W'].
        Where only x is stacked, the members fold into the batch."""
        n = info.batch_size
        x_dim, w_dim, b_dim = in_dims[:3]

        def stacked(t, dim):
            return t.movedim(dim, 0) if dim is not None else t.expand(
                n, *t.shape)

        args = (stride, padding, transposed, output_padding)
        if w_dim is None and b_dim is None:
            x = x.movedim(x_dim, 0)
            y = LibraryConv.apply(x.reshape(-1, *x.shape[2:]), w, bias,
                                  *args, groups)
            return y.view(n, -1, *y.shape[1:]), 0
        x, w = stacked(x, x_dim), stacked(w, w_dim)
        g, b, c, h, wd = x.shape
        xg = x.permute(1, 3, 4, 0, 2).reshape(b, h, wd, g * c).permute(
            0, 3, 1, 2)
        wg = w.reshape(g * w.shape[1], *w.shape[2:])
        bg = None if bias is None else stacked(bias, b_dim).reshape(-1)
        y = LibraryConv.apply(xg, wg, bg, *args, groups * g)
        _, go, ho, wo = y.shape
        y = y.permute(0, 2, 3, 1).reshape(b, ho, wo, g, go // g)
        return y.permute(3, 0, 4, 1, 2), 0


def _nchw(x: torch.Tensor) -> torch.Tensor:
    """The NCHW view of an activation in the current layout (no copy): in
    NHWC it is the channels_last view, which cuDNN convolves as it is."""
    return x.permute(0, 2, 1, 3) if layout.is_nhcw() else x.permute(0, 3, 1, 2)


def _from_nchw(y: torch.Tensor) -> torch.Tensor:
    """A conv output viewed NCHW back in the current layout, contiguous; in
    NHWC that copies nothing where the library kept channels_last."""
    if layout.is_nhcw():
        return y.permute(0, 2, 1, 3).contiguous()
    return y.permute(0, 2, 3, 1).contiguous()


def _library_conv(x: torch.Tensor, kernel: torch.Tensor,
                  bias: Optional[torch.Tensor], stride: int) -> torch.Tensor:
    """TF-'SAME' conv as the library's, on the explicitly padded input: in
    NHWC the pad is on dims 1-2, so the NCHW view stays channels_last."""
    k = int(kernel.shape[0])
    h_axis, w_axis = layout.spatial_axes()
    ph = _same_pad(int(x.shape[h_axis]), k, stride)
    pw = _same_pad(int(x.shape[w_axis]), k, stride)
    if layout.is_nhcw():
        xp = F.pad(_nchw(x), (*pw, *ph))
    else:
        xp = _nchw(F.pad(x, (0, 0, *pw, *ph)))
    y = LibraryConv.apply(xp, kernel.permute(3, 2, 0, 1), bias, stride, 0,
                          False, 0, 1)
    return _from_nchw(y)


def conv2d(x: torch.Tensor, kernel: torch.Tensor,
           bias: Optional[torch.Tensor] = None, stride: int = 1,
           padding: str = "SAME") -> torch.Tensor:
    """x in the current layout, kernel [K,K,C,Cout] HWIO -> ceil(H/s) x
    ceil(W/s) x Cout, TF 'SAME'. In NHCW stride 1 is K1; anything else is
    the library convolution on the explicitly padded input."""
    if padding != "SAME":
        raise NotImplementedError(
            f"conv2d(padding={padding!r}): only 'SAME' is ported; the "
            f"reflect-padded VALID conv is conv2d_reflect")
    if stride == 1 and layout.is_nhcw():
        return conv_same(x, kernel, bias)
    return _library_conv(x, kernel, bias, stride)


def conv2d_reflect(x: torch.Tensor, kernel: torch.Tensor,
                   bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Reflect-pad(K//2) + VALID convolution, odd K: output H, W == input
    H, W (the reference's ReflectionPadding2D + Conv2D(padding='valid')).
    In NHCW it is K9; in NHWC ``reflection_pad2d`` and the library
    convolution, as the JAX package's XLA path composes them."""
    if layout.is_nhcw():
        return conv_reflect(x, kernel, bias)
    p = int(kernel.shape[0]) // 2
    y = LibraryConv.apply(_nchw(reflection_pad2d(x, (p, p))),
                          kernel.permute(3, 2, 0, 1), bias, 1, 0, False, 0,
                          1)
    return _from_nchw(y)


def conv2d_transpose(x: torch.Tensor, kernel: torch.Tensor,
                     bias: Optional[torch.Tensor] = None,
                     stride: int = 2) -> torch.Tensor:
    """TF ``Conv2DTranspose(padding='same')``: x in the current layout,
    kernel stored TF-style HWOI [K,K,Cout,C] -> H*s x W*s x Cout.

    JAX computes it as the stride-dilated input convolved with the flipped
    kernel under padding (K-1-pb, s-1+pb), pb the TF 'SAME' pad before of a
    stride-s conv. ``conv_transpose2d`` with padding pb pads K-1-pb on both
    sides, plus ``output_padding`` after: s-K+2pb, which is -1 for k3 at
    stride 2. There the output is computed one row and column longer and the
    last ones are dropped."""
    k = int(kernel.shape[0])
    before = max(k - stride, 0) // 2
    extra = stride - k + 2 * before
    y = LibraryConv.apply(_nchw(x), kernel.permute(3, 2, 0, 1), bias, stride,
                          before, True, max(extra, 0), 1)
    if extra < 0:
        y = y[:, :, :y.shape[2] + extra, :y.shape[3] + extra]
    return _from_nchw(y)
