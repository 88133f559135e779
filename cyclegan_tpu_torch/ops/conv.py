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

Under an H-sharded scope (``ops/spatialctx.py``, JAX ``conv.py:99-125,
207-220, 240-320``) each conv takes the rows it needs from the
neighbouring strips first. A stride-1 SAME conv in NHCW runs K1 unchanged
on the halo-extended strip and keeps the interior rows (its own zero
padding touches only the rows it drops); K1 takes the odd heights an even
kernel's halo gives, so no zero row is added for parity as the Pallas
kernel's row pairs needed. Autograd through the slice gives K1's dX and
K5's dW on the extended strip, and the exchange's backward returns the
halo rows' gradients to their strips. The stride-2 conv is the library
convolution, VALID in H on the extended strip; the reflect conv is the
reflect halo plus a VALID library conv (K9, K9-dW and K10 do not run
under a spatial scope, as the JAX package's Pallas reflect conv does not);
the transposed conv takes the halo widths JAX's dilated-coordinate
algebra gives (``spatial_transpose_supported``).
"""

from __future__ import annotations

import contextlib
import math
import threading
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from cyclegan_tpu_torch.ops import layout, spatialctx
from cyclegan_tpu_torch.ops.cuda_conv import conv_same
from cyclegan_tpu_torch.ops.cuda_reflect import conv_reflect
from cyclegan_tpu_torch.ops.pad import reflection_pad2d


def _pair(v) -> list:
    return list(v) if isinstance(v, (tuple, list)) else [v] * 2


def _same_pad(size: int, kernel: int, stride: int) -> Tuple[int, int]:
    """TF 'SAME' (before, after) padding of one axis: output
    ceil(size / stride), the odd pad after."""
    out = math.ceil(size / stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


class _F32Calls:
    """The f32 library calls in flight, over every thread: cuDNN's TF32
    switch is one flag for the process."""
    lock = threading.Lock()
    count = 0
    saved = True


@contextlib.contextmanager
def _full_f32(dtype: torch.dtype):
    """cuDNN without TF32 for f32 operands. The first f32 call in flight
    turns TF32 off and the last one to leave restores the setting it found,
    so a thread leaving its call never turns TF32 on under another
    thread's f32 call (bf16 calls do not depend on the flag)."""
    if dtype != torch.float32:
        yield
        return
    with _F32Calls.lock:
        if _F32Calls.count == 0:
            _F32Calls.saved = torch.backends.cudnn.allow_tf32
            torch.backends.cudnn.allow_tf32 = False
        _F32Calls.count += 1
    try:
        yield
    finally:
        with _F32Calls.lock:
            _F32Calls.count -= 1
            if _F32Calls.count == 0:
                torch.backends.cudnn.allow_tf32 = _F32Calls.saved


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
                x, w, bias, [stride] * 2, _pair(padding), [1, 1], transposed,
                _pair(output_padding), groups)

    @staticmethod
    def setup_context(ctx, inputs, output):
        x, w, bias, stride, padding, transposed, output_padding, groups = \
            inputs
        ctx.save_for_backward(x, w)
        ctx.conf = ([stride] * 2, _pair(padding), transposed,
                    _pair(output_padding), groups)
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
                  bias: Optional[torch.Tensor], stride: int,
                  same: bool = True, valid_h: bool = False) -> torch.Tensor:
    """TF-'SAME' (or, without ``same``, 'VALID') conv as the library's, on
    the explicitly padded input (with ``valid_h``, not padded in H: a
    halo-extended strip); in NHWC the pad is on dims 1-2, so the NCHW view
    stays channels_last."""
    k = int(kernel.shape[0])
    h_axis, w_axis = layout.spatial_axes()
    ph = (_same_pad(int(x.shape[h_axis]), k, stride)
          if same and not valid_h else (0, 0))
    pw = _same_pad(int(x.shape[w_axis]), k, stride) if same else (0, 0)
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
    ceil(W/s) x Cout with TF 'SAME' padding, or floor((H-K)/s)+1 ... with
    'VALID'. In NHCW a stride-1 SAME conv is K1; anything else is the
    library convolution on the explicitly padded input."""
    if padding not in ("SAME", "VALID"):
        raise ValueError(f"conv2d(padding={padding!r}): 'SAME' or 'VALID'")
    if padding == "SAME" and spatialctx.is_active():
        return _spatial_conv(x, kernel, bias, stride)
    if padding == "SAME" and stride == 1 and layout.is_nhcw():
        return conv_same(x, kernel, bias)
    return _library_conv(x, kernel, bias, stride, padding == "SAME")


def _tf_same_pad(kernel: int, stride: int) -> Tuple[int, int]:
    """TF 'SAME' (before, after) for an input divisible by the stride."""
    total = max(kernel - stride, 0)
    return total // 2, total - total // 2


def _spatial_conv(x, kernel, bias, stride):
    """A TF-'SAME' conv of this rank's strip: the halo rows exchanged,
    then K1 on the extended strip keeping its interior (stride 1, NHCW) or
    the library conv, VALID in H."""
    pa, pb = _tf_same_pad(int(kernel.shape[0]), stride)
    x_ext = spatialctx.halo_exchange_h(x, pa, pb)
    if stride == 1 and layout.is_nhcw():
        y = conv_same(x_ext, kernel, bias)
        return y[:, pa:pa + x.shape[1]].contiguous()
    return _library_conv(x_ext, kernel, bias, stride, valid_h=True)


def conv2d_reflect(x: torch.Tensor, kernel: torch.Tensor,
                   bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Reflect-pad(K//2) + VALID convolution, odd K: output H, W == input
    H, W (the reference's ReflectionPadding2D + Conv2D(padding='valid')).
    In NHCW it is K9; in NHWC ``reflection_pad2d`` and the library
    convolution, as the JAX package's XLA path composes them. Under a
    spatial scope, the reflect halo and a VALID library conv in either
    layout."""
    p = int(kernel.shape[0]) // 2
    if spatialctx.is_active():
        x_ext = spatialctx.halo_exchange_h_reflect(x, p)
        return _library_conv(reflection_pad2d(x_ext, (p, 0)), kernel, bias,
                             1, same=False)
    if layout.is_nhcw():
        return conv_reflect(x, kernel, bias)
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
    last ones are dropped.

    Under a spatial scope the strip takes a rows from above and b from
    below (JAX's algebra: a = (K-1-pb)/s, b the real rows the last outputs
    reach past the strip) and the dilated conv runs with no padding before
    in H and hi after: ``conv_transpose2d`` at H padding K-1 and output
    padding hi, which is 0 or 1 for the kernels that
    ``spatial_transpose_supported`` passes."""
    k = int(kernel.shape[0])
    before = max(k - stride, 0) // 2
    extra = stride - k + 2 * before
    pad, out_pad = before, max(extra, 0)
    if spatialctx.is_active():
        if not spatial_transpose_supported(k, stride):
            raise NotImplementedError(
                f"spatial conv_transpose needs pad_before' % stride == 0 "
                f"(got kernel {k}, stride {stride})")
        top = k - 1 - before
        a = top // stride
        b = max(0, (k - 2 - top) // stride + 1)
        hi = k + stride - 2 - stride * (a + b)
        x = spatialctx.halo_exchange_h(x, a, b)
        pad, out_pad = (k - 1, before), (hi, max(extra, 0))
    y = LibraryConv.apply(_nchw(x), kernel.permute(3, 2, 0, 1), bias, stride,
                          pad, True, out_pad, 1)
    if extra < 0:  # not in H under a spatial scope: hi gave it exactly
        rows = y.shape[2] + (0 if spatialctx.is_active() else extra)
        y = y[:, :, :rows, :y.shape[3] + extra]
    return _from_nchw(y)


def spatial_transpose_supported(kernel: int, stride: int = 2) -> bool:
    """Whether ``conv2d_transpose`` runs under a spatial scope for this
    (kernel, stride): the halo algebra needs pad_before' % stride == 0,
    pad_before' = K - 1 - pb, so that the rows borrowed from the
    neighbouring strip land on real, not dilation-zero, positions. At
    stride 2 it passes k3, k4, k7 and k8 and refuses k5 and k6. Checked
    at config load (``models.spatial_unsupported_transposes``)."""
    pad_before = _tf_same_pad(kernel, stride)[0]
    return (kernel - 1 - pad_before) % stride == 0
