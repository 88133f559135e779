"""Stride-1 TF-'SAME' convolution on NHCW activations and its gradients:
kernels K1 (forward and input gradient) and K5 (weight gradient), their
plain versions, and the autograd Function that joins them.

Replaces cyclegan_tpu/ops/pallas_conv.py ``conv2d_same_nhcw`` (its
``_conv_fwd_call`` and custom VJP, whose dW is ``_conv_dw_call``) and
``conv1x1_nhcw`` (``_conv1x1_call``, its dW ``_conv1x1_dw_call``):

- K1, ``kernels/csrc/conv_same.cu``, takes every K, K = 1 included, an
  optional bias added to the f32 sum, the zero padding before the image
  as an argument (the forward pads (K-1)/2 before, the input gradient, K1
  on dY with flipped, ci<->co-swapped weights, K-1-(K-1)/2, which is 2 for
  k4), and ``grow``: the output widened by that many rows and columns on
  each side, so that the reflect conv's input gradient needs no
  zero-padded copy of dY.
- K5, ``kernels/csrc/conv_dw.cu``, sums patches(x)^T . dY over B*H*W in f32
  for every K: a split reduction whose splits are added in a fixed order.

Bound on the H100: operations (16-100 multiply-adds per byte moved at the
generator's shapes). Both run on the tensor cores in bf16
(``conv_tc_domain`` states the rule for K1): K1 packs x into a padded
channel-grouped copy and the weights K-major (``conv_tc_pack_plain`` is the
plain version of that pack; ``conv_tc_geometry`` the tiling) and then runs
wgmma on flattened-pixel M tiles, each tap the same shared-memory window
read at another offset; K5 takes TMA tiles of x's K column-shifted copies
(written by a copy kernel first; ``shifted_copies`` is their plain version)
and of dY into wgmma (``conv_dw_tma_kernel``) wherever the tensors lie in
its domain (``dw_tma_domain``: 16-byte aligned, W a multiple of 8, which
every launch of the recipes at 256x256 meets). f32, and K5's bf16 outside
its domain, run the CUDA-core designs (``conv_same_simt_cuda``,
``conv_dw_simt_cuda``), counted under ``conv_same_simt`` and
``conv_dw_simt`` besides ``conv_same`` and ``conv_dw``. See the sources.

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
from cyclegan_tpu_torch.kernels import I, L, P

# K5's CUDA-core block tile (conv_dw.cu MT, NT) and the blocks it aims to
# keep in flight
_DW_TILE_M, _DW_TILE_N, _DW_BLOCKS = 64, 32, 8 * 132
# K5's TMA design (conv_dw.cu): pixels per stage, rows of an M tile, M tiles
# per block; the blocks it aims at (eight per SM) and the fewest stages of 64
# pixels a block should sum (picked in a sweep on an H100)
TMA_PX, TMA_TILE_ROWS, TMA_CONSUMERS = 64, 64, 2
_TMA_BLOCKS, _TMA_MIN_STAGES = 8 * 132, 32


# K1's tensor-core design (conv_same.cu): consumer warpgroups per block, the
# most stages, the shared memory a block may use, and the wgmma widths N
# that Cout (or Cout / nt past 256) rounds up to
TC_CONSUMERS, TC_MAX_STAGES, TC_SMEM_MAX = 2, 3, 232448
TC_NS = (8, 16, 32, 48, 64, 80, 96, 128, 160, 192, 256)


def tf_same_pad(k: int):
    """TF 'SAME' (before, after) padding at stride 1: (1, 2) for k4."""
    before = (k - 1) // 2
    return before, k - 1 - before


def _check_shapes(x, w, bias, pad, grow=0):
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
    if grow < 0:
        raise ValueError(f"grow {grow} is negative")


def _pad_before(w, pad):
    return tf_same_pad(int(w.shape[0]))[0] if pad is None else int(pad)


def conv_same_plain(x: torch.Tensor, w: torch.Tensor,
                    bias: Optional[torch.Tensor] = None,
                    pad: Optional[int] = None, grow: int = 0) -> torch.Tensor:
    """The kernel's function in PyTorch ops: explicit zero pad (``pad``
    before, the rest after; TF SAME if None; ``grow`` more on each side),
    then a VALID conv in f32, then one rounding to the input dtype."""
    _check_shapes(x, w, bias, pad, grow)
    k = int(w.shape[0])
    before = _pad_before(w, pad) + grow
    after = k - 1 - _pad_before(w, pad) + grow
    xf = x.float().permute(0, 2, 1, 3)                    # NCHW view
    xf = F.pad(xf, (before, after, before, after))
    wf = w.float().permute(3, 2, 0, 1)                    # OIHW
    y = F.conv2d(xf, wf, None if bias is None else bias.float())
    return y.permute(0, 2, 1, 3).contiguous().to(x.dtype)


def conv_tc_domain(x: torch.Tensor) -> bool:
    """Whether K1 and K9 run their tensor-core design on x: bf16 does (a
    shape it cannot take raises), f32 keeps the CUDA-core design, whose f32
    products the f32 gradient checks need (JAX's Precision.HIGHEST)."""
    return x.dtype == torch.bfloat16


def conv_tc_geometry(b: int, h: int, c: int, w: int, cout: int, k: int,
                     grow: int = 0) -> dict:
    """How K1's and K9's tensor-core design (conv_same.cu ``tc_geometry``,
    the same rule) tiles a launch on x [b, h, c, w]: padded sides hp, wp of
    the output [h + 2 grow, w + 2 grow] plus K - 1; cg channel groups of 8
    (C rounded up to 16) and c16 = cg / 2 steps of 16 channels; nt N tiles
    of n columns (Cout split evenly past 256, rounded up to a width in
    ``TC_NS``); mw m64 tiles per consumer warpgroup and a block's M tile bm
    = 2 mw 64 flattened pixels; ``rows`` tap rows (dy) per stage in
    ``groups`` = K / rows runs, the largest divisor of K with which two
    stages fit ``TC_SMEM_MAX`` (a ring of one stage would wait on itself),
    and steps = c16 groups; the window nw = bm + (rows - 1) wp + K - 1
    pixels, the span of a run's tap offsets dy wp + dx; one stage's bytes
    (two channel groups' windows, then the run's rows K taps' weights);
    stages; the block's shared memory; ptot = b hp wp pixels; blocks along
    M; the workspace bytes of xp and wp."""
    ho, wo = h + 2 * grow, w + 2 * grow
    hp, wp = ho + k - 1, wo + k - 1
    cg = 2 * -(-c // 16)
    c16 = cg // 2
    nt = -(-cout // TC_NS[-1])
    n = next(v for v in TC_NS if -(-cout // nt) <= v)
    mw = 2 if n <= 128 else 1
    bm = TC_CONSUMERS * mw * 64
    room = TC_SMEM_MAX - 2 * TC_MAX_STAGES * 8
    for rows in (r for r in range(k, 0, -1) if k % r == 0):
        groups = k // rows
        steps = c16 * groups
        nw = bm + (rows - 1) * wp + k - 1
        stage = 2 * nw * 16 + rows * k * 2 * n * 16
        if room // stage >= min(steps, 2):
            break
    else:
        raise ValueError(f"conv_same: no tensor-core tiling for K {k}, "
                         f"N {n}")
    stages = min(steps, TC_MAX_STAGES, room // stage)
    ptot = b * hp * wp
    return {"ho": ho, "wo": wo, "hp": hp, "wp": wp, "cg": cg, "c16": c16,
            "n": n, "nt": nt, "mw": mw, "bm": bm, "rows": rows,
            "groups": groups, "steps": steps, "nw": nw,
            "stage_bytes": stage, "stages": stages,
            "smem": stages * stage + 2 * stages * 8, "ptot": ptot,
            "blocks": -(-ptot // bm),
            "workspace": 16 * (cg * ptot + nt * c16 * k * k * 2 * n)}


def conv_tc_pack_plain(x: torch.Tensor, w: torch.Tensor, pad: int,
                       grow: int = 0, reflect: bool = False):
    """The plain version of the pack kernel of K1's and K9's tensor-core
    design: (xp [cg, B, hp, wp, 8], wp [nt, c16, K*K, 2, n, 8]). xp is x
    padded by pad + grow before and K-1-pad + grow after with zeros (with
    ``reflect``, by K//2 on each side through the reflect map), channels
    grouped 8 innermost and zero past C; wp is the HWIO weights with the 8
    channels of group 2 step + half innermost and output channel tile j n
    + [0, n) in tile j, zero past C and Cout."""
    B, H, C, W = x.shape
    k, cout = int(w.shape[0]), int(w.shape[3])
    geo = conv_tc_geometry(B, H, C, W, cout, k, grow)
    cg, n, nt = geo["cg"], geo["n"], geo["nt"]
    xc = F.pad(x, (0, 0, 0, cg * 8 - C))                  # [B, H, 8cg, W]
    if reflect:
        p = k // 2
        xq = F.pad(xc.permute(0, 2, 1, 3), (p,) * 4, mode="reflect")
    else:
        before, after = pad + grow, k - 1 - pad + grow
        xq = F.pad(xc.permute(0, 2, 1, 3), (before, after, before, after))
    xp = xq.reshape(B, cg, 8, geo["hp"], geo["wp"]).permute(1, 0, 3, 4, 2)
    wq = F.pad(w.reshape(k * k, C, cout), (0, nt * n - cout, 0, cg * 8 - C))
    wq = wq.reshape(k * k, cg // 2, 2, 8, nt, n).permute(4, 1, 0, 2, 5, 3)
    return xp.contiguous(), wq.contiguous()


def _launch_conv(lib_fn, counter, x, w, bias, pad=None, grow=0,
                 pack=False):
    """One launch of ``lib_fn`` of library ``conv_same`` (arguments x, w,
    bias, out, [workspace, its bytes,] B, H, C, W, Cout, K, [pad, grow,]
    stream; K9's entries take no pad) into a new output [B, H + 2 grow,
    Cout, W + 2 grow], counted under ``counter``. With ``pack``, the
    workspace the tensor-core design packs x and w into (xp [cg, ptot, 8]
    then wp [nt, c16, K*K, 2, n, 8] bf16), sized by ``conv_tc_geometry``;
    the kernel refuses a workspace smaller than its own geometry needs."""
    B, H, C, W = x.shape
    K, Cout = int(w.shape[0]), int(w.shape[3])
    out = torch.empty((B, H + 2 * grow, Cout, W + 2 * grow), dtype=x.dtype,
                      device=x.device)
    head = [kernels.ptr(x), kernels.ptr(w), kernels.ptr(bias),
            kernels.ptr(out)]
    types = [P] * 4
    if pack:
        nbytes = conv_tc_geometry(B, H, C, W, Cout, K, grow)["workspace"]
        ws = torch.empty(nbytes // 2, dtype=x.dtype, device=x.device)
        head += [kernels.ptr(ws), nbytes]
        types += [P, L]
    args = () if pad is None else (pad, grow)
    fn = kernels.function("conv_same", lib_fn,
                          types + [I] * (6 + len(args)) + [P])
    err = fn(*head, B, H, C, W, Cout, K, *args, kernels.stream())
    kernels.check("conv_same", err)
    kernels.launches[counter] += 1
    return out


def conv_same_simt_cuda(x: torch.Tensor, w: torch.Tensor,
                        bias: Optional[torch.Tensor] = None,
                        pad: Optional[int] = None,
                        grow: int = 0) -> torch.Tensor:
    """Launch K1's CUDA-core design on CUDA tensors, f32 or bf16, counted
    under ``conv_same_simt``."""
    _check_shapes(x, w, bias, pad, grow)
    kernels.check_cuda("conv_same", x, w, bias)
    return _launch_conv(f"conv_same_simt_{kernels.dtype_suffix(x)}",
                        "conv_same_simt", x, w, bias, _pad_before(w, pad),
                        grow)


def conv_same_cuda(x: torch.Tensor, w: torch.Tensor,
                   bias: Optional[torch.Tensor] = None,
                   pad: Optional[int] = None, grow: int = 0) -> torch.Tensor:
    """Launch K1 on CUDA tensors: the tensor-core design where
    ``conv_tc_domain`` holds, else the CUDA-core one."""
    _check_shapes(x, w, bias, pad, grow)
    kernels.check_cuda("conv_same", x, w, bias)
    if conv_tc_domain(x):
        out = _launch_conv("conv_same_bf16", "conv_same", x, w, bias,
                           _pad_before(w, pad), grow, pack=True)
    else:
        out = conv_same_simt_cuda(x, w, bias, pad, grow)
        kernels.launches["conv_same"] += 1
    return out


def _conv_same(x, w, bias=None, pad=None, grow=0):
    """K1 or its plain version, by the tensor's device; not differentiable."""
    if x.is_cuda:
        return conv_same_cuda(x, w, bias, pad=pad, grow=grow)
    if x.device.type == "cpu":
        return conv_same_plain(x, w, bias, pad=pad, grow=grow)
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


def dw_tma_geometry(c: int, k: int):
    """How K5's TMA design cuts the K*K*C (tap, channel) rows into 64-row M
    tiles (conv_dw.cu ``tma_geometry``): (cb, taps, c_tiles, m_tiles) with
    cb channel rows per tap (the smallest of 8, 16, 32, 64 at least C; 64
    beyond), taps = 64 / cb taps per tile, c_tiles channel tiles per tap
    group. Tile t holds taps (t // c_tiles) * taps + j for j < taps (those
    below K*K) and channels (t % c_tiles) * cb + [0, cb); rows at channels
    past C are zeros."""
    cb = next((n for n in (8, 16, 32) if c <= n), 64)
    taps = TMA_TILE_ROWS // cb
    c_tiles = -(-c // cb)
    return cb, taps, c_tiles, c_tiles * -(-(k * k) // taps)


def dw_tma_n(cout: int) -> int:
    """The wgmma N of K5's TMA design: Cout rounded up to 8, 16, 32, 64, or
    128 (tiles of 128 beyond)."""
    return next((n for n in (8, 16, 32, 64) if cout <= n), 128)


def dw_tma_splits(k: int, c: int, cout: int, rows: int, w: int) -> int:
    """How many slices of the B*H rows (each W wide) K5's TMA design splits
    its sum into: up to eight blocks per SM, as long as each block sums at
    least 32 stages of 64 pixels (more splits cost more workspace to add);
    never more slices than rows."""
    blocks = (-(-dw_tma_geometry(c, k)[3] // TMA_CONSUMERS)
              * -(-cout // dw_tma_n(cout)))
    stages = rows * -(-w // TMA_PX)
    return max(1, min(rows, math.ceil(_TMA_BLOCKS / blocks),
                      stages // _TMA_MIN_STAGES))


def dw_tma_domain(x: torch.Tensor, g: torch.Tensor) -> bool:
    """Whether K5's and K9-dW's TMA design takes these operands: bf16, both
    base addresses 16-byte aligned and W a multiple of 8 (a TMA row stride
    is a multiple of 16 bytes)."""
    return (x.dtype == torch.bfloat16 and int(x.shape[3]) % 8 == 0
            and x.data_ptr() % 16 == 0 and g.data_ptr() % 16 == 0)


def shifted_copies(x: torch.Tensor, k: int, pad: int,
                   reflect: bool = False) -> torch.Tensor:
    """The plain version of the K column-shifted copies of x [B, H, C, W]
    that K5's and K9-dW's TMA design writes first and then reads (a TMA box
    cannot start at an odd column): xs[dx, b, h, c, w] = x[b, h, c,
    w + dx - pad], zeros past the edges, [K, B, H, C, W]; with ``reflect``,
    x reflect-padded by pad = K // 2 on every side first, [K, B, H + 2 pad,
    C, W]."""
    W = int(x.shape[3])
    if reflect:
        xp = F.pad(x.permute(0, 2, 1, 3), (pad,) * 4, mode="reflect")
        return xp.unfold(3, W, 1).permute(3, 0, 2, 1, 4).contiguous()
    xp = F.pad(x, (pad, k - 1 - pad))
    return xp.unfold(3, W, 1).permute(3, 0, 1, 2, 4).contiguous()


def _launch_dw(fn_name, inputs, g, k, splits, *args):
    """One dW launch of library ``conv_dw``'s ``fn_name`` (signature
    inputs..., g, part, dw, B, H, C, W, Cout, K, args..., splits, stream),
    ``inputs`` x or (x, room for its shifted copies); returns dW
    [K,K,C,Cout] f32."""
    x = inputs[0]
    B, H, C, W = x.shape
    Cout = int(g.shape[2])
    part = torch.empty((splits, k * k * C, Cout), dtype=torch.float32,
                       device=x.device)
    dw = torch.empty((k, k, C, Cout), dtype=torch.float32, device=x.device)
    fn = kernels.function("conv_dw", fn_name,
                          [P] * (len(inputs) + 3) + [I] * (7 + len(args))
                          + [P])
    err = fn(*(kernels.ptr(t) for t in inputs), kernels.ptr(g),
             kernels.ptr(part), kernels.ptr(dw), B, H, C, W, Cout, k, *args,
             splits, kernels.stream())
    kernels.check("conv_dw", err)
    return dw


def _tma_dw(fn_name, x, g, k, pad, reflect, *args):
    """K5's TMA design on x: room for its K shifted copies, which the
    launch writes, then the product."""
    B, H, C, W = x.shape
    xs = torch.empty((k, B, H + (2 * pad if reflect else 0), C, W),
                     dtype=x.dtype, device=x.device)
    return _launch_dw(fn_name, (x, xs), g, k,
                      dw_tma_splits(k, C, int(g.shape[2]), B * H, W), *args)


def conv_dw_simt_cuda(x: torch.Tensor, g: torch.Tensor, k: int,
                      pad: int) -> torch.Tensor:
    """Launch K5's CUDA-core design on CUDA tensors, f32 or bf16, counted
    under ``conv_dw_simt``; returns dW [K,K,C,Cout] in f32."""
    _check_dw(x, g, k, pad)
    kernels.check_cuda("conv_dw", x, g)
    suffix = "f32" if kernels.dtype_suffix(x) == "f32" else "simt_bf16"
    dw = _launch_dw(f"conv_dw_{suffix}", (x,), g, k,
                    dw_splits(k, int(x.shape[2]), int(g.shape[2]),
                              int(x.shape[0] * x.shape[1])), pad)
    kernels.launches["conv_dw_simt"] += 1
    return dw


def conv_dw_cuda(x: torch.Tensor, g: torch.Tensor, k: int,
                 pad: int) -> torch.Tensor:
    """Launch K5 on CUDA tensors: the TMA design (its shifted copies, then
    the product) where ``dw_tma_domain`` holds, else the CUDA-core one;
    returns dW [K,K,C,Cout] in f32."""
    _check_dw(x, g, k, pad)
    kernels.check_cuda("conv_dw", x, g)
    if dw_tma_domain(x, g):
        dw = _tma_dw("conv_dw_bf16", x, g, k, pad, False, pad)
    else:
        dw = conv_dw_simt_cuda(x, g, k, pad)
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
