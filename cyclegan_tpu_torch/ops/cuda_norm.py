"""Instance norm on NHWC activations: kernel K13, its plain version, and
the autograd Function that joins them (cyclegan_tpu/ops/pallas_norm.py).

K13 (``kernels/csrc/instance_norm_nhwc.cu``) replaces the Pallas kernel
``_forward_call``, the layout's opt-in instance norm (``pallas_norm: true``
in a train config). Like it, it computes the statistics in f32 in one sweep,
mean = E[x] and var = max(E[x^2] - mean^2, 0) whatever the input type, and
writes y = (x - mean) * rsqrt(var + eps) [* gamma + beta] in x's type with
mean and rstd (f32 [N, 1, C]) for the backward. Bound on the H100: bytes.
Where a tile of channel vectors fits the shared memory of a thread-block
cluster (every launch of the recipes), one launch reads x once and sums in
a fixed order through the cluster; else two launches read it twice
(``instance_norm_nhwc_geometry``). The backward is torch ops
computing the Pallas VJP (``pallas_norm.py`` ``_instance_norm_bwd``),
which is plain XLA there: no kernel. The JAX package takes the kernel only
where ``profitable(C)`` (a 128-lane padding rule of the TPU); the port has
no gate, so with ``pallas_norm`` every NHWC instance norm runs K13.

``scope(enabled)`` turns the kernel on for one train or validation step
and restores the previous setting after it (the JAX trainer flips a process
flag once and never resets it).
"""

from __future__ import annotations

import contextlib
import functools
from typing import Optional, Tuple

import torch

from cyclegan_tpu_torch import kernels
from cyclegan_tpu_torch.kernels import F as CF
from cyclegan_tpu_torch.kernels import I, P

TFA_EPSILON = 1e-3
# K13's CTA (kernels/csrc/instance_norm_nhwc.cu): threads, the widest
# resident tile in channel vectors, the largest cluster (16, non-portable),
# the bytes of x a CTA's resident copy grows its cluster to and the most it
# may hold; a streamed launch's row splits fill about TARGET_BLOCKS CTAs
THREADS, MAX_TILE, MAX_CLUSTER = 256, 4, 16
TARGET_BYTES, SMEM_MAX = 32 << 10, 160 << 10
TARGET_BLOCKS = 4 * 132  # a few waves over the H100's 132 SMs

_ENABLED = False


def is_enabled() -> bool:
    return _ENABLED


@contextlib.contextmanager
def scope(enabled: bool = True):
    """Route NHWC instance norms through K13 (on a CPU tensor its plain
    version) inside the block."""
    global _ENABLED
    prev = _ENABLED
    _ENABLED = bool(enabled)
    try:
        yield
    finally:
        _ENABLED = prev


def _check(x, gamma, beta):
    if x.dim() != 4:
        raise ValueError(f"instance_norm_nhwc takes x [N,H,W,C], got "
                         f"{tuple(x.shape)}")
    if (gamma is None) != (beta is None):
        raise ValueError("instance_norm_nhwc takes gamma and beta together")
    for p in (gamma, beta):
        if p is not None and tuple(p.shape) != (x.shape[3],):
            raise ValueError(f"per-channel parameter {tuple(p.shape)} for "
                             f"{x.shape[3]} channels")


def instance_norm_nhwc_plain(x: torch.Tensor, gamma: Optional[torch.Tensor],
                             beta: Optional[torch.Tensor],
                             eps: float = TFA_EPSILON
                             ) -> Tuple[torch.Tensor, torch.Tensor,
                                        torch.Tensor]:
    """The kernel's function with explicit f32 sums over the N's HW rows:
    (y [N,H,W,C] in x's type, mean, rstd f32 [N, 1, C])."""
    _check(x, gamma, beta)
    n, h, w, c = x.shape
    x3 = x.reshape(n, h * w, c).float()
    count = float(h * w)
    mean = x3.sum(dim=1, keepdim=True) / count
    var = torch.clamp((x3 * x3).sum(dim=1, keepdim=True) / count
                      - mean * mean, min=0.0)
    rstd = torch.rsqrt(var + eps)
    y = (x3 - mean) * rstd
    if gamma is not None:
        y = y * gamma.float() + beta.float()
    return y.to(x.dtype).reshape(n, h, w, c), mean, rstd


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def instance_norm_nhwc_geometry(n: int, hw: int, c: int, esize: int,
                                aligned: bool = True) -> dict:
    """How K13 cuts a launch on x [n, hw, c] of ``esize``-byte elements;
    ``geometry`` in the kernel's source is the same rule. A slot is
    ``vec`` channels of a row: 16 bytes where c allows and both pointers
    are 16-byte ``aligned``, else one element.

    Resident (16-byte slots; ``splits`` 0): one launch. A tile is ``tile``
    neighbouring channel vectors (a power of two dividing c / vec, at most
    MAX_TILE) of one sample over its hw rows, split by ``rows`` over a
    ``cluster`` of CTAs grown until a CTA holds about TARGET_BYTES of x (at
    most MAX_CLUSTER); a thread takes one vector and every
    (THREADS / tile)-th row of its CTA's, ``slots`` at most, copied into
    ``smem`` bytes of shared memory: the widest tile whose CTAs hold at
    most SMEM_MAX.

    Streamed (one-element slots, or no tile fits): the two-launch design,
    x read twice; ``tile`` channel vectors (at most 32) a block and
    ``splits`` row ranges a sample, filling about TARGET_BLOCKS blocks with
    at least 4 rows a lane. ``path``: resident, streamed (16-byte slots) or
    element; ``blocks``: CTAs of a launch."""
    v16 = 16 // esize
    vec = v16 if aligned and c % v16 == 0 else 1
    cv = c // vec

    def cluster_of(tile):
        cluster = 1
        while (cluster < MAX_CLUSTER and cluster < hw
               and _cdiv(tile * hw * 16, cluster) > TARGET_BYTES):
            cluster *= 2
        return cluster

    def slots(tile, cluster):
        return _cdiv(_cdiv(hw, cluster), THREADS // tile)

    if vec == v16:
        tile = 1
        while 2 * tile <= MAX_TILE and cv % (2 * tile) == 0:
            tile *= 2
        while tile >= 1:
            cluster = cluster_of(tile)
            if slots(tile, cluster) * THREADS * 16 <= SMEM_MAX:
                return {"vec": vec, "tile": tile, "cluster": cluster,
                        "rows": _cdiv(hw, cluster),
                        "slots": slots(tile, cluster), "splits": 0,
                        "smem": slots(tile, cluster) * THREADS * 16,
                        "path": "resident",
                        "blocks": n * (cv // tile) * cluster}
            tile //= 2
    tile = min(cv, 32)
    splits = _cdiv(TARGET_BLOCKS, n * _cdiv(cv, tile))
    splits = max(1, min(splits, hw // (4 * (THREADS // tile)), 65535))
    return {"vec": vec, "tile": tile, "cluster": 1, "rows": _cdiv(hw, splits),
            "slots": 0, "splits": splits, "smem": 0,
            "path": "streamed" if vec == v16 else "element",
            "blocks": n * _cdiv(cv, tile) * splits}


_GEOMETRY_ARGS = ("vec", "tile", "cluster", "slots", "splits")


@functools.lru_cache(maxsize=None)
def _geometry(n, hw, c, esize, aligned):
    return instance_norm_nhwc_geometry(n, hw, c, esize, aligned)


def instance_norm_nhwc_cuda(x: torch.Tensor, gamma: Optional[torch.Tensor],
                            beta: Optional[torch.Tensor],
                            eps: float = TFA_EPSILON):
    """Launch K13 on CUDA tensors, on the path
    ``instance_norm_nhwc_geometry`` chooses from the size and pointers;
    returns (y, mean, rstd) as the plain version does."""
    _check(x, gamma, beta)
    kernels.check_cuda("instance_norm_nhwc", x, gamma, beta)
    n, h, w, c = x.shape
    y = torch.empty_like(x)
    aligned = x.data_ptr() % 16 == 0 and y.data_ptr() % 16 == 0
    geo = _geometry(n, h * w, c, x.element_size(), aligned)
    mean = torch.empty((n, 1, c), dtype=torch.float32, device=x.device)
    rstd = torch.empty_like(mean)
    ws = (torch.empty((2, n, geo["splits"], c), dtype=torch.float32,
                      device=x.device) if geo["splits"] else None)
    fn = kernels.function(
        "instance_norm_nhwc", f"instance_norm_nhwc_{kernels.dtype_suffix(x)}",
        [P] * 8 + [I, I, I, CF] + [I] * 5 + [P])
    err = fn(kernels.ptr(x), kernels.ptr(gamma), kernels.ptr(beta),
             kernels.ptr(y), kernels.ptr(mean), kernels.ptr(rstd),
             None if ws is None else kernels.ptr(ws[0]),
             None if ws is None else kernels.ptr(ws[1]), n, h * w, c,
             float(eps), *(int(geo[k]) for k in _GEOMETRY_ARGS),
             kernels.stream())
    kernels.check("instance_norm_nhwc", err)
    kernels.launches["instance_norm_nhwc"] += 1
    kernels.paths["instance_norm_nhwc." + geo["path"]] += 1
    return y, mean, rstd


def _instance_norm_nhwc(x, gamma, beta, eps):
    """K13 or its plain version, by the tensor's device."""
    if x.is_cuda:
        return instance_norm_nhwc_cuda(x, gamma, beta, eps)
    if x.device.type == "cpu":
        return instance_norm_nhwc_plain(x, gamma, beta, eps)
    raise ValueError(f"instance_norm_nhwc: no kernel for device {x.device}")


def instance_norm_nhwc_bwd(x, dy, gamma, mean, rstd):
    """(dx, dgamma, dbeta) of the Pallas VJP (``pallas_norm.py``
    ``_instance_norm_bwd``): with x_hat = (x - mean) rstd and dyg = dy gamma,
    dx = rstd (dyg - mean(dyg) - x_hat mean(dyg x_hat)) over the HW rows,
    dgamma = sum dy x_hat and dbeta = sum dy over (N, HW); f32 math, dx in
    x's type, dgamma and dbeta in gamma's (None without gamma)."""
    n, h, w, c = x.shape
    xf = x.reshape(n, h * w, c).float()
    dyf = dy.reshape(n, h * w, c).float()
    xhat = (xf - mean) * rstd
    dyg = dyf * gamma.float() if gamma is not None else dyf
    m1 = dyg.mean(dim=1, keepdim=True)
    m2 = (dyg * xhat).mean(dim=1, keepdim=True)
    dx = (rstd * (dyg - m1 - xhat * m2)).to(x.dtype).reshape(n, h, w, c)
    if gamma is None:
        return dx, None, None
    return (dx, (dyf * xhat).sum(dim=(0, 1)).to(gamma.dtype),
            dyf.sum(dim=(0, 1)).to(gamma.dtype))


class InstanceNormNHWC(torch.autograd.Function):
    """(y, mean, rstd) = instance_norm(x) [* gamma + beta]: forward K13,
    which keeps mean and rstd, backward ``instance_norm_nhwc_bwd``. Under
    ``torch.func.vmap`` (the paired step's stacked twin networks) K13 runs
    once on the members folded into the batch where they share gamma and
    beta (instance norm is per sample), else once per member: each member
    is then normalized exactly as an unpaired application."""

    @staticmethod
    def forward(x, gamma, beta, eps):
        return _instance_norm_nhwc(x, gamma, beta, eps)

    @staticmethod
    def setup_context(ctx, inputs, output):
        x, gamma, _, _ = inputs
        _, mean, rstd = output
        ctx.mark_non_differentiable(mean, rstd)
        ctx.save_for_backward(x, gamma, mean, rstd)

    @staticmethod
    def backward(ctx, dy, _dmean, _drstd):
        x, gamma, mean, rstd = ctx.saved_tensors
        dx, dgamma, dbeta = instance_norm_nhwc_bwd(x, dy, gamma, mean, rstd)
        return (dx if ctx.needs_input_grad[0] else None,
                dgamma if ctx.needs_input_grad[1] else None,
                dbeta if ctx.needs_input_grad[2] else None, None)

    @staticmethod
    def vmap(info, in_dims, x, gamma, beta, eps):
        n = info.batch_size
        x_dim, g_dim, b_dim, _ = in_dims
        if g_dim is None and b_dim is None:
            x = x.movedim(x_dim, 0)
            out = InstanceNormNHWC.apply(
                x.reshape(-1, *x.shape[2:]).contiguous(), gamma, beta, eps)
            return tuple(t.view(n, -1, *t.shape[1:]) for t in out), (0, 0, 0)

        def member(t, dim, i):
            return t if t is None or dim is None else t.select(dim, i)

        outs = [InstanceNormNHWC.apply(
            member(x, x_dim, i).contiguous(), member(gamma, g_dim, i),
            member(beta, b_dim, i), eps) for i in range(n)]
        return tuple(torch.stack(t) for t in zip(*outs)), (0, 0, 0)


def instance_norm_nhwc(x: torch.Tensor, gamma: Optional[torch.Tensor] = None,
                       beta: Optional[torch.Tensor] = None,
                       eps: float = TFA_EPSILON) -> torch.Tensor:
    """x [N,H,W,C]; gamma, beta [C] or None (non-affine); differentiable in
    x, gamma and beta."""
    return InstanceNormNHWC.apply(x.contiguous(), gamma, beta, eps)[0]
