"""U-GAT-IT's adaptive layer-instance norm (AdaLIN) and layer-instance norm
(ILN), with an optional ReLU, on activations in the current layout:

    y = (rho_c xhat_in + (1 - rho_c) xhat_ln) gamma + beta

xhat_in normalizes over each sample's (H, W) plane per channel, xhat_ln
over each sample's (C, H, W); both with the unbiased variance
(``torch.var``) and eps 1e-5, as the authors' ``adaILN`` and ``ILN``.
``rho`` is [C]; ``gamma`` and ``beta`` are [B, C] (AdaLIN: per sample, from
the generator's MLP) or [C] (ILN: learned per channel).

- NHCW: kernels K14 (forward) and K15 (backward) on the card
  (``kernels/csrc/ada_norm.cu``), their plain versions on the CPU, joined
  by the autograd Function ``AdaNorm``. Bound by bytes: the forward reads
  x twice (the statistics, then the output pass) and writes y; the
  backward reads x and dy twice and writes dx. The layer statistics are
  the planes' (count, mean, M2) merged by Chan's formula, in f32.
- NHWC: torch ops of the same formula, differentiated by autograd.
"""

from __future__ import annotations

import torch

from cyclegan_tpu_torch import kernels
from cyclegan_tpu_torch.kernels import F as CF
from cyclegan_tpu_torch.kernels import I, P
from cyclegan_tpu_torch.ops import layout

EPS = 1e-5
# the f32 counts of the kernels' statistics are exact below this
MAX_COUNT = 1 << 24


def _check(x, rho, gamma, beta):
    if x.dim() != 4:
        raise ValueError(f"ada_norm takes x [B,H,C,W], got {tuple(x.shape)}")
    B, H, C, W = x.shape
    if tuple(rho.shape) != (C,):
        raise ValueError(f"rho {tuple(rho.shape)} for {C} channels")
    for p in (gamma, beta):
        if tuple(p.shape) not in ((B, C), (C,)):
            raise ValueError(f"gamma/beta {tuple(p.shape)}: expected "
                             f"({B}, {C}) or ({C},)")
    if H * W < 2 or C * H * W >= MAX_COUNT:
        raise ValueError(f"ada_norm: plane {H}x{W} of {C} channels out of "
                         f"range")


def _work_dtype(x):
    """f32, or f64 for f64 input (the gradient checks)."""
    return torch.float64 if x.dtype == torch.float64 else torch.float32


def _per_sample(p, B, dtype):
    """gamma or beta as [B, C] in ``dtype``."""
    p = p.to(dtype)
    return (p.expand(B, p.shape[0]) if p.dim() == 1 else p).contiguous()


def ada_norm_plain(x, rho, gamma, beta, eps: float = EPS,
                   relu: bool = False, with_stats: bool = False):
    """K14's function on NHCW x with explicit sums: plane mean and M2, the
    layer's from them (equal counts: Chan's formula), then
    y = x A + Bc per plane. With ``with_stats`` also the saved statistics
    ``(saved [5, B, C]: mu_in, M2_in, r_in, A, Bc; layer [2, B]: mu_ln,
    r_ln)``, as the kernel writes them."""
    _check(x, rho, gamma, beta)
    B, H, C, W = x.shape
    dt = _work_dtype(x)
    xf = x.to(dt)
    n_in = H * W
    mu = xf.mean(dim=(1, 3))                                  # [B, C]
    m2 = ((xf - mu[:, None, :, None]) ** 2).sum(dim=(1, 3))
    mu_ln = mu.mean(dim=1)                                    # [B]
    m2_ln = m2.sum(dim=1) + n_in * ((mu - mu_ln[:, None]) ** 2).sum(dim=1)
    r_in = 1.0 / torch.sqrt(m2 / (n_in - 1) + eps)
    r_ln = 1.0 / torch.sqrt(m2_ln / (n_in * C - 1) + eps)
    p = rho.to(dt)
    g, bt = _per_sample(gamma, B, dt), _per_sample(beta, B, dt)
    a = g * (p * r_in + (1 - p) * r_ln[:, None])
    bc = bt - g * (p * r_in * mu + (1 - p) * r_ln[:, None] * mu_ln[:, None])
    y = xf * a[:, None, :, None] + bc[:, None, :, None]
    if relu:
        y = torch.clamp(y, min=0.0)
    y = y.to(x.dtype)
    if with_stats:
        return y, torch.stack([mu, m2, r_in, a, bc]), torch.stack([mu_ln,
                                                                   r_ln])
    return y


def ada_norm_bwd_plain(x, gy, rho, gamma, saved, layer, relu: bool = False):
    """K15's function: (dx, drho [C], dgamma [B, C], dbeta [B, C]), the
    parameter gradients in the statistics' dtype. g = dy masked by the
    ReLU; P1 = sum g, P2 = sum g (x - mu_in) per plane;
    S_in = r_in P2, S_ln = r_ln (P2 + (mu_in - mu_ln) P1); dbeta = P1,
    dgamma = rho S_in + (1 - rho) S_ln, drho = sum_b gamma (S_in - S_ln);
    dx = g A + c_in (x - mu_in) + c_ln (x - mu_ln) + k3."""
    B, H, C, W = x.shape
    dt = saved.dtype
    n_in, n_ln = H * W, H * W * C
    mu, _, r_in, a, bc = saved
    mu_ln, r_ln = layer
    xf = x.to(dt)
    g = gy.to(dt)
    if relu:
        pre = xf * a[:, None, :, None] + bc[:, None, :, None]
        g = torch.where(pre > 0, g, torch.zeros_like(g))
    p1 = g.sum(dim=(1, 3))
    p2 = (g * (xf - mu[:, None, :, None])).sum(dim=(1, 3))
    p = rho.to(dt)
    gm = _per_sample(gamma, B, dt)
    s_in = r_in * p2
    s_ln = r_ln[:, None] * (p2 + (mu - mu_ln[:, None]) * p1)
    dbeta = p1
    dgamma = p * s_in + (1 - p) * s_ln
    drho = (gm * (s_in - s_ln)).sum(dim=0)
    w = (1 - p) * gm
    g1 = (w * p1).sum(dim=1)
    g2 = (w * s_ln).sum(dim=1)
    c_in = -p * gm * r_in * r_in * s_in / (n_in - 1)
    k3 = -p * gm * r_in * p1 / n_in - (r_ln * g1 / n_ln)[:, None]
    c_ln = -r_ln * r_ln * g2 / (n_ln - 1)
    e = lambda t: t[:, None, :, None]  # noqa: E731
    dx = (g * e(a) + e(c_in) * (xf - e(mu))
          + c_ln[:, None, None, None] * (xf - mu_ln[:, None, None, None])
          + e(k3))
    return dx.to(x.dtype), drho, dgamma, dbeta


def ada_norm_geometry(x_shape, tensors) -> int:
    """1 where a launch walks 16-byte units (W a whole number of them and
    every pointer 16-byte aligned), else 0 (one element a unit); the C
    entry points refuse a launch that says otherwise."""
    x = tensors[0]
    v = 16 // x.element_size()
    return int(x_shape[3] % v == 0
               and all(t.data_ptr() % 16 == 0 for t in tensors))


def ada_norm_cuda(x, rho, gamma, beta, eps: float = EPS, relu: bool = False,
                  with_stats: bool = False):
    """Launch K14 on CUDA tensors (rho, gamma, beta taken in f32)."""
    _check(x, rho, gamma, beta)
    kernels.check_cuda("ada_norm", x)
    B, H, C, W = x.shape
    r = rho.float().contiguous()
    g = _per_sample(gamma, B, torch.float32)
    bt = _per_sample(beta, B, torch.float32)
    y = torch.empty_like(x)
    saved = torch.empty((5, B, C), dtype=torch.float32, device=x.device)
    layer_stats = torch.empty((2, B), dtype=torch.float32, device=x.device)
    vec = ada_norm_geometry(x.shape, (x, y))
    fn = kernels.function("ada_norm", f"ada_norm_{kernels.dtype_suffix(x)}",
                          [P] * 7 + [I] * 4 + [CF, I, I, P])
    err = fn(kernels.ptr(x), kernels.ptr(r), kernels.ptr(g), kernels.ptr(bt),
             kernels.ptr(y), kernels.ptr(saved), kernels.ptr(layer_stats),
             B, H, C, W, float(eps), int(relu), vec, kernels.stream())
    kernels.check("ada_norm", err)
    kernels.launches["ada_norm"] += 1
    kernels.paths["ada_norm." + ("vector" if vec else "element")] += 1
    return (y, saved, layer_stats) if with_stats else y


def ada_norm_bwd_cuda(x, gy, rho, gamma, saved, layer_stats,
                      relu: bool = False):
    """Launch K15 on CUDA tensors; returns (dx, drho, dgamma, dbeta)."""
    kernels.check_cuda("ada_norm_bwd", x, gy)
    B, H, C, W = x.shape
    r = rho.float().contiguous()
    g = _per_sample(gamma, B, torch.float32)
    dx = torch.empty_like(x)
    f32 = dict(dtype=torch.float32, device=x.device)
    p = torch.empty((2, B, C), **f32)
    coef = torch.empty((2, B, C), **f32)
    ln = torch.empty((2, B), **f32)
    drho = torch.empty((C,), **f32)
    dgamma = torch.empty((B, C), **f32)
    dbeta = torch.empty((B, C), **f32)
    vec = ada_norm_geometry(x.shape, (x, gy, dx))
    fn = kernels.function("ada_norm",
                          f"ada_norm_bwd_{kernels.dtype_suffix(x)}",
                          [P] * 13 + [I] * 6 + [P])
    err = fn(kernels.ptr(x), kernels.ptr(gy), kernels.ptr(r), kernels.ptr(g),
             kernels.ptr(saved), kernels.ptr(layer_stats), kernels.ptr(dx),
             kernels.ptr(p), kernels.ptr(coef), kernels.ptr(ln),
             kernels.ptr(drho), kernels.ptr(dgamma), kernels.ptr(dbeta),
             B, H, C, W, int(relu), vec, kernels.stream())
    kernels.check("ada_norm", err)
    kernels.launches["ada_norm_bwd"] += 1
    kernels.paths["ada_norm_bwd." + ("vector" if vec else "element")] += 1
    return dx, drho, dgamma, dbeta


class AdaNorm(torch.autograd.Function):
    """y = ada_norm(x, rho, gamma, beta) on NHCW x: forward K14 (which keeps
    its statistics), backward K15; each parameter's gradient in its own
    dtype, summed over the batch where it is per channel (ILN)."""

    @staticmethod
    def forward(ctx, x, rho, gamma, beta, eps, relu):
        y, saved, layer_stats = kernels.dispatch(
            "ada_norm", ada_norm_cuda, ada_norm_plain, x, rho, gamma, beta,
            eps, relu, with_stats=True)
        ctx.save_for_backward(x, rho, gamma, saved, layer_stats)
        ctx.relu = relu
        ctx.dtypes = (gamma.dtype, beta.dtype, gamma.dim())
        return y

    @staticmethod
    def backward(ctx, gy):
        x, rho, gamma, saved, layer_stats = ctx.saved_tensors
        dx, drho, dgamma, dbeta = kernels.dispatch(
            "ada_norm_bwd", ada_norm_bwd_cuda, ada_norm_bwd_plain, x,
            gy.contiguous(), rho, gamma, saved, layer_stats, ctx.relu)
        g_dtype, b_dtype, per_channel = ctx.dtypes
        if per_channel == 1:
            dgamma, dbeta = dgamma.sum(dim=0), dbeta.sum(dim=0)
        return (dx, drho.to(rho.dtype), dgamma.to(g_dtype),
                dbeta.to(b_dtype), None, None)


def _nhwc(x, rho, gamma, beta, eps, relu):
    """The formula in torch ops on NHWC x, as the authors write it."""
    xf = x.to(_work_dtype(x))
    mu_in = xf.mean(dim=(1, 2), keepdim=True)
    var_in = xf.var(dim=(1, 2), keepdim=True)
    mu_ln = xf.mean(dim=(1, 2, 3), keepdim=True)
    var_ln = xf.var(dim=(1, 2, 3), keepdim=True)
    x_in = (xf - mu_in) / torch.sqrt(var_in + eps)
    x_ln = (xf - mu_ln) / torch.sqrt(var_ln + eps)
    p = rho.to(xf.dtype)
    g = gamma.to(xf.dtype)
    b = beta.to(xf.dtype)
    if g.dim() == 2:
        g, b = g[:, None, None, :], b[:, None, None, :]
    y = (p * x_in + (1 - p) * x_ln) * g + b
    if relu:
        y = torch.relu(y)
    return y.to(x.dtype)


def ada_norm(x: torch.Tensor, rho: torch.Tensor, gamma: torch.Tensor,
             beta: torch.Tensor, eps: float = EPS,
             relu: bool = False) -> torch.Tensor:
    """AdaLIN (gamma, beta [B, C]) or ILN (gamma, beta [C]) of x in the
    current layout, then ReLU where ``relu``; differentiable in x, rho,
    gamma and beta."""
    if not layout.is_nhcw():
        return _nhwc(x, rho, gamma, beta, eps, relu)
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, rho, gamma, beta)):
        return AdaNorm.apply(x.contiguous(), rho, gamma, beta, eps, relu)
    return kernels.dispatch("ada_norm", ada_norm_cuda, ada_norm_plain,
                            x.contiguous(), rho, gamma, beta, eps, relu)
