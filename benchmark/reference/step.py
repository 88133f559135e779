"""The CycleGAN training step and the stylization in plain PyTorch: the
train-time jitter, the losses, four gradients taken one by one (each
network's own loss with respect to that network alone, as the original
Keras code's four ``tape.gradient`` calls), and Adam; and the uint8 in,
uint8 out forward of a generator.

Float32 with TF32 off (``f32_scope``) for the reference, with float8
convolutions (``nets.Convs(precision="fp8")``) for the control, or in
bfloat16 (``"bf16"``) as a witness of the configuration's own rounding. It imports
nothing of the program.
"""

from __future__ import annotations

import contextlib
from typing import Dict, List, Sequence, Tuple

import torch
import torch.nn.functional as F

from benchmark.reference import nets

JITTER_PAD = 50  # resize to size + 50, then crop back to size
NETWORKS = ("g_AB", "g_BA", "d_A", "d_B")
LOSS_NAMES = ("gAB_loss", "gBA_loss", "dA_loss", "dB_loss")


@contextlib.contextmanager
def f32_scope():
    """Float32 matrix products and convolutions without TF32, and
    deterministic cuDNN algorithms; the previous settings restored."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32,
             torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32,
         torch.backends.cudnn.deterministic,
         torch.backends.cudnn.benchmark) = saved


def to_unit(images: torch.Tensor) -> torch.Tensor:
    """uint8 NHWC -> float32 NCHW in [-1, 1]."""
    return images.permute(0, 3, 1, 2).float() / 127.5 - 1.0


def to_uint8(x: torch.Tensor) -> torch.Tensor:
    """float NCHW in [-1, 1] -> uint8 NHWC, rounded half to even, clipped."""
    y = torch.round((x.float() + 1.0) * 127.5).clamp(0, 255)
    return y.to(torch.uint8).permute(0, 2, 3, 1)


def jitter(generator: torch.Generator, images: torch.Tensor,
           size: int) -> torch.Tensor:
    """The train-time jitter of one uint8 NHWC batch: bilinear resize
    (half-pixel centres, no antialiasing) to size + 50, a crop of size at
    per-sample offsets drawn from [0, 50], and a horizontal flip with
    probability 1/2; the offsets drawn first, then the flips, on the
    generator's (CPU) stream. Returns NCHW float32 in [-1, 1]."""
    n = images.shape[0]
    offsets = torch.randint(0, JITTER_PAD + 1, (n, 2), generator=generator)
    flips = torch.rand(n, generator=generator) < 0.5
    big = size + JITTER_PAD
    x = F.interpolate(to_unit(images), size=(big, big), mode="bilinear",
                      align_corners=False, antialias=False)
    out = []
    for i in range(n):
        top, left = int(offsets[i, 0]), int(offsets[i, 1])
        crop = x[i, :, top:top + size, left:left + size]
        out.append(crop.flip(2) if bool(flips[i]) else crop)
    return torch.stack(out)


def adversarial(name: str):
    if name == "mse":
        return lambda target, y: torch.mean((target - y) ** 2)
    if name == "mae":
        return lambda target, y: torch.mean(torch.abs(target - y))
    raise ValueError(f"no reference for the adversarial loss {name!r}")


def losses(cfg: dict, c: nets.Convs, p, real_a, real_b
           ) -> Dict[str, torch.Tensor]:
    """The forward set and each network's total loss: six generator
    applications, the discriminators on the real and the fake batches."""
    g_cfg, d_cfg = cfg["generator"], cfg["discriminator"]
    w = cfg["loss_weights"]
    adv = adversarial(cfg["loss"])

    def g(name, x):
        return nets.forward(c, g_cfg, p[name], x).float()

    def d(name, x):
        return nets.forward(c, d_cfg, p[name], x).float()

    fake_b = g("g_AB", real_a)
    cycled_a = g("g_BA", fake_b)
    fake_a = g("g_BA", real_b)
    cycled_b = g("g_AB", fake_a)
    same_a = g("g_BA", real_a)
    same_b = g("g_AB", real_b)
    d_real_a, d_real_b = d("d_A", real_a), d("d_B", real_b)
    d_fake_a, d_fake_b = d("d_A", fake_a), d("d_B", fake_b)

    def l1(x, y):
        return torch.mean(torch.abs(x - y))

    cycle = w["cycle"] * (l1(real_a, cycled_a) + l1(real_b, cycled_b))
    ones, zeros = torch.ones_like, torch.zeros_like
    return {
        "gAB_loss": (w["generator"] * adv(ones(d_fake_b), d_fake_b) + cycle
                     + w["identity"] * l1(real_b, same_b)),
        "gBA_loss": (w["generator"] * adv(ones(d_fake_a), d_fake_a) + cycle
                     + w["identity"] * l1(real_a, same_a)),
        "dA_loss": w["discriminator"] * (adv(ones(d_real_a), d_real_a)
                                         + adv(zeros(d_fake_a), d_fake_a)),
        "dB_loss": w["discriminator"] * (adv(ones(d_real_b), d_real_b)
                                         + adv(zeros(d_fake_b), d_fake_b)),
    }


class Adam:
    """Adam as published, with both moments bias-corrected:
    p -= lr * m_hat / (sqrt(v_hat) + eps)."""

    def __init__(self, lr: float, b1: float, b2: float, eps: float):
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps
        self.t = 0
        self.m: Dict[str, torch.Tensor] = {}
        self.v: Dict[str, torch.Tensor] = {}

    @torch.no_grad()
    def update(self, params: Dict[str, torch.Tensor],
               grads: Dict[str, torch.Tensor]) -> None:
        self.t += 1
        bc1, bc2 = 1 - self.b1 ** self.t, 1 - self.b2 ** self.t
        for k, g in grads.items():
            m = self.m.setdefault(k, torch.zeros_like(g))
            v = self.v.setdefault(k, torch.zeros_like(g))
            m.mul_(self.b1).add_(g, alpha=1 - self.b1)
            v.mul_(self.b2).addcmul_(g, g, value=1 - self.b2)
            params[k] -= self.lr * (m / bc1) / (torch.sqrt(v / bc2)
                                                + self.eps)


def train(cfg: dict, params: Dict[str, Dict[str, torch.Tensor]],
          batches: Sequence[Tuple[torch.Tensor, torch.Tensor]],
          jitter_seed: int, precision: str = "f32", rows=None
          ) -> Tuple[List[Dict[str, float]], Dict[str, float],
                     Dict[str, float]]:
    """Train from ``params`` ({network: {name: f32 tensor}}, updated in
    place) on the uint8 NHWC ``batches``, one (a, b) pair a step, the
    jitter drawn from a CPU generator seeded with ``jitter_seed`` (a's
    draws, then b's, each step). ``rows``, where given, keeps only those
    rows of each jittered batch (a fault: part of the batch left out).
    Returns each step's losses, the per-leaf norms of the first step's
    gradients ({"network.leaf": norm}) and of the parameters' change over
    all the steps."""
    size = int(cfg["image_size"])
    opt_cfg = cfg["optimizer"]
    conv = nets.Convs(precision)
    gen = torch.Generator().manual_seed(int(jitter_seed))
    start = {n: {k: v.detach().clone() for k, v in p.items()}
             for n, p in params.items()}
    opts = {n: Adam(opt_cfg["learning_rate"], opt_cfg["beta_1"],
                    opt_cfg["beta_2"], opt_cfg["epsilon"]) for n in NETWORKS}
    step_losses, first_grads = [], {}
    for a, b in batches:
        real_a = jitter(gen, a, size)
        real_b = jitter(gen, b, size)
        if rows is not None:
            real_a, real_b = real_a[rows], real_b[rows]
        live = {n: {k: v.detach().requires_grad_(True) for k, v in p.items()}
                for n, p in params.items()}
        with f32_scope():
            ls = losses(cfg, conv, live, real_a, real_b)
            grads = {}
            for n, loss_name in zip(NETWORKS, LOSS_NAMES):
                keys = list(live[n])
                values = torch.autograd.grad(ls[loss_name],
                                             [live[n][k] for k in keys],
                                             retain_graph=True)
                grads[n] = dict(zip(keys, values))
        step_losses.append({k: float(v.detach()) for k, v in ls.items()})
        del ls, live
        if not first_grads:
            first_grads = {f"{n}.{k}": float(g.float().norm())
                           for n in NETWORKS for k, g in grads[n].items()}
        for n in NETWORKS:
            opts[n].update(params[n], grads[n])
        del grads
    change = {f"{n}.{k}": float((params[n][k] - start[n][k]).norm())
              for n in NETWORKS for k in params[n]}
    return step_losses, first_grads, change


@torch.no_grad()
def stylize(net_cfg: dict, params: Dict[str, torch.Tensor],
            images: torch.Tensor, precision: str = "f32") -> torch.Tensor:
    """uint8 NHWC in, uint8 NHWC out: one generator forward."""
    with f32_scope():
        y = nets.forward(nets.Convs(precision), net_cfg, params,
                         to_unit(images))
    return to_uint8(y.float())
