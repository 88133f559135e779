"""U-GAT-IT (Kim et al., ICLR 2020, arXiv:1907.10830), full model, in plain
PyTorch: the generator, the global and local discriminators with spectral
norm, the losses, Adam with coupled weight decay and one train step, NCHW,
from the equations of the authors' PyTorch code (``networks.py``,
``UGATIT.py``) and the configuration's keys alone. It imports nothing of
the program and no JAX.

Parameters are a flat dict per network, named as the program's
``state_dict`` names them (``ada.0.norm1.rho``, ``global.blocks.0.u``),
conv kernels HWIO ``[K, K, in, out]``, Linear weights ``[in, out]``, so
that one set of weights serves both sides.

Every convolution, Linear and stored activation goes through an ``Ops``
object: float32 with TF32 off (``precision="f32"``, the reference), the
operands and activations in bfloat16 with f32 statistics (``"bf16"``, a
witness of the configuration's own rounding) or rounded to float8 e4m3
under a per-tensor scale, gradients to e5m2 (``"fp8"``, the control); it
can record each convolution, Linear, AdaLIN/ILN and power iteration for
the operation and byte counts. ``ada_rho_one`` fixes every AdaLIN rho at
1, AdaLIN without its layer branch (a fault).

Departures from the authors' code, as the program has them:

- update order: the generators' and discriminators' gradients are taken
  at the same parameters (four gradients of one forward set); the authors
  update D first and take the G step through the updated D;
- power iterations: one per discriminator application, in the step's
  order of applications (each discriminator on its reals, then on its
  fakes twice: the generator's view and the discriminator's);
- jitter: bilinear resize to size + 50 (306), a random crop of size and a
  horizontal flip; the authors resize to 286;
- precision: the program runs bf16 networks over f32 master weights and
  f32 losses; this reference runs f32.
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

IN_EPS = 1e-5
SN_EPS = 1e-12
LEAKY = 0.2
JITTER_PAD = 50
NETWORKS = ("g_AB", "g_BA", "d_A", "d_B")
LOSS_NAMES = ("gAB_loss", "gBA_loss", "dA_loss", "dB_loss")
SCALES = ("global", "local")
FP8_FORWARD = torch.float8_e4m3fn
FP8_BACKWARD = torch.float8_e5m2


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


def _fp8(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    peak = t.detach().abs().amax().float()
    if t.device.type == "meta" or not torch.isfinite(peak) or peak == 0:
        return t
    scale = torch.finfo(dtype).max / peak
    return ((t.float() * scale).to(dtype).float() / scale).to(t.dtype)


class _Fp8(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return _fp8(x, FP8_FORWARD)

    @staticmethod
    def backward(ctx, g):
        return _fp8(g, FP8_BACKWARD)


class Ops:
    """How the reference computes: ``precision`` "f32", "bf16" or "fp8";
    ``record`` (a dict of lists) receives ``conv`` (x shape, w shape,
    stride, y shape), ``linear`` (rows, in, out), ``ada`` (x shape, relu)
    and ``power`` (weight elements) entries."""

    def __init__(self, precision: str = "f32", record: Optional[dict] = None,
                 ada_rho_one: bool = False):
        if precision not in ("f32", "bf16", "fp8"):
            raise ValueError(f"precision {precision!r}: f32, bf16 or fp8")
        self.precision = precision
        self.record = record
        self.ada_rho_one = ada_rho_one

    def _log(self, kind, *entry):
        if self.record is not None:
            self.record.setdefault(kind, []).append(entry)

    def q(self, t: torch.Tensor) -> torch.Tensor:
        """An operand (or a stored activation) in the working precision."""
        if self.precision == "fp8":
            return _Fp8.apply(t)
        if self.precision == "bf16":
            return t.to(torch.bfloat16)
        return t

    def conv(self, x, w, b=None, stride=1, reflect=0):
        """Reflect-pad ``reflect`` (the edge not repeated), then a VALID
        convolution; x NCHW, w HWIO."""
        xp = F.pad(x, (reflect,) * 4, mode="reflect") if reflect else x
        xq = self.q(xp)
        y = F.conv2d(xq, self.q(w.permute(3, 2, 0, 1)),
                     None if b is None else b.to(xq.dtype), stride=stride)
        self._log("conv", tuple(xp.shape), tuple(w.shape), stride,
                  tuple(y.shape))
        return self.q(y)

    def linear(self, x, w):
        """x [N, in] @ w [in, out]."""
        y = self.q(x) @ self.q(w)
        self._log("linear", x.shape[0], w.shape[0], w.shape[1])
        return self.q(y)

    def instance_norm(self, x, relu=False):
        """Non-affine instance norm, biased variance, eps 1e-5."""
        xf = x.float()
        mu = xf.mean(dim=(2, 3), keepdim=True)
        var = xf.var(dim=(2, 3), keepdim=True, unbiased=False)
        y = (xf - mu) / torch.sqrt(var + IN_EPS)
        return self.q((torch.relu(y) if relu else y).to(x.dtype))

    def ada_lin(self, x, rho, gamma, beta, relu=False, ada=True):
        """The authors' ``adaILN`` (gamma, beta [B, C]) or ``ILN`` ([C]):
        unbiased variances, eps 1e-5."""
        self._log("ada", tuple(x.shape), relu)
        xf = x.float()
        in_mean = xf.mean(dim=(2, 3), keepdim=True)
        in_var = xf.var(dim=(2, 3), keepdim=True)
        out_in = (xf - in_mean) / torch.sqrt(in_var + IN_EPS)
        ln_mean = xf.mean(dim=(1, 2, 3), keepdim=True)
        ln_var = xf.var(dim=(1, 2, 3), keepdim=True)
        out_ln = (xf - ln_mean) / torch.sqrt(ln_var + IN_EPS)
        r = rho.float().view(1, -1, 1, 1)
        if ada and self.ada_rho_one:
            r = torch.ones_like(r)
        g, b = gamma.float(), beta.float()
        g = g.view(1, -1, 1, 1) if g.dim() == 1 else g[:, :, None, None]
        b = b.view(1, -1, 1, 1) if b.dim() == 1 else b[:, :, None, None]
        out = (r * out_in + (1 - r) * out_ln) * g + b
        return self.q((torch.relu(out) if relu else out).to(x.dtype))

    def spectral(self, w, u, power_iteration=True):
        """``torch.nn.utils.spectral_norm``'s weight: W as the (out, -1)
        matrix, one power iteration (u updated in place) under no_grad,
        sigma = u^T W v, then W / sigma; the weight in the working
        precision."""
        wq = self.q(w)
        mat = wq.float().permute(*range(w.dim() - 1, -1, -1)).reshape(
            w.shape[-1], -1)
        with torch.no_grad():
            v = F.normalize(mat.t() @ u, dim=0, eps=SN_EPS)
            if power_iteration:
                u_new = F.normalize(mat @ v, dim=0, eps=SN_EPS)
                u.copy_(u_new)
            else:
                u_new = u.clone()
        self._log("power", w.numel())
        sigma = torch.dot(u_new, mat @ v)
        return (wq.float() / sigma).to(wq.dtype)


# ----------------------------------------------------------------------
# shapes and weights
# ----------------------------------------------------------------------

def generator_shapes(cfg: dict) -> Dict[str, tuple]:
    """{name: shape} of a generator's parameters."""
    f = int(cfg["ngf"])
    n_res = int(cfg["n_res"])
    size = int(cfg["img_size"])
    c = 4 * f
    out = {"stem.w": (7, 7, 3, f), "down.0.w": (3, 3, f, 2 * f),
           "down.1.w": (3, 3, 2 * f, c)}
    for i in range(n_res):
        out[f"res.{i}.conv1.w"] = (3, 3, c, c)
        out[f"res.{i}.conv2.w"] = (3, 3, c, c)
    out.update({"gap_fc.w": (c, 1), "gmp_fc.w": (c, 1),
                "conv1x1.w": (1, 1, 2 * c, c), "conv1x1.b": (c,),
                "fc.0.w": ((size // 4) ** 2 * c, c), "fc.1.w": (c, c),
                "gamma.w": (c, c), "beta.w": (c, c)})
    for i in range(n_res):
        out[f"ada.{i}.conv1.w"] = (3, 3, c, c)
        out[f"ada.{i}.norm1.rho"] = (c,)
        out[f"ada.{i}.conv2.w"] = (3, 3, c, c)
        out[f"ada.{i}.norm2.rho"] = (c,)
    for i in range(2):
        cin, cout = c // 2 ** i, c // 2 ** (i + 1)
        out[f"up.{i}.conv.w"] = (3, 3, cin, cout)
        for k in ("rho", "gamma", "beta"):
            out[f"up.{i}.norm.{k}"] = (cout,)
    out["head.w"] = (7, 7, f, 3)
    return out


def scale_shapes(ndf: int, n_layers: int, prefix: str) -> Dict[str, tuple]:
    widths = [3] + [ndf * 2 ** i for i in range(n_layers - 1)]
    out = {}
    for i, (cin, cout) in enumerate(zip(widths[:-1], widths[1:])):
        out[f"{prefix}.blocks.{i}.w"] = (4, 4, cin, cout)
        out[f"{prefix}.blocks.{i}.b"] = (cout,)
        out[f"{prefix}.blocks.{i}.u"] = (cout,)
    c = widths[-1]
    for fc in ("gap_fc", "gmp_fc"):
        out[f"{prefix}.{fc}.w"] = (c, 1)
        out[f"{prefix}.{fc}.u"] = (1,)
    out[f"{prefix}.conv1x1.w"] = (1, 1, 2 * c, c)
    out[f"{prefix}.conv1x1.b"] = (c,)
    out[f"{prefix}.head.w"] = (4, 4, c, 1)
    out[f"{prefix}.head.u"] = (1,)
    return out


def discriminator_shapes(cfg: dict) -> Dict[str, tuple]:
    ndf = int(cfg["ndf"])
    return {**scale_shapes(ndf, int(cfg["n_layers_global"]), "global"),
            **scale_shapes(ndf, int(cfg["n_layers_local"]), "local")}


def shapes(cfg: dict) -> Dict[str, Dict[str, tuple]]:
    """{network: {name: shape}} of a configuration's four networks."""
    g, d = generator_shapes(cfg["generator"]), discriminator_shapes(
        cfg["discriminator"])
    return {n: (g if n.startswith("g") else d) for n in NETWORKS}


def fan_in(name: str, shape: tuple, table: Dict[str, tuple]) -> int:
    """The fan-in of a weight or of the bias beside it."""
    w = table[name[:-1] + "w"] if name.endswith(".b") else shape
    return math.prod(w[:-1])


def make_weights(cfg: dict, seed: int, device
                 ) -> Dict[str, Dict[str, torch.Tensor]]:
    """{network: {name: f32 tensor}} as the authors' code leaves a fresh
    model (PyTorch's default init): every conv and Linear weight and bias
    U(+-1/sqrt(fan_in)), every spectral-norm ``u`` N(0, 1) normalised
    (eps 1e-12), AdaLIN rho 0.9, ILN rho 0, gamma 1, beta 0. The uniform
    and the normal draws are two calls on ``device`` from one generator
    seeded with ``seed``, in the networks' and names' order."""
    table = shapes(cfg)
    drawn = [(n, k, s) for n in NETWORKS for k, s in table[n].items()
             if k.endswith((".w", ".b"))]
    normal = [(n, k, s) for n in NETWORKS for k, s in table[n].items()
              if k.endswith(".u")]
    gen = torch.Generator(device=device).manual_seed(int(seed))
    uni = torch.rand(sum(math.prod(s) for _, _, s in drawn), generator=gen,
                     device=device)
    nor = torch.randn(sum(math.prod(s) for _, _, s in normal), generator=gen,
                      device=device)
    out: Dict[str, Dict[str, torch.Tensor]] = {n: {} for n in NETWORKS}
    for (n, k, s), part in zip(drawn, uni.split([math.prod(s)
                                                 for _, _, s in drawn])):
        bound = 1.0 / math.sqrt(fan_in(k, s, table[n]))
        out[n][k] = (part * (2 * bound) - bound).view(s)
    for (n, k, s), part in zip(normal, nor.split([math.prod(s)
                                                  for _, _, s in normal])):
        out[n][k] = F.normalize(part, dim=0, eps=SN_EPS).view(s)
    for n in NETWORKS:
        for k, s in table[n].items():
            if k.endswith(".rho"):
                ada = k.startswith("ada.")
                out[n][k] = torch.full(s, 0.9 if ada else 0.0, device=device)
            elif k.endswith(".gamma"):
                out[n][k] = torch.ones(s, device=device)
            elif k.endswith(".beta"):
                out[n][k] = torch.zeros(s, device=device)
    return {n: {k: out[n][k] for k in table[n]} for n in NETWORKS}


# ----------------------------------------------------------------------
# networks
# ----------------------------------------------------------------------

def _cam(o: Ops, p, prefix, x, w_gap, w_gmp, act):
    """The CAM: pools, their logits through ``w_gap``/``w_gmp``, the
    channels rescaled by the raw weights, the 1x1 conv and ``act``."""
    gap = x.float().mean(dim=(2, 3)).to(x.dtype)
    gmp = x.amax(dim=(2, 3))
    logit = torch.cat([o.linear(gap, w_gap), o.linear(gmp, w_gmp)], dim=1)
    raw_gap, raw_gmp = p[prefix + "gap_fc.w"], p[prefix + "gmp_fc.w"]
    x = torch.cat([x * o.q(raw_gap)[:, 0].view(1, -1, 1, 1),
                   x * o.q(raw_gmp)[:, 0].view(1, -1, 1, 1)], dim=1)
    y = o.conv(x, p[prefix + "conv1x1.w"], p[prefix + "conv1x1.b"])
    return act(y), logit


def generator(o: Ops, cfg: dict, p: Dict[str, torch.Tensor],
              x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(image, cam_logit) of x NCHW in [-1, 1]."""
    n_res = int(cfg["n_res"])
    x = o.instance_norm(o.conv(x, p["stem.w"], reflect=3), relu=True)
    for i in range(2):
        x = o.instance_norm(o.conv(x, p[f"down.{i}.w"], stride=2, reflect=1),
                            relu=True)
    for i in range(n_res):
        y = o.instance_norm(o.conv(x, p[f"res.{i}.conv1.w"], reflect=1),
                            relu=True)
        x = x + o.instance_norm(o.conv(y, p[f"res.{i}.conv2.w"], reflect=1))
    x, cam_logit = _cam(o, p, "", x, p["gap_fc.w"], p["gmp_fc.w"],
                        torch.relu)
    h = torch.relu(o.linear(x.reshape(x.shape[0], -1), p["fc.0.w"]))
    h = torch.relu(o.linear(h, p["fc.1.w"]))
    gamma, beta = o.linear(h, p["gamma.w"]), o.linear(h, p["beta.w"])
    for i in range(n_res):
        y = o.ada_lin(o.conv(x, p[f"ada.{i}.conv1.w"], reflect=1),
                      p[f"ada.{i}.norm1.rho"], gamma, beta, relu=True)
        x = x + o.ada_lin(o.conv(y, p[f"ada.{i}.conv2.w"], reflect=1),
                          p[f"ada.{i}.norm2.rho"], gamma, beta)
    for i in range(2):
        x = F.interpolate(x, scale_factor=2, mode="nearest")
        x = o.ada_lin(o.conv(x, p[f"up.{i}.conv.w"], reflect=1),
                      p[f"up.{i}.norm.rho"], p[f"up.{i}.norm.gamma"],
                      p[f"up.{i}.norm.beta"], relu=True, ada=False)
    return torch.tanh(o.conv(x, p["head.w"], reflect=3)), cam_logit


def _scale(o: Ops, p, prefix: str, n_layers: int, x, power_iteration):
    def sn(name):
        return o.spectral(p[prefix + name + ".w"], p[prefix + name + ".u"],
                          power_iteration)

    n_blocks = n_layers - 1
    for i in range(n_blocks):
        w = sn(f"blocks.{i}")
        x = F.leaky_relu(o.conv(x, w, p[prefix + f"blocks.{i}.b"],
                                stride=2 if i < n_blocks - 1 else 1,
                                reflect=1), LEAKY)
    x, cam_logit = _cam(o, p, prefix, x, sn("gap_fc"), sn("gmp_fc"),
                        lambda t: F.leaky_relu(t, LEAKY))
    return o.conv(x, sn("head"), reflect=1), cam_logit


def discriminator(o: Ops, cfg: dict, p: Dict[str, torch.Tensor],
                  x: torch.Tensor, power_iteration: bool = True):
    """(logit_g, cam_g, logit_l, cam_l); one power iteration of every
    spectral-normalised weight (``u`` updated in place in ``p``)."""
    logit_g, cam_g = _scale(o, p, "global.", int(cfg["n_layers_global"]), x,
                            power_iteration)
    logit_l, cam_l = _scale(o, p, "local.", int(cfg["n_layers_local"]), x,
                            power_iteration)
    return logit_g, cam_g, logit_l, cam_l


# ----------------------------------------------------------------------
# losses and the train step
# ----------------------------------------------------------------------

def _mse(y, target):
    return torch.mean((y - target) ** 2)


def _l1(x, y):
    return torch.mean(torch.abs(x - y))


def _bce(logits, target):
    return F.binary_cross_entropy_with_logits(
        logits, torch.full_like(logits, target))


def losses(cfg: dict, o: Ops, p, real_a, real_b) -> Dict[str, torch.Tensor]:
    """Each network's total loss, in f32, from the forward set in the
    program's order: g_AB(a), g_BA(fake_b), g_BA(b), g_AB(fake_a), g_BA(a),
    g_AB(b); d_A(a), d_B(b), then d_A and d_B on their fakes twice (the
    generator's view, the discriminator's on the detached fakes)."""
    w = cfg["loss_weights"]
    adv, cyc, idw, camw = (w["adversarial"], w["cycle"], w["identity"],
                           w["cam"])
    g_cfg, d_cfg = cfg["generator"], cfg["discriminator"]

    def g(name, x):
        img, cam = generator(o, g_cfg, p[name], x)
        return img.float(), cam.float()

    def d(name, x):
        return [t.float() for t in discriminator(o, d_cfg, p[name], x)]

    fake_b, cam_ab = g("g_AB", real_a)
    cycled_a, _ = g("g_BA", fake_b)
    fake_a, cam_ba = g("g_BA", real_b)
    cycled_b, _ = g("g_AB", fake_a)
    same_a, cam_aa = g("g_BA", real_a)
    same_b, cam_bb = g("g_AB", real_b)
    d_real_a, d_real_b = d("d_A", real_a), d("d_B", real_b)
    d_fake_a_gen = d("d_A", fake_a)
    d_fake_a_d = d("d_A", fake_a.detach())
    d_fake_b_gen = d("d_B", fake_b)
    d_fake_b_d = d("d_B", fake_b.detach())

    def lsq(outs, target):
        return sum(_mse(y, target) for y in outs)

    cycle_a, cycle_b = _l1(cycled_a, real_a), _l1(cycled_b, real_b)
    g_loss_a = (adv * lsq(d_fake_a_gen, 1.0) + cyc * cycle_a
                + idw * _l1(same_a, real_a)
                + camw * (_bce(cam_ba, 1.0) + _bce(cam_aa, 0.0)))
    g_loss_b = (adv * lsq(d_fake_b_gen, 1.0) + cyc * cycle_b
                + idw * _l1(same_b, real_b)
                + camw * (_bce(cam_ab, 1.0) + _bce(cam_bb, 0.0)))
    return {
        "gAB_loss": g_loss_b + cyc * cycle_a,
        "gBA_loss": g_loss_a + cyc * cycle_b,
        "dA_loss": adv * (lsq(d_real_a, 1.0) + lsq(d_fake_a_d, 0.0)),
        "dB_loss": adv * (lsq(d_real_b, 1.0) + lsq(d_fake_b_d, 0.0)),
    }


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
    per-sample offsets drawn from [0, 50], a horizontal flip with
    probability 1/2; the offsets drawn first, then the flips, on the
    generator's (CPU) stream. NCHW float32 in [-1, 1]."""
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


class Adam:
    """torch's Adam with coupled weight decay: g += wd p, then
    p -= lr m_hat / (sqrt(v_hat) + eps), both moments bias-corrected."""

    def __init__(self, lr: float, b1: float, b2: float, eps: float,
                 weight_decay: float):
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps
        self.wd = weight_decay
        self.t = 0
        self.m: Dict[str, torch.Tensor] = {}
        self.v: Dict[str, torch.Tensor] = {}

    @torch.no_grad()
    def decayed(self, params, grads) -> Dict[str, torch.Tensor]:
        """The gradients as Adam takes them: g + wd p."""
        return {k: g + self.wd * params[k] for k, g in grads.items()}

    @torch.no_grad()
    def update(self, params: Dict[str, torch.Tensor],
               grads: Dict[str, torch.Tensor]) -> None:
        self.t += 1
        bc1, bc2 = 1 - self.b1 ** self.t, 1 - self.b2 ** self.t
        for k, g in self.decayed(params, grads).items():
            m = self.m.setdefault(k, torch.zeros_like(g))
            v = self.v.setdefault(k, torch.zeros_like(g))
            m.mul_(self.b1).add_(g, alpha=1 - self.b1)
            v.mul_(self.b2).addcmul_(g, g, value=1 - self.b2)
            params[k] -= self.lr * (m / bc1) / (torch.sqrt(v / bc2)
                                                + self.eps)


def trainable(name: str) -> bool:
    """Parameters, not the spectral norm's ``u`` buffers."""
    return not name.endswith(".u")


def train(cfg: dict, params: Dict[str, Dict[str, torch.Tensor]],
          batches: Sequence[Tuple[torch.Tensor, torch.Tensor]],
          jitter_seed: int, precision: str = "f32", rows=None,
          ada_rho_one: bool = False
          ) -> Tuple[List[Dict[str, float]], Dict[str, float],
                     Dict[str, float]]:
    """Train from ``params`` ({network: {name: f32 tensor}}, updated in
    place, ``u`` buffers included) on the uint8 NHWC ``batches``, one
    (a, b) pair a step, the jitter drawn from a CPU generator seeded with
    ``jitter_seed`` (a's draws, then b's, each step): the forward set, each
    network's own loss differentiated with respect to that network alone,
    Adam (coupled weight decay) on every network, then every generator rho
    clipped into [0, 1]. ``rows``, where given, keeps only those rows of
    each jittered batch (a fault). Returns each step's losses, the
    per-leaf norms of the first step's gradients as Adam took them (g + wd
    p; ``{"network.leaf": norm}``) and of the parameters' change over all
    the steps."""
    size = int(cfg["image_size"])
    oc = cfg["optimizer"]
    o = Ops(precision, ada_rho_one=ada_rho_one)
    gen = torch.Generator().manual_seed(int(jitter_seed))
    start = {n: {k: v.detach().clone() for k, v in p.items()
                 if trainable(k)} for n, p in params.items()}
    opts = {n: Adam(oc["learning_rate"], oc["beta_1"], oc["beta_2"],
                    oc["epsilon"], oc["weight_decay"]) for n in NETWORKS}
    step_losses, first_grads = [], {}
    for a, b in batches:
        real_a = jitter(gen, a, size)
        real_b = jitter(gen, b, size)
        if rows is not None:
            real_a, real_b = real_a[rows], real_b[rows]
        live = {n: {k: (v.detach().requires_grad_(True) if trainable(k)
                        else v) for k, v in p.items()}
                for n, p in params.items()}
        with f32_scope():
            ls = losses(cfg, o, live, real_a, real_b)
            grads = {}
            for n, loss_name in zip(NETWORKS, LOSS_NAMES):
                keys = [k for k in live[n] if trainable(k)]
                values = torch.autograd.grad(ls[loss_name],
                                             [live[n][k] for k in keys],
                                             retain_graph=True,
                                             allow_unused=True)
                # a leaf the loss does not reach (every AdaLIN rho under
                # ``ada_rho_one``) has a zero gradient
                grads[n] = {k: torch.zeros_like(live[n][k]) if g is None
                            else g for k, g in zip(keys, values)}
        step_losses.append({k: float(v.detach()) for k, v in ls.items()})
        del ls, live
        if not first_grads:
            first_grads = {f"{n}.{k}": float(g.float().norm())
                           for n in NETWORKS
                           for k, g in opts[n].decayed(params[n],
                                                       grads[n]).items()}
        for n in NETWORKS:
            opts[n].update(params[n], grads[n])
        for n in ("g_AB", "g_BA"):
            for k, v in params[n].items():
                if k.endswith(".rho"):
                    v.clamp_(0.0, 1.0)
        del grads
    change = {f"{n}.{k}": float((params[n][k] - start[n][k]).norm())
              for n in NETWORKS for k in start[n]}
    return step_losses, first_grads, change


@torch.no_grad()
def stylize(g_cfg: dict, params: Dict[str, torch.Tensor],
            images: torch.Tensor, precision: str = "f32") -> torch.Tensor:
    """uint8 NHWC in, uint8 NHWC out: one generator forward's image."""
    with f32_scope():
        y, _ = generator(Ops(precision), g_cfg, params, to_unit(images))
    return to_uint8(y.float())
