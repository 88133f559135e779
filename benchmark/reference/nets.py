"""The networks of a configuration in plain PyTorch, NCHW, from the
configuration's own sizes: the U-Net generator and discriminator of the
default recipe, the ResNet-9 generator and the PatchGAN discriminator of
the CycleGAN paper.

Written from the published description and the configuration's keys
alone; it imports nothing of the program. Parameters are a flat dict per
network, named as the checkpoint names them (``down.0.1.conv.w``), with
conv kernels HWIO ``[K, K, in, out]`` and transposed-conv kernels HWOI
``[K, K, out, in]``, so that the benchmark can hand one set of weights to
both sides.

Every convolution, norm and stored activation goes through a ``Convs``
object, which keeps them in float32 (``precision="f32"``, the reference),
in bfloat16 (``precision="bf16"``: operands and activations between the
layers in bfloat16, statistics in f32, the configuration's own precision
in plain PyTorch, a witness of what its rounding alone does), or in
float8 at the same points (``precision="fp8"``, the control: conv
operands and stored activations rounded to e4m3 under a per-tensor scale,
their gradients to e5m2); and can record each convolution's shapes for the operation and
byte counts (``benchmark/flops.py``).
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

IN_EPSILON = 1e-3  # tensorflow_addons' InstanceNormalization
N_RESIDUAL = 9
FP8_FORWARD = torch.float8_e4m3fn
FP8_BACKWARD = torch.float8_e5m2


def _fp8(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``t`` rounded to ``dtype`` under a per-tensor scale that maps its
    largest magnitude to the format's largest finite value."""
    peak = t.detach().abs().amax().float()
    if not torch.isfinite(peak) or peak == 0:
        return t
    scale = torch.finfo(dtype).max / peak
    return ((t.float() * scale).to(dtype).float() / scale).to(t.dtype)


class _Fp8(torch.autograd.Function):
    """Forward rounds to e4m3, backward rounds the incoming gradient to
    e5m2: the usual float8 training recipe."""

    @staticmethod
    def forward(ctx, x):
        return _fp8(x, FP8_FORWARD)

    @staticmethod
    def backward(ctx, g):
        return _fp8(g, FP8_BACKWARD)


class Convs:
    """How the reference convolves: ``precision`` "f32" or "fp8", and an
    optional ``record`` list that receives one tuple per convolution:
    (kind, x shape, kernel size, out channels, output shape), kind
    "conv" or "convt"."""

    def __init__(self, precision: str = "f32",
                 record: Optional[List[tuple]] = None):
        if precision not in ("f32", "bf16", "fp8"):
            raise ValueError(f"precision {precision!r}: f32, bf16 or fp8")
        self.precision = precision
        self.record = record

    def _q(self, t: torch.Tensor) -> torch.Tensor:
        if self.precision == "fp8":
            return _Fp8.apply(t)
        if self.precision == "bf16":
            return t.to(torch.bfloat16)
        return t

    def _b(self, b, like: torch.Tensor):
        return None if b is None else b.to(like.dtype)

    def store(self, t: torch.Tensor) -> torch.Tensor:
        """An activation as a layer hands it on: kept in f32, in bf16, or
        rounded to float8 (e4m3, its gradient to e5m2)."""
        if self.precision == "fp8":
            return _Fp8.apply(t)
        if self.precision == "bf16":
            return t.to(torch.bfloat16)
        return t

    def norm(self, x, gamma=None, beta=None, act=None):
        """Instance norm, then ``act`` (relu, leaky or none), stored."""
        y = instance_norm(x, gamma, beta)
        if act == "relu":
            y = torch.relu(y)
        elif act == "leaky":
            y = F.leaky_relu(y, 0.2)
        return self.store(y)

    def _log(self, kind, x, k, cout, y):
        if self.record is not None:
            self.record.append((kind, tuple(x.shape), k, cout,
                                tuple(y.shape)))

    def conv(self, x, w, b=None, stride=1, pad=((0, 0), (0, 0))):
        """x NCHW, w HWIO; ``pad`` ((top, bottom), (left, right)) of
        zeros before a VALID convolution."""
        (pt, pb), (pl, pr) = pad
        xp = self._q(F.pad(x, (pl, pr, pt, pb)) if (pt or pb or pl or pr)
                     else x)
        y = F.conv2d(xp, self._q(w.permute(3, 2, 0, 1)), self._b(b, xp),
                     stride=stride)
        self._log("conv", x, w.shape[0], w.shape[3], y)
        return self.store(y)

    def conv_reflect(self, x, w, b=None):
        """Reflect-pad K // 2 (the edge not repeated), then VALID."""
        p = w.shape[0] // 2
        xp = self._q(F.pad(x, (p, p, p, p), mode="reflect"))
        y = F.conv2d(xp, self._q(w.permute(3, 2, 0, 1)), self._b(b, xp))
        self._log("conv", x, w.shape[0], w.shape[3], y)
        return self.store(y)

    def convt(self, x, w, b=None, stride=2):
        """TF ``Conv2DTranspose(padding='same')``: output H * stride. w is
        HWOI. The adjoint of a stride-s 'SAME' conv: padding before
        pb = max(K - s, 0) // 2 on the dilated input's far side, one row
        and column computed past the end and dropped where K - s is odd."""
        k = w.shape[0]
        before = max(k - stride, 0) // 2
        extra = stride - k + 2 * before
        xq = self._q(x)
        y = F.conv_transpose2d(xq, self._q(w.permute(3, 2, 0, 1)),
                               self._b(b, xq), stride=stride, padding=before,
                               output_padding=max(extra, 0))
        if extra < 0:
            y = y[:, :, :y.shape[2] + extra, :y.shape[3] + extra]
        self._log("convt", x, k, w.shape[2], y)
        return self.store(y)


def same_pad(size: int, k: int, stride: int) -> Tuple[int, int]:
    """TF 'SAME' (before, after) of one axis: output ceil(size / stride),
    the odd pixel after."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def conv_same(c: Convs, x, w, b=None, stride=1):
    k = w.shape[0]
    return c.conv(x, w, b, stride, (same_pad(x.shape[2], k, stride),
                                    same_pad(x.shape[3], k, stride)))


def instance_norm(x, gamma=None, beta=None, eps=IN_EPSILON):
    """Per sample and channel over H and W, biased variance, computed in
    f32 and returned in x's dtype."""
    xf = x.float()
    mean = xf.mean(dim=(2, 3), keepdim=True)
    var = ((xf - mean) ** 2).mean(dim=(2, 3), keepdim=True)
    y = (xf - mean) / torch.sqrt(var + eps)
    if gamma is not None:
        y = y * gamma.view(1, -1, 1, 1)
    if beta is not None:
        y = y + beta.view(1, -1, 1, 1)
    return y.to(x.dtype)


ACTIVATIONS = {"tanh": torch.tanh, "sigmoid": torch.sigmoid,
               "linear": lambda t: t, None: lambda t: t}


# --------------------------------------------------------------------------
# parameter shapes


def unet_shapes(cfg: dict, in_c: int = 3) -> Dict[str, tuple]:
    """The pooled U-Net: per down level a double conv (conv without bias,
    affine instance norm, ReLU; twice) and a 2x2 average pool; the bottom
    double conv; per up level the nearest-2x upsample concatenated after
    the skip, and a double conv at the filters reversed, less the first;
    a 1x1 conv with bias as the head."""
    if cfg["expansion"] != "upsample" or cfg.get("dropout"):
        raise ValueError("the reference U-Net has upsample expansion and "
                         "no dropout")
    filters, kernels = list(cfg["filters"]), list(cfg["kernels"])
    shapes: Dict[str, tuple] = {}

    def double(prefix, cin, cout, k):
        for j in range(2):
            shapes[f"{prefix}.{j}.conv.w"] = (k, k, cin if j == 0 else cout,
                                              cout)
            shapes[f"{prefix}.{j}.norm.gamma"] = (cout,)
            shapes[f"{prefix}.{j}.norm.beta"] = (cout,)

    c, skips = in_c, []
    for i, (f, k) in enumerate(list(zip(filters, kernels))[:-1]):
        double(f"down.{i}", c, f, k)
        skips.append(f)
        c = f
    double("bottom", c, filters[-1], kernels[-1])
    c = filters[-1]
    # up levels take the filters reversed without the smallest, as the
    # reference builder does: a U-Net of 16-32-64-128 goes up at 128, 64, 32
    for i, (f, k, s) in enumerate(zip(filters[::-1][:-1], kernels[:0:-1],
                                      skips[::-1])):
        double(f"up.{i}.dc", s + c, f, k)
        c = f
    shapes["head.w"] = (1, 1, c, int(cfg["output_channels"]))
    shapes["head.b"] = (int(cfg["output_channels"]),)
    return shapes


def resnet_shapes(cfg: dict) -> Dict[str, tuple]:
    """ResNet-9: c7s1-f, d2f, d4f, nine residual blocks of two 3x3 convs at
    4f, u2f, uf, c7s1-3; every conv with a bias."""
    f = int(cfg["filters"])
    shapes: Dict[str, tuple] = {}

    def conv(name, k, cin, cout, transpose=False):
        shapes[f"{name}.w"] = (k, k, cout, cin) if transpose else \
            (k, k, cin, cout)
        shapes[f"{name}.b"] = (cout,)

    conv("stem", 7, 3, f)
    conv("down.0", 3, f, 2 * f)
    conv("down.1", 3, 2 * f, 4 * f)
    for i in range(N_RESIDUAL):
        conv(f"res.{i}.conv1", 3, 4 * f, 4 * f)
        conv(f"res.{i}.conv2", 3, 4 * f, 4 * f)
    conv("up.0", 3, 4 * f, 2 * f, transpose=True)
    conv("up.1", 3, 2 * f, f, transpose=True)
    conv("head", 7, f, 3)
    return shapes


def patchgan_shapes(cfg: dict, in_c: int = 3) -> Dict[str, tuple]:
    """PatchGAN: stride-2 convs with bias, each followed by a non-affine
    instance norm and LeakyReLU(0.2), then a 1x1 conv to one channel."""
    if cfg["normalization"] != "instancenorm":
        raise ValueError("the reference PatchGAN takes instance norm")
    shapes: Dict[str, tuple] = {}
    c = in_c
    for i, (k, f) in enumerate(zip(cfg["kernels"], cfg["filters"])):
        shapes[f"blocks.{i}.conv.w"] = (k, k, c, f)
        shapes[f"blocks.{i}.conv.b"] = (f,)
        c = f
    shapes["head.w"] = (1, 1, c, 1)
    shapes["head.b"] = (1,)
    return shapes


SHAPES = {"unet_generator": unet_shapes, "resnet_generator": resnet_shapes,
          "simple_discriminator": patchgan_shapes}


def shapes_of(net_cfg: dict) -> Dict[str, tuple]:
    kind = net_cfg["type"]
    if kind not in SHAPES:
        raise ValueError(f"no reference for network type {kind!r}")
    return SHAPES[kind](net_cfg)


# --------------------------------------------------------------------------
# forwards


def _double(c: Convs, p, prefix, x):
    for j in range(2):
        x = conv_same(c, x, p[f"{prefix}.{j}.conv.w"])
        x = c.norm(x, p[f"{prefix}.{j}.norm.gamma"],
                   p[f"{prefix}.{j}.norm.beta"], "relu")
    return x


def unet_forward(c: Convs, cfg: dict, p, x):
    n_down = len(cfg["filters"]) - 1
    skips = []
    for i in range(n_down):
        x = _double(c, p, f"down.{i}", x)
        skips.insert(0, x)
        x = c.store(F.avg_pool2d(x, 2))
    x = _double(c, p, "bottom", x)
    for i, skip in enumerate(skips):
        up = x.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)
        x = _double(c, p, f"up.{i}.dc", torch.cat([skip, up], dim=1))
    x = conv_same(c, x, p["head.w"], p["head.b"])
    return c.store(ACTIVATIONS[cfg["final_activation"]](x))


def resnet_forward(c: Convs, cfg: dict, p, x):
    x = c.norm(c.conv_reflect(x, p["stem.w"], p["stem.b"]), act="relu")
    for i in range(2):
        x = c.norm(conv_same(c, x, p[f"down.{i}.w"], p[f"down.{i}.b"],
                             stride=2), act="relu")
    for i in range(N_RESIDUAL):
        y = c.norm(c.conv_reflect(x, p[f"res.{i}.conv1.w"],
                                  p[f"res.{i}.conv1.b"]), act="relu")
        x = c.store(x + c.norm(c.conv_reflect(y, p[f"res.{i}.conv2.w"],
                                              p[f"res.{i}.conv2.b"])))
    for i in range(2):
        x = c.norm(c.convt(x, p[f"up.{i}.w"], p[f"up.{i}.b"]), act="relu")
    return c.store(torch.tanh(c.conv_reflect(x, p["head.w"], p["head.b"])))


def patchgan_forward(c: Convs, cfg: dict, p, x):
    for i in range(len(cfg["filters"])):
        x = conv_same(c, x, p[f"blocks.{i}.conv.w"], p[f"blocks.{i}.conv.b"],
                      stride=2)
        x = c.norm(x, act="leaky")
    return conv_same(c, x, p["head.w"], p["head.b"])


FORWARDS = {"unet_generator": unet_forward, "resnet_generator": resnet_forward,
            "simple_discriminator": patchgan_forward}


def forward(c: Convs, net_cfg: dict, params, x):
    """One application of a network to NCHW ``x``."""
    return FORWARDS[net_cfg["type"]](c, net_cfg, params, x)


def n_params(net_cfg: dict) -> int:
    return sum(math.prod(s) for s in shapes_of(net_cfg).values())
