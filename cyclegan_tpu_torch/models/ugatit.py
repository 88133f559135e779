"""U-GAT-IT (Kim et al., ICLR 2020, arXiv:1907.10830), the full model, on
activations in the current layout (``ops/layout.py``), with the equations
of the authors' PyTorch code (``networks.py``).

``UGATITGenerator`` (``ugatit_generator``; ``ngf``, ``n_res``,
``img_size``): a reflect-padded 7x7 stem, two reflect-padded stride-2 3x3
downsamples and ``n_res`` residual blocks, every conv without bias and
every instance norm non-affine (eps 1e-5); the class-activation-map (CAM)
attention (``cam``: global average and max pools, their C->1 logits,
whose own weights rescale the channels, then a 2C->C 1x1 conv with bias
and ReLU); the gamma/beta MLP (``gamma_beta``: the map flattened in its
NCHW (C, H, W) order whatever the layout, a Linear to C without bias,
ReLU, C->C, ReLU, and two C->C heads); ``n_res`` AdaLIN residual blocks,
two up-blocks (nearest 2x, reflect-padded 3x3 conv, ILN, ReLU) and a
reflect-padded 7x7 tanh head. It returns ``(image, cam_logit [B, 2])``.

``UGATITDiscriminator`` (``ugatit_discriminator``; ``ndf``,
``n_layers_global``, ``n_layers_local``): the ``global`` and ``local``
scales of one domain, each reflect-padded spectral-normalised 4x4 convs
with bias and LeakyReLU(0.2) (stride 2, then one stride-1 block), its own
CAM (spectral-normalised C->1 logits; the channels rescaled by the raw
weights, as the authors' ``list(gap_fc.parameters())[0]`` is
``weight_orig``; a 2C->C 1x1 conv with bias, not normalised, and
LeakyReLU) and a reflect-padded spectral-normalised 4x4 conv to one
channel without bias. It returns ``(logit_g, cam_g, logit_l, cam_l)``.

Spectral norm as ``torch.nn.utils.spectral_norm``: the weight as a
(out, -1) matrix, one power iteration per application in training mode
under ``no_grad`` (eps 1e-12) that updates the persistent ``u`` buffer
in place (a CUDA graph of the step replays it), then sigma = u^T W v,
differentiable in W, and W / sigma. Out of training mode no iteration
runs and v is taken from u (the discriminators serve nothing).

Parameters: conv ``w`` HWIO, Linear ``w`` [in, out], biases ``b``;
AdaLIN's ``rho`` (0.9) and ILN's ``rho`` (0), ``gamma`` (1), ``beta`` (0)
per channel. Weights are PyTorch's default init, as the authors' code
leaves them: every conv and linear weight and bias U(+-1/sqrt(fan_in)),
each ``u`` N(0, 1) normalised. Convs: K9 (and K9-dW, K10) for the
reflect-padded stride-1 odd convs in NHCW, K2/K6 for the instance norms,
K14/K15 for AdaLIN and ILN (``ops/ada_norm.py``), K7/K3 for the
upsample, K11/K12 for the CAM's concat; the library convolution (cuDNN)
for the reflect-padded stride-2 and 4x4 convs and the 1x1 convs; the
linears and the power iterations' products are cuBLAS calls.
"""

from __future__ import annotations

import math
from typing import Any, Mapping, Optional

import torch
import torch.nn.functional as F
from torch import nn

from cyclegan_tpu_torch.ops import (
    concat_channels,
    conv2d,
    conv2d_reflect,
    instance_norm,
    layout,
    reflection_pad2d,
)
from cyclegan_tpu_torch.ops.ada_norm import ada_norm
from cyclegan_tpu_torch.ops.resize import upsample_2x

IN_EPS = 1e-5  # torch.nn.InstanceNorm2d's
SN_EPS = 1e-12
LEAKY = 0.2


def _uniform(shape, fan_in: int, generator) -> torch.Tensor:
    bound = 1.0 / math.sqrt(fan_in)
    return torch.rand(shape, generator=generator) * (2 * bound) - bound


def conv_params(generator, k: int, cin: int, cout: int, bias: bool,
                sn: bool = False) -> nn.ParameterDict:
    """A conv's ``w`` [k, k, cin, cout] (and ``b``), PyTorch's default
    init; with ``sn`` the spectral norm's ``u`` [cout] buffer."""
    fan_in = k * k * cin
    p = nn.ParameterDict({"w": nn.Parameter(
        _uniform((k, k, cin, cout), fan_in, generator))})
    if bias:
        p["b"] = nn.Parameter(_uniform((cout,), fan_in, generator))
    if sn:
        p.register_buffer("u", F.normalize(
            torch.randn(cout, generator=generator), dim=0, eps=SN_EPS))
    return p


def _linear(generator, cin, cout):
    """A Linear without bias: ``w`` [cin, cout]."""
    return {"w": nn.Parameter(_uniform((cin, cout), cin, generator))}


def _sn_linear(generator, cin, cout):
    """A spectral-normalised Linear without bias: ``w`` and ``u`` [cout]."""
    p = nn.ParameterDict(_linear(generator, cin, cout))
    p.register_buffer("u", F.normalize(
        torch.randn(cout, generator=generator), dim=0, eps=SN_EPS))
    return p


def spectral_normalized(w: torch.Tensor, u: torch.Tensor,
                        power_iteration: bool) -> torch.Tensor:
    """W / sigma(W) in W's dtype, sigma = u^T W v in f32 with W as the
    (out, -1) matrix (HWIO and [in, out] reshape to its transpose); one
    power iteration first (u updated in place) where ``power_iteration``."""
    m = w.float().reshape(-1, w.shape[-1])  # [fan_in, out] = W^T
    with torch.no_grad():
        v = F.normalize(m @ u, dim=0, eps=SN_EPS)
        if power_iteration:
            u_new = F.normalize(m.t() @ v, dim=0, eps=SN_EPS)
            u.copy_(u_new)
        else:
            u_new = u.clone()
    sigma = torch.dot(u_new, m.t() @ v)
    return (w.float() / sigma).to(w.dtype)


def _pool_logits(x, w_gap, w_gmp):
    """The CAM's global average and max pools, [B, C] each, and their
    logits [B, 2]."""
    axes = layout.spatial_axes()
    gap = x.mean(dim=axes, dtype=torch.float32).to(x.dtype)
    gmp = x.amax(dim=axes)
    return torch.cat([gap @ w_gap, gmp @ w_gmp], dim=1)


def _cam(x, raw_gap, raw_gmp, logit_gap, logit_gmp, conv1x1, act):
    """(act(conv1x1([x * w_gap; x * w_gmp])), cam_logit): the channels
    rescaled by the raw C->1 weights, the logits from ``logit_*``."""
    logit = _pool_logits(x, logit_gap, logit_gmp)
    x = concat_channels([x * layout.channel_param(raw_gap[:, 0]),
                         x * layout.channel_param(raw_gmp[:, 0])])
    return act(conv2d(x, conv1x1["w"], conv1x1["b"], padding="VALID")), logit


def _flat_chw(x: torch.Tensor) -> torch.Tensor:
    """[B, C*H*W] in the NCHW view's order, whatever the layout."""
    nchw = x.permute(0, 2, 1, 3) if layout.is_nhcw() else x.permute(0, 3, 1, 2)
    return nchw.reshape(x.shape[0], -1)


def _down(x, w, stride, bias=None):
    """Reflect pad 1, then a VALID conv (the library's)."""
    return conv2d(reflection_pad2d(x, (1, 1)), w, bias, stride=stride,
                  padding="VALID")


class UGATITGenerator(nn.Module):
    """The U-GAT-IT generator; ``forward`` takes 3-channel activations of
    ``img_size`` x ``img_size`` in the current layout and returns
    ``(image, cam_logit)``."""

    def __init__(self, config: Mapping[str, Any],
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        f = int(config.get("ngf", 64))
        n_res = int(config.get("n_res", 4))
        size = int(config.get("img_size", 256))
        c = 4 * f
        gen = generator
        self.stem = conv_params(gen, 7, 3, f, False)
        self.down = nn.ModuleList([conv_params(gen, 3, f, 2 * f, False),
                                   conv_params(gen, 3, 2 * f, c, False)])
        self.res = nn.ModuleList([nn.ModuleDict({
            "conv1": conv_params(gen, 3, c, c, False),
            "conv2": conv_params(gen, 3, c, c, False)})
            for _ in range(n_res)])
        self.gap_fc = nn.ParameterDict(_linear(gen, c, 1))
        self.gmp_fc = nn.ParameterDict(_linear(gen, c, 1))
        self.conv1x1 = conv_params(gen, 1, 2 * c, c, True)
        self.fc = nn.ModuleList([
            nn.ParameterDict(_linear(gen, (size // 4) ** 2 * c, c)),
            nn.ParameterDict(_linear(gen, c, c))])
        self.gamma = nn.ParameterDict(_linear(gen, c, c))
        self.beta = nn.ParameterDict(_linear(gen, c, c))
        self.ada = nn.ModuleList([nn.ModuleDict({
            "conv1": conv_params(gen, 3, c, c, False),
            "norm1": nn.ParameterDict({"rho": nn.Parameter(
                torch.full((c,), 0.9))}),
            "conv2": conv_params(gen, 3, c, c, False),
            "norm2": nn.ParameterDict({"rho": nn.Parameter(
                torch.full((c,), 0.9))})}) for _ in range(n_res)])
        self.up = nn.ModuleList([nn.ModuleDict({
            "conv": conv_params(gen, 3, c // 2 ** i, c // 2 ** (i + 1),
                                False),
            "norm": nn.ParameterDict({
                "rho": nn.Parameter(torch.zeros(c // 2 ** (i + 1))),
                "gamma": nn.Parameter(torch.ones(c // 2 ** (i + 1))),
                "beta": nn.Parameter(torch.zeros(c // 2 ** (i + 1)))})})
            for i in range(2)])
        self.head = conv_params(gen, 7, f, 3, False)

    def rhos(self) -> list:
        """Every AdaLIN and ILN ``rho``, which the train step clips into
        [0, 1] after each update (the authors' ``RhoClipper``)."""
        return ([blk[n]["rho"] for blk in self.ada for n in ("norm1",
                                                             "norm2")]
                + [blk["norm"]["rho"] for blk in self.up])

    def forward(self, x: torch.Tensor):
        x = instance_norm(conv2d_reflect(x, self.stem["w"]), eps=IN_EPS,
                          act="relu")
        for p in self.down:
            x = instance_norm(_down(x, p["w"], 2), eps=IN_EPS, act="relu")
        for blk in self.res:
            y = instance_norm(conv2d_reflect(x, blk["conv1"]["w"]),
                              eps=IN_EPS, act="relu")
            x = x + instance_norm(conv2d_reflect(y, blk["conv2"]["w"]),
                                  eps=IN_EPS)
        w_gap, w_gmp = self.gap_fc["w"], self.gmp_fc["w"]
        x, cam_logit = _cam(x, w_gap, w_gmp, w_gap, w_gmp, self.conv1x1,
                            torch.relu)
        h = torch.relu(_flat_chw(x) @ self.fc[0]["w"])
        h = torch.relu(h @ self.fc[1]["w"])
        gamma, beta = h @ self.gamma["w"], h @ self.beta["w"]
        for blk in self.ada:
            y = ada_norm(conv2d_reflect(x, blk["conv1"]["w"]),
                         blk["norm1"]["rho"], gamma, beta, relu=True)
            x = x + ada_norm(conv2d_reflect(y, blk["conv2"]["w"]),
                             blk["norm2"]["rho"], gamma, beta)
        for blk in self.up:
            n = blk["norm"]
            x = ada_norm(conv2d_reflect(upsample_2x(x), blk["conv"]["w"]),
                         n["rho"], n["gamma"], n["beta"], relu=True)
        return torch.tanh(conv2d_reflect(x, self.head["w"])), cam_logit


def _sn(p: nn.ParameterDict, power_iteration: bool) -> torch.Tensor:
    return spectral_normalized(p["w"], p.u, power_iteration)


class DiscriminatorScale(nn.Module):
    """One scale of a U-GAT-IT discriminator (the authors'
    ``Discriminator(ndf, n_layers)``): ``blocks`` (n_layers - 2 stride-2
    convs, then one stride-1), ``gap_fc``, ``gmp_fc``, ``conv1x1``,
    ``head``."""

    def __init__(self, ndf: int, n_layers: int, generator):
        super().__init__()
        widths = [3] + [ndf * 2 ** i for i in range(n_layers - 1)]
        self.blocks = nn.ModuleList([
            conv_params(generator, 4, cin, cout, True, sn=True)
            for cin, cout in zip(widths[:-1], widths[1:])])
        c = widths[-1]
        self.gap_fc = _sn_linear(generator, c, 1)
        self.gmp_fc = _sn_linear(generator, c, 1)
        self.conv1x1 = conv_params(generator, 1, 2 * c, c, True)
        self.head = conv_params(generator, 4, c, 1, False, sn=True)

    def forward(self, x: torch.Tensor):
        it = self.training
        ws = [_sn(p, it) for p in self.blocks]
        w_gap, w_gmp = _sn(self.gap_fc, it), _sn(self.gmp_fc, it)
        w_head = _sn(self.head, it)
        last = len(self.blocks) - 1
        for i, (p, w) in enumerate(zip(self.blocks, ws)):
            x = F.leaky_relu(_down(x, w, 1 if i == last else 2, p["b"]),
                             LEAKY)
        x, cam_logit = _cam(x, self.gap_fc["w"], self.gmp_fc["w"], w_gap,
                            w_gmp, self.conv1x1,
                            lambda t: F.leaky_relu(t, LEAKY))
        return _down(x, w_head, 1), cam_logit


class UGATITDiscriminator(nn.Module):
    """A domain's global (``n_layers_global``, 7) and local
    (``n_layers_local``, 5) discriminators; ``forward`` returns
    ``(logit_g, cam_g, logit_l, cam_l)``."""

    def __init__(self, config: Mapping[str, Any],
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        ndf = int(config.get("ndf", 64))
        self.add_module("global", DiscriminatorScale(
            ndf, int(config.get("n_layers_global", 7)), generator))
        self.add_module("local", DiscriminatorScale(
            ndf, int(config.get("n_layers_local", 5)), generator))

    def forward(self, x: torch.Tensor):
        logit_g, cam_g = self._modules["global"](x)
        logit_l, cam_l = self._modules["local"](x)
        return logit_g, cam_g, logit_l, cam_l


def generated_image(out):
    """The image of a generator's output: a U-GAT-IT generator returns
    ``(image, cam_logit)``, the others the image alone."""
    return out[0] if isinstance(out, tuple) else out
