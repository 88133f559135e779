"""The canonical CycleGAN networks (cyclegan_tpu/models/resnet.py), on
activations in the current layout (``ops/layout.py``): the ResNet generator
and the PatchGAN discriminator.

``ResNetGenerator`` (``resnet_generator``): a reflect-padded 7x7 stem, two
stride-2 3x3 downsamples, nine residual blocks of two reflect-padded 3x3
convs, two stride-2 3x3 transposed-conv upsamples and a reflect-padded 7x7
tanh head; every instance norm is non-affine, so the only parameters are
conv kernels and biases. ``SimpleDiscriminator`` (``simple_discriminator``):
N stride-2 convs, each followed by a non-affine instance norm and
LeakyReLU(0.2), then a 1x1 conv to one channel of patch logits.

Parameter names and shapes are the JAX package's, so ``state_dict`` keys are
the checkpoint's paths: ``stem``, ``down.{0,1}``, ``res.{i}.conv{1,2}``,
``up.{0,1}`` (HWOI), ``head``; ``blocks.{i}.conv`` and ``head``. The
PatchGAN's non-affine norms hold no parameter; ``blocks.{i}.norm`` is kept
as an empty block so the JAX tree's ``norm: {}`` survives the trip back
(``weights.module_to_jax_params``).
"""

from __future__ import annotations

from typing import Any, Mapping, Optional

import torch
from torch import nn

from cyclegan_tpu_torch.models.base import apply_norm_act, init_conv, init_norm
from cyclegan_tpu_torch.ops import (
    conv2d,
    conv2d_reflect,
    conv2d_transpose,
    instance_norm,
)

N_RESIDUAL_BLOCKS = 9


class ResNetGenerator(nn.Module):
    """ResNet-9 generator; ``forward`` takes and returns 3-channel
    activations in the current layout, H and W divisible by 4. Mandatory
    config field: ``filters`` (an int)."""

    def __init__(self, config: Mapping[str, Any],
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        f = int(config["filters"])
        self.batchable = True
        self.stem = init_conv(generator, 7, 3, f)
        self.down = nn.ModuleList([init_conv(generator, 3, f, 2 * f),
                                   init_conv(generator, 3, 2 * f, 4 * f)])
        self.res = nn.ModuleList([
            nn.ModuleDict({"conv1": init_conv(generator, 3, 4 * f, 4 * f),
                           "conv2": init_conv(generator, 3, 4 * f, 4 * f)})
            for _ in range(N_RESIDUAL_BLOCKS)])
        self.up = nn.ModuleList([
            init_conv(generator, 3, 4 * f, 2 * f, transpose=True),
            init_conv(generator, 3, 2 * f, f, transpose=True)])
        self.head = init_conv(generator, 7, f, 3)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = conv2d_reflect(x, self.stem["w"], self.stem["b"])
        x = instance_norm(x, act="relu")
        for p in self.down:
            x = instance_norm(conv2d(x, p["w"], p["b"], stride=2), act="relu")
        for block in self.res:
            c1, c2 = block["conv1"], block["conv2"]
            y = instance_norm(conv2d_reflect(x, c1["w"], c1["b"]), act="relu")
            x = x + instance_norm(conv2d_reflect(y, c2["w"], c2["b"]))
        for p in self.up:
            x = instance_norm(conv2d_transpose(x, p["w"], p["b"], stride=2),
                              act="relu")
        x = conv2d_reflect(x, self.head["w"], self.head["b"])
        return torch.tanh(x)


class SimpleDiscriminator(nn.Module):
    """PatchGAN; ``forward`` takes activations in the current layout and
    returns one channel of patch logits at H / 2^N, W / 2^N. Mandatory
    config fields: filters, kernels, normalization."""

    def __init__(self, config: Mapping[str, Any],
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        filters = list(config["filters"])
        kernels = list(config["kernels"])
        norm = config["normalization"]
        self.batchable = True
        c = int(config.get("in_channels", 3))
        self.blocks = nn.ModuleList()
        for k, f in zip(kernels, filters):
            self.blocks.append(nn.ModuleDict({
                "conv": init_conv(generator, k, c, f),
                "norm": init_norm(norm, f, affine=False)}))
            c = f
        self.head = init_conv(generator, 1, c, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for block in self.blocks:
            x = conv2d(x, block["conv"]["w"], block["conv"]["b"], stride=2)
            x = apply_norm_act(block["norm"], x, "leaky_relu", 0.2)
        return conv2d(x, self.head["w"], self.head["b"])
