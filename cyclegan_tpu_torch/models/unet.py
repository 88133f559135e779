"""The pooled U-Net (cyclegan_tpu/models/unet.py ``unet_generator``), on
NHCW activations: the default recipe's generators (16/32/64/128, all k4,
tanh) and, from the same builder, its discriminators (16/32/64 at k7/k5/k3,
one output channel, sigmoid).

Double-conv blocks (conv without bias -> affine instance norm -> ReLU,
twice) with a 2x2 average pool on the way down; nearest-2x upsample and
skip concat (skip first) on the way up; a 1x1 conv with bias and the final
activation as head. Parameter names and shapes are the JAX package's.
Every op is differentiable through the kernels' autograd Functions, so the
same module serves and trains.

Dropout (``dropout: True``) is applied in training mode in the JAX package;
it is not ported yet, so a training-mode forward of such a config raises.
An eval-mode forward never applies dropout, in either package.
"""

from __future__ import annotations

from typing import Any, Mapping, Optional

import torch
from torch import nn

from cyclegan_tpu_torch.models.base import apply_norm_act, init_conv, init_norm
from cyclegan_tpu_torch.ops import (
    apply_activation,
    avg_pool2x2,
    conv2d,
    upsample_concat,
)
from cyclegan_tpu_torch.ops.init import glorot_uniform


def _double_conv(generator, in_c: int, out_c: int, kernel: int,
                 norm: str) -> nn.ModuleList:
    blocks = nn.ModuleList()
    c = in_c
    for _ in range(2):
        blocks.append(nn.ModuleDict({
            "conv": init_conv(generator, kernel, c, out_c, use_bias=False),
            "norm": init_norm(norm, out_c, affine=True),
        }))
        c = out_c
    return blocks


def _apply_double_conv(blocks: nn.ModuleList, x: torch.Tensor) -> torch.Tensor:
    for block in blocks:
        x = conv2d(x, block["conv"]["w"])
        x = apply_norm_act(block["norm"], x, "relu")
    return x


class UNetGenerator(nn.Module):
    """Pooled U-Net; ``forward`` takes and returns NHCW ``[B, H, C, W]``
    and is differentiable in the input and the parameters.

    Mandatory config fields, as in the JAX builder (KeyError if absent):
    filters, kernels, expansion, normalization, dropout, output_channels,
    final_activation.
    """

    def __init__(self, config: Mapping[str, Any],
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        filters = list(config["filters"])
        kernels = list(config["kernels"])
        expansion = config["expansion"]
        norm = config["normalization"]
        self.use_dropout = bool(config["dropout"])
        output_channels = config["output_channels"]
        self.final_activation = config["final_activation"]
        in_channels = int(config.get("in_channels", 3))
        if expansion != "upsample":
            raise NotImplementedError(
                f"unet_generator expansion: {expansion!r} is not ported yet "
                f"(ROADMAP.md queue 1, item 'the other recipes'; needs "
                f"the channel concat, Pallas #12)")

        down_specs = list(zip(filters, kernels))[:-1]
        up_filters = filters[::-1][:-1]
        up_kernels = kernels[:0:-1]

        self.down = nn.ModuleList()
        c = in_channels
        skip_channels = []
        for f, k in down_specs:
            self.down.append(_double_conv(generator, c, f, k, norm))
            skip_channels.append(f)
            c = f
        self.bottom = _double_conv(generator, c, filters[-1], kernels[-1],
                                   norm)
        c = filters[-1]
        self.up = nn.ModuleList()
        for f, k, skip_c in zip(up_filters, up_kernels, skip_channels[::-1]):
            self.up.append(nn.ModuleDict({
                "dc": _double_conv(generator, skip_c + c, f, k, norm)}))
            c = f
        # 1x1 head keeps the Keras-default glorot init and a bias
        self.head = init_conv(generator, 1, c, output_channels,
                              use_bias=True, kernel_init=glorot_uniform)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.use_dropout and self.training:
            raise NotImplementedError(
                "unet_generator dropout: True in training mode is not ported "
                "yet (ROADMAP.md queue 1, item 'the other recipes')")
        skips = []
        for blocks in self.down:
            x = _apply_double_conv(blocks, x)
            skips.insert(0, x)
            x = avg_pool2x2(x)
        x = _apply_double_conv(self.bottom, x)
        for level, skip in zip(self.up, skips):
            x = upsample_concat(skip, x)
            x = _apply_double_conv(level["dc"], x)
        x = conv2d(x, self.head["w"], self.head["b"])
        return apply_activation(x, self.final_activation)
