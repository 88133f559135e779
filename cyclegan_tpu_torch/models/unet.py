"""The U-Nets (cyclegan_tpu/models/unet.py), on activations in the current
layout (``ops/layout.py``).

``UNetGenerator`` (``unet_generator``): the default recipe's generators
(16/32/64/128, all k4, tanh) and, from the same builder, its
discriminators (16/32/64 at k7/k5/k3, one output channel, sigmoid).
Double-conv blocks (conv without bias -> affine instance norm -> ReLU,
twice) with a 2x2 average pool on the way down. On the way up, per level,
``expansion: upsample`` runs the nearest-2x upsample and skip concat (skip
first) as one junction; any other expansion runs a stride-2 conv-transpose
with bias -> affine instance norm -> ReLU, then the skip concat
(``concat_channels``), as the JAX builder does. A 1x1 conv with bias and
the final activation are the head.

``StridedUNet`` (``strided_unet``): per down level a stride-2 conv with
bias -> affine instance norm -> ReLU; a stride-2 bottom conv with bias and
no norm; per up level a stride-2 conv-transpose with bias, the skip concat,
then affine instance norm -> ReLU over both; a last k4 conv-transpose to
the output channels and the final activation. Its stride-2 convs and
conv-transposes are library convolutions (``ops/conv.py``), as the JAX
package runs them in XLA; in NHCW its norms and concats run kernels.

Parameter names and shapes are the JAX package's. Every op is
differentiable through the kernels' autograd Functions, so the same module
serves and trains.

``batchable`` (the JAX ``Model.batchable``): a forward on two batches
concatenated equals the two forwards concatenated. True but for a U-Net
with dropout, whose masks differ per application; the train step fuses
applications (``fuse_apps``) only where both generators are.

Dropout (``dropout: True``, Keras ``Dropout(0.5)`` after each double-conv
block's activation, as ``cyclegan_tpu/models/base.py`` ``dropout``): a
forward applies it only when it is given ``masks``, the keep masks that
``dropout_masks`` draws from an explicit generator, so the train step owns
the randomness and a rematerialized forward reapplies the same masks. As
in the JAX package, the discriminators, validation and serving never pass
masks, whatever the config says. In NHCW the mask multiplies K2's fused
norm + ReLU output as a torch op, as the TPU package has no kernel for it
either.
"""

from __future__ import annotations

import math
from typing import Any, Mapping, Optional

import torch
from torch import nn

from cyclegan_tpu_torch.models.base import apply_norm_act, init_conv, init_norm
from cyclegan_tpu_torch.ops import (
    apply_activation,
    avg_pool2x2,
    concat_channels,
    conv2d,
    conv2d_transpose,
    layout,
    upsample_concat,
)
from cyclegan_tpu_torch.ops.init import glorot_uniform

DROPOUT_RATE = 0.5


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


def dropout(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Keras inverted dropout with a drawn keep ``mask``:
    ``where(mask, x / keep, 0)``."""
    return torch.where(mask, x / (1.0 - DROPOUT_RATE), 0.0)


def _apply_double_conv(blocks: nn.ModuleList, x: torch.Tensor,
                       masks=None) -> torch.Tensor:
    for block in blocks:
        x = conv2d(x, block["conv"]["w"])
        x = apply_norm_act(block["norm"], x, "relu")
        if masks is not None:
            x = dropout(x, next(masks))
    return x


class UNetGenerator(nn.Module):
    """Pooled U-Net; ``forward`` takes and returns activations in the
    current layout (NHWC ``[B, H, W, C]`` or NHCW ``[B, H, C, W]``) and is
    differentiable in the input and the parameters.

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
        self.batchable = not self.use_dropout
        output_channels = config["output_channels"]
        self.final_activation = config["final_activation"]
        in_channels = int(config.get("in_channels", 3))
        self.transpose = expansion != "upsample"
        # (filters, level) of each double-conv block pair, in forward order
        n_down = len(filters) - 1
        self._blocks = ([(f, i) for i, f in enumerate(filters[:-1])]
                        + [(filters[-1], n_down)]
                        + [(f, n_down - 1 - i)
                           for i, f in enumerate(filters[::-1][:-1])])

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
            level = nn.ModuleDict()
            if self.transpose:
                level["convt"] = init_conv(generator, k, c, f, transpose=True)
                level["convt_norm"] = init_norm(norm, f, affine=True)
                c = f
            level["dc"] = _double_conv(generator, skip_c + c, f, k, norm)
            self.up.append(level)
            c = f
        # 1x1 head keeps the Keras-default glorot init and a bias
        self.head = init_conv(generator, 1, c, output_channels,
                              use_bias=True, kernel_init=glorot_uniform)

    def dropout_masks(self, shape, generator: torch.Generator,
                      lead: tuple = ()):
        """The keep masks of one training forward on an input of ``shape``
        (in the current layout), two per double-conv block in forward
        order, drawn from ``generator`` in one call on its device (each
        element kept with probability 1 - rate, as ``jax.random.bernoulli``
        draws them); ``lead`` prepends dimensions (a stacked pair). None
        without dropout."""
        if not self.use_dropout:
            return None
        b, h_axis, w_axis = shape[0], *layout.spatial_axes()
        shapes = []
        for f, level in self._blocks:
            dims = [b, 0, 0, 0]
            dims[h_axis] = shape[h_axis] >> level
            dims[w_axis] = shape[w_axis] >> level
            dims[layout.channel_axis()] = f
            shapes += [tuple(lead) + tuple(dims)] * 2
        sizes = [math.prod(s) for s in shapes]
        keep = torch.rand(sum(sizes), generator=generator,
                          device=generator.device) < 1.0 - DROPOUT_RATE
        return [m.view(s) for m, s in zip(keep.split(sizes), shapes)]

    def forward(self, x: torch.Tensor, masks=None) -> torch.Tensor:
        """``masks`` (``dropout_masks``) applies dropout; without them the
        forward has none, in training mode too."""
        masks = iter(masks) if masks is not None else None
        skips = []
        for blocks in self.down:
            x = _apply_double_conv(blocks, x, masks)
            skips.insert(0, x)
            x = avg_pool2x2(x)
        x = _apply_double_conv(self.bottom, x, masks)
        for level, skip in zip(self.up, skips):
            if self.transpose:
                convt = level["convt"]
                x = conv2d_transpose(x, convt["w"], convt["b"], stride=2)
                x = apply_norm_act(level["convt_norm"], x, "relu")
                x = concat_channels([skip, x])
            else:
                x = upsample_concat(skip, x)
            x = _apply_double_conv(level["dc"], x, masks)
        x = conv2d(x, self.head["w"], self.head["b"])
        return apply_activation(x, self.final_activation)


class StridedUNet(nn.Module):
    """Strided U-Net; ``forward`` takes activations in the current layout,
    H and W divisible by 2^len(filters), and returns output_channels of the
    same H and W.

    Mandatory config fields, as in the JAX builder: filters, kernels,
    normalization, output_channels, final_activation.
    """

    def __init__(self, config: Mapping[str, Any],
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        filters = list(config["filters"])
        kernels = list(config["kernels"])
        norm = config["normalization"]
        output_channels = config["output_channels"]
        self.final_activation = config["final_activation"]
        self.batchable = True
        c = int(config.get("in_channels", 3))

        self.down = nn.ModuleList()
        skip_channels = []
        for f, k in list(zip(filters, kernels))[:-1]:
            self.down.append(nn.ModuleDict({
                "conv": init_conv(generator, k, c, f),
                "norm": init_norm(norm, f, affine=True)}))
            skip_channels.append(f)
            c = f
        self.bottom = init_conv(generator, kernels[-1], c, filters[-1])
        c = filters[-1]
        self.up = nn.ModuleList()
        for f, k, skip_c in zip(filters[::-1][:-1], kernels[:0:-1],
                                skip_channels[::-1]):
            # the norm runs after the concat, over skip and up channels
            self.up.append(nn.ModuleDict({
                "convt": init_conv(generator, k, c, f, transpose=True),
                "norm": init_norm(norm, skip_c + f, affine=True)}))
            c = skip_c + f
        self.last = init_conv(generator, 4, c, output_channels,
                              transpose=True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        skips = []
        for level in self.down:
            conv = level["conv"]
            x = conv2d(x, conv["w"], conv["b"], stride=2)
            x = apply_norm_act(level["norm"], x, "relu")
            skips.insert(0, x)
        x = conv2d(x, self.bottom["w"], self.bottom["b"], stride=2)
        for level, skip in zip(self.up, skips):
            convt = level["convt"]
            x = conv2d_transpose(x, convt["w"], convt["b"], stride=2)
            x = concat_channels([skip, x])
            x = apply_norm_act(level["norm"], x, "relu")
        x = conv2d_transpose(x, self.last["w"], self.last["b"], stride=2)
        return apply_activation(x, self.final_activation)
