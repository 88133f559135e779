"""Image ops on activations in the current layout (``ops/layout.py``): NHWC
by default, NHCW inside ``layout.nhcw()``. Each op with a hand-written
kernel is an autograd Function whose forward and backward launch the
kernels for a CUDA tensor and run their plain PyTorch versions for a CPU
tensor; nothing else decides between the two."""

from cyclegan_tpu_torch.ops import layout
from cyclegan_tpu_torch.ops.activations import apply_activation, leaky_relu
from cyclegan_tpu_torch.ops.conv import (
    conv2d,
    conv2d_reflect,
    conv2d_transpose,
)
from cyclegan_tpu_torch.ops.layout import concat_channels
from cyclegan_tpu_torch.ops.norm import instance_norm
from cyclegan_tpu_torch.ops.pad import reflection_pad2d
from cyclegan_tpu_torch.ops.pool import avg_pool2x2
from cyclegan_tpu_torch.ops.resize import resize_bilinear, upsample_concat

__all__ = [
    "apply_activation",
    "avg_pool2x2",
    "concat_channels",
    "conv2d",
    "conv2d_reflect",
    "conv2d_transpose",
    "instance_norm",
    "layout",
    "leaky_relu",
    "reflection_pad2d",
    "resize_bilinear",
    "upsample_concat",
]
