"""2x2 average pool, stride 2, VALID (cyclegan_tpu/ops/pool.py
``avg_pool2x2``). NHCW: K3 (forward) and K7 (backward) or their plain
versions by the tensor's device (``ops/cuda_resize.py``). NHWC: the
library's ``avg_pool2d`` on the channels_last view, which sums the window
in f32 and scales by 1/4 as the JAX package's ``reduce_window`` does."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from cyclegan_tpu_torch.ops import layout
from cyclegan_tpu_torch.ops.cuda_resize import avg_pool2x2_nhcw


def avg_pool2x2(x: torch.Tensor) -> torch.Tensor:
    if layout.is_nhcw():
        return avg_pool2x2_nhcw(x)
    return F.avg_pool2d(x.permute(0, 3, 1, 2), 2).permute(0, 2, 3, 1) \
        .contiguous()
