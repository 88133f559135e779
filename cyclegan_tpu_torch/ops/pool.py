"""2x2 average pool, stride 2, VALID (cyclegan_tpu/ops/pool.py
``avg_pool2x2``). NHCW: K3 (forward) and K7 (backward) or their plain
versions by the tensor's device (``ops/cuda_resize.py``). NHWC: the
library's ``avg_pool2d`` on the channels_last view, which sums the window
in f32 and scales by 1/4 as the JAX package's ``reduce_window`` does.
Under an H-sharded scope (``ops/spatialctx.py``) the windows stay within
each strip where its height is even, so the pool needs no halo; an odd
strip raises."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from cyclegan_tpu_torch.ops import layout, spatialctx
from cyclegan_tpu_torch.ops.cuda_resize import avg_pool2x2_nhcw


def avg_pool2x2(x: torch.Tensor) -> torch.Tensor:
    if spatialctx.is_active() and x.shape[1] % 2:
        # an odd strip would pair rows across the strip boundary
        raise ValueError(
            f"2x2 pool on an odd local H shard ({x.shape[1]} rows): pick "
            f"a resolution/spatial-device count whose per-shard height "
            f"stays even through every pooling level")
    if layout.is_nhcw():
        return avg_pool2x2_nhcw(x)
    return F.avg_pool2d(x.permute(0, 3, 1, 2), 2).permute(0, 2, 3, 1) \
        .contiguous()
