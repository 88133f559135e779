"""2x2 average pool, stride 2, on NHCW activations
(cyclegan_tpu/ops/pool.py ``avg_pool2x2``): K3 (forward) and K7
(backward) or their plain versions by the tensor's device
(``ops/cuda_resize.py``)."""

from __future__ import annotations

import torch

from cyclegan_tpu_torch.ops.cuda_resize import avg_pool2x2_nhcw


def avg_pool2x2(x: torch.Tensor) -> torch.Tensor:
    return avg_pool2x2_nhcw(x)
