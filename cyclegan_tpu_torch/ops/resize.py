"""The up-path junction on NHCW activations (cyclegan_tpu/ops/resize.py
``upsample_concat``): K4 or its plain version by the tensor's device
(``ops/cuda_concat.py``)."""

from __future__ import annotations

import torch

from cyclegan_tpu_torch.ops.cuda_concat import concat_up2_nhcw


def upsample_concat(skip: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """concat over channels of (skip, nearest-2x upsample of x)."""
    return concat_up2_nhcw(skip, x)
