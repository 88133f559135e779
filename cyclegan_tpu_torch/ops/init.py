"""Weight initializers matching the JAX package's distributions
(cyclegan_tpu/ops/init.py), drawn from an explicit ``torch.Generator``.

The two frameworks draw different numbers from the same seed; tests that
compare them make the weights with numpy and carry them across
(``cyclegan_tpu_torch.weights``).
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch


def normal_002(shape: Sequence[int],
               generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """N(0, 0.02), the CycleGAN conv initializer."""
    return 0.02 * torch.randn(tuple(shape), generator=generator)


def glorot_uniform(shape: Sequence[int],
                   generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Keras' default glorot_uniform for HWIO conv kernels."""
    fan_in = shape[0] * shape[1] * shape[2]
    fan_out = shape[0] * shape[1] * shape[3]
    limit = math.sqrt(6.0 / (fan_in + fan_out))
    u = torch.rand(tuple(shape), generator=generator)
    return (2.0 * u - 1.0) * limit
