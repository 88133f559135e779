"""TensorBoard summaries (cyclegan_tpu/utils/summary.py ``SummaryWriter``).

tensorboardX where it can be imported, with the JAX package's tags: the
dA/dB/gAB/gBA losses and accuracies per epoch, the sample images "A" and
"B" at step 0, "A2B_predictions" and "B2A_predictions" every few epochs.
Without tensorboardX every method does nothing, so training never fails on
observability.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

try:  # pragma: no cover - import guard
    from tensorboardX import SummaryWriter as _TBXWriter
except Exception:  # pragma: no cover
    _TBXWriter = None


class SummaryWriter:
    """Scalar and image event writer bound to one logdir (one for train/,
    one for validation/)."""

    def __init__(self, logdir: str):
        self.logdir = logdir
        self._writer: Optional[object] = (
            None if _TBXWriter is None else _TBXWriter(logdir))

    def scalar(self, tag: str, value: float, step: int) -> None:
        if self._writer is not None:
            self._writer.add_scalar(tag, float(value), step)

    def images(self, tag: str, images: np.ndarray, step: int,
               max_outputs: int = 8) -> None:
        """images: (N, H, W, C) floats in [0, 1]."""
        if self._writer is None:
            return
        batch = np.clip(np.asarray(images)[:max_outputs], 0.0, 1.0)
        self._writer.add_images(tag, batch, step, dataformats="NHWC")

    def flush(self) -> None:
        if self._writer is not None:
            self._writer.flush()

    def close(self) -> None:
        if self._writer is not None:
            self._writer.close()
