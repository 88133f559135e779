"""Streaming metric accumulators (cyclegan_tpu/utils/metrics.py; the
reference's tf.keras.metrics.Mean)."""

from typing import Dict, Iterable


class Mean:
    """Running mean over update_state calls, reset per epoch."""

    def __init__(self, name: str = "mean"):
        self.name = name
        self._total = 0.0
        self._count = 0

    def update_state(self, value) -> None:
        self._total += float(value)
        self._count += 1

    def result(self) -> float:
        return self._total / self._count if self._count else 0.0

    def reset_states(self) -> None:
        self._total = 0.0
        self._count = 0


def make_metric_dict(names: Iterable[str]) -> Dict[str, Mean]:
    """One Mean per metric name, as the reference keeps per split."""
    return {name: Mean(name) for name in names}
