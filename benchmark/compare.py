"""The numbers that decide ``correct``, each a worst case over what the
timed path produced, and the arithmetic shared by the drivers.

Training (the first three steps, which set-up drives through the window's
own call): ``loss_gap``, the largest relative gap of a step's loss;
``grad_gap``, of a leaf's first-gradient norm; ``change_gap``, of a leaf's
change over the three steps. A leaf's gap is the gap between the
program's norm and the reference's, over the larger of the reference's
norm of that leaf and of the median leaf. Leaves whose reference gradient
is under a thousandth of the median leaf's move by round-off alone and
are left out of ``change_gap``.

Images (uint8 answers against the reference's): ``mean_step``, the mean
absolute gap in uint8 steps; ``far_share``, the share of values more than
``FAR_STEPS`` off; ``worst_step``, the largest gap.
"""

from __future__ import annotations

import math
import statistics
from typing import Dict, List, Mapping, Sequence

import numpy as np

FLAT_GRADIENT = 1e-3  # of the median leaf's gradient norm
FAR_STEPS = 8


def _gap(a: float, b: float, scale: float) -> float:
    if not (math.isfinite(a) and math.isfinite(b)) or scale <= 0:
        return math.inf
    return abs(a - b) / scale


def loss_gap(program: Sequence[Mapping[str, float]],
             reference: Sequence[Mapping[str, float]]) -> float:
    if len(program) != len(reference):
        return math.inf
    return max((_gap(p.get(k, math.nan), r[k], abs(r[k]))
                for p, r in zip(program, reference) for k in r),
               default=math.inf)


def leaf_gap(program: Mapping[str, float], reference: Mapping[str, float],
             keep: Sequence[str] = None) -> float:
    keys = list(reference) if keep is None else list(keep)
    return max(leaf_gaps(program, reference, keys)) if keys else math.inf


def moving_leaves(ref_grads: Mapping[str, float]) -> List[str]:
    median = statistics.median(ref_grads.values())
    return [k for k, v in ref_grads.items() if v >= FLAT_GRADIENT * median]


def leaf_gaps(program: Mapping[str, float], reference: Mapping[str, float],
              keys: Sequence[str]) -> List[float]:
    median = statistics.median(reference[k] for k in keys)
    return [_gap(program.get(k, math.nan), reference[k],
                 max(reference[k], median)) for k in keys]


def train_numbers(program: dict, reference: dict) -> Dict[str, float]:
    """program, reference: {"losses": [...], "grads": {...},
    "change": {...}} (``reference.step.train``'s three readings). Besides
    the worst cases, ``loss1_gap`` (the first step's losses alone) and
    the median leaf's gaps, which do not carry the later steps' or one
    small leaf's noise."""
    keep = moving_leaves(reference["grads"])
    changes = leaf_gaps(program["change"], reference["change"], keep)
    grads = leaf_gaps(program["grads"], reference["grads"],
                      list(reference["grads"]))
    return {
        "loss_gap": loss_gap(program["losses"], reference["losses"]),
        "loss1_gap": loss_gap(program["losses"][:1], reference["losses"][:1]),
        "grad_gap": max(grads),
        "grad_median_gap": statistics.median(grads),
        "change_gap": max(changes),
        "change_median_gap": statistics.median(changes),
    }


def worst_leaves(program: dict, reference: dict, key: str, n: int = 3):
    """The ``n`` leaves with the largest gaps of ``key`` ("grads" or
    "change"): (gap, leaf, program's norm, reference's norm)."""
    keys = list(reference[key])
    gaps = leaf_gaps(program[key], reference[key], keys)
    return sorted(zip(gaps, keys, [program[key].get(k) for k in keys],
                      [reference[key][k] for k in keys]), reverse=True)[:n]


def image_gaps(program: Sequence[np.ndarray],
               reference: Sequence[np.ndarray]) -> Dict[str, float]:
    """Gaps of uint8 answers, compared whole; a missing or misshapen
    answer reads as infinitely far."""
    if len(program) != len(reference) or not program:
        return {"mean_step": math.inf, "far_share": math.inf,
                "worst_step": math.inf}
    total = far = 0
    count = 0
    worst = 0
    for p, r in zip(program, reference):
        if p is None or p.shape != r.shape:
            return {"mean_step": math.inf, "far_share": math.inf,
                    "worst_step": math.inf}
        d = np.abs(p.astype(np.int16) - r.astype(np.int16))
        total += int(d.sum())
        far += int((d > FAR_STEPS).sum())
        worst = max(worst, int(d.max()))
        count += d.size
    return {"mean_step": total / count, "far_share": far / count,
            "worst_step": float(worst)}


def checks(numbers: Mapping[str, float], limits: Mapping[str, float]
           ) -> Dict[str, Dict[str, float]]:
    """The numbers the cell holds to a limit, each beside it; the others
    are readings only."""
    return {k: {"value": v, "limit": float(limits[k])}
            for k, v in numbers.items() if k in limits}
