"""The operations and bytes of the convolutions a cell needs, counted from
the plain reference's networks walked on the ``meta`` device at the cell's
shapes, so that no kernel the program adds or removes changes them.

For each convolution: its forward, its input gradient (dX) and its weight
gradient (dW), each 2 x multiply-adds operations (a transposed conv counts
the multiply-adds of its stride-2 adjoint, not the zeros of a dilated
input); bytes as each input read once and each output written once, at the
element size of the compute dtype. The least time of one is
max(operations / peak FLOP/s, bytes / peak bytes/s).
"""

from __future__ import annotations

import json
import math
from pathlib import Path
from typing import Dict, List, Optional, Sequence

import torch

from benchmark.reference import nets

PEAKS_FILE = Path(__file__).resolve().parent / "peaks.json"
ELEMENT_BYTES = {"bfloat16": 2, "float16": 2, "float32": 4}

# The train step's applications, as the model needs them: (network
# section, whether the input needs a gradient). Six generator
# applications and the discriminators on the two real and the two fake
# batches; the fakes carry the adversarial gradient back into the
# generators.
TRAIN_APPLICATIONS = (
    ("generator", False), ("generator", True),   # g_AB(a), g_BA(fake_b)
    ("generator", False), ("generator", True),   # g_BA(b), g_AB(fake_a)
    ("generator", False), ("generator", False),  # g_BA(a), g_AB(b)
    ("discriminator", False), ("discriminator", False),  # reals
    ("discriminator", True), ("discriminator", True),    # fakes
)


def conv_records(net_cfg: dict, batch: int, size: int) -> List[tuple]:
    """One record per convolution of one forward (``nets.Convs``)."""
    record: List[tuple] = []
    params = {k: torch.empty(s, device="meta")
              for k, s in nets.shapes_of(net_cfg).items()}
    x = torch.empty((batch, 3, size, size), device="meta")
    nets.forward(nets.Convs(record=record), net_cfg, params, x)
    return record


def conv_work(rec: tuple, element_bytes: int) -> Dict[str, float]:
    """Operations and bytes of one convolution's forward (the same for
    its dX and its dW)."""
    kind, x_shape, k, cout, y_shape = rec
    b, cin, h, w = x_shape
    if kind == "conv":
        macs = y_shape[0] * y_shape[2] * y_shape[3] * k * k * cin * cout
    else:  # transposed: every input pixel meets the whole kernel
        macs = b * h * w * k * k * cin * cout
    elements = math.prod(x_shape) + k * k * cin * cout + math.prod(y_shape)
    return {"ops": 2.0 * macs, "bytes": float(elements * element_bytes)}


def peaks(device_name: str) -> Optional[Dict[str, float]]:
    """The published dense peaks of the card, by a fragment of its name;
    None for a card the table does not hold."""
    table = json.loads(PEAKS_FILE.read_text())
    for entry in table["cards"]:
        if entry["match"] in device_name:
            return entry
    return None


def least_seconds(ops: float, nbytes: float, peak: Dict[str, float],
                  dtype: str) -> float:
    return max(ops / peak["flops"][dtype], nbytes / peak["bytes_per_s"])


def work(applications: Sequence[tuple], cfg: dict, batch: int, size: int,
         backward: bool) -> List[Dict[str, float]]:
    """Every convolution pass of ``applications`` ((section, input needs
    a gradient) pairs): forward, and with ``backward`` dW and dX (dX of an
    application's first convolution only where its input needs one)."""
    dtype = cfg["compute_dtype"]
    out = []
    for section, input_grad in applications:
        records = conv_records(cfg[section], batch, size)
        for i, rec in enumerate(records):
            w = conv_work(rec, ELEMENT_BYTES[dtype])
            passes = 1
            if backward:
                passes += 1 + (1 if (i > 0 or input_grad) else 0)
            out.extend([w] * passes)
    return out


def totals(passes: List[Dict[str, float]], peak: Optional[Dict[str, float]],
           dtype: str) -> Dict[str, Optional[float]]:
    """Operations, and the least seconds of the passes one by one (None
    without a peak)."""
    ops = sum(p["ops"] for p in passes)
    least = None if peak is None else sum(
        least_seconds(p["ops"], p["bytes"], peak, dtype) for p in passes)
    return {"ops": ops, "least_s": least}


def train_step(cfg: dict, peak) -> Dict[str, Optional[float]]:
    return totals(work(TRAIN_APPLICATIONS, cfg, int(cfg["batch_size"]),
                       int(cfg["image_size"]), backward=True), peak,
                  cfg["compute_dtype"])


def generator_forward(cfg: dict, batch: int, size: int, peak
                      ) -> Dict[str, Optional[float]]:
    return totals(work((("generator", False),), cfg, batch, size,
                       backward=False), peak, cfg["compute_dtype"])
