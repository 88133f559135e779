"""Each cell of BENCHMARK.json run for a few seconds on the card, its last
line checked against the contract. Marked ``card``: it looks for a card
inside the test and skips where there is none.

    python3 -m pytest benchmark/tests -m card
"""

import json
import math
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]


def run_cell(cell: str, trace: int) -> dict:
    proc = subprocess.run(
        [sys.executable, "-m", "benchmark.run", "--workload", cell,
         "--seed", str(2**31 + 17), "--seconds", "3", "--trace", str(trace)],
        cwd=ROOT, capture_output=True, text=True, timeout=1200)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")


@pytest.mark.card
@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", CELLS)
def test_cell_last_line(card, cell, trace):
    out = run_cell(cell, trace)
    assert list(out)[-1] == "checks"
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(out)
    assert out["correct"] is True, out["checks"]
    device = out["device"]
    assert device["platform"] == "gpu" and device["count"] == 1
    assert device["memory_peak_bytes"] > 0
    group = "per_layer" if trace else "end_to_end"
    want = {m["name"] for m in BENCH[group]
            if cell in m.get("workloads", CELLS)}
    assert set(out["metrics"]) == want
    for m in out["metrics"].values():
        assert math.isfinite(m["value"]) and m["value"] != 0
    if trace:
        assert 0 < device["busy_s"] <= device["window_s"]
        assert len(out["breakdown"]["device_ops"]) <= 10
        for name, m in out["metrics"].items():
            if "roofline" in name or "mfu" in name:
                assert 0 < m["value"] <= 100
