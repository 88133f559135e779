"""The readings that the limits of ``correct`` are set from, for one cell,
on the chip at the cell's own size: the program's numbers on many seeds
(the lower readings), and the control's and each fault's on a few (the
upper readings). One process, so that set-up is paid once.

    python3 -m benchmark.calibrate --workload <cell> --seeds 1,2,...,12 \\
        --control-seeds 101,102,103

Prints one JSON line per seed and a summary: each number's largest
reading over the program's seeds and smallest over the control's and
each fault's. The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import importlib
import json
import sys
from collections import defaultdict

from benchmark import spec


def _ints(text: str) -> list:
    return [int(x) for x in text.split(",") if x]


def summarize(program: list, controls: dict) -> dict:
    out = {"program_max": {}, "controls_min": {}}
    for k in program[0]:
        out["program_max"][k] = max(r[k] for r in program)
    for name, rows in controls.items():
        out["controls_min"][name] = {k: min(r[k] for r in rows)
                                     for k in rows[0]}
    return out


def calibrate(cell, seeds, control_seeds, device="cuda") -> dict:
    driver = importlib.import_module(
        f"benchmark.drivers.{cell.traffic['driver']}")
    program, controls = [], defaultdict(list)
    for seed in seeds:
        numbers = driver.readings(cell, seed, device)
        program.append(numbers)
        print(json.dumps({"seed": seed, "program": numbers}), flush=True)
    for seed in control_seeds:
        for name, numbers in driver.controls(cell, seed, device).items():
            controls[name].append(numbers)
            print(json.dumps({"seed": seed, name: numbers}), flush=True)
    summary = summarize(program, controls) if program and controls else {}
    print(json.dumps({"summary": summary}), flush=True)
    return summary


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", type=_ints, default=[])
    parser.add_argument("--control-seeds", type=_ints, default=[])
    args = parser.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 3
    calibrate(spec.cell(args.workload), args.seeds, args.control_seeds)
    return 0


if __name__ == "__main__":
    sys.exit(main())
