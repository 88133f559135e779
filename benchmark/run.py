"""Run one cell of the benchmark once.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout. The cell (``BENCHMARK.json``) names a
configuration and a traffic mix; the traffic's ``driver`` (``drivers/``)
sets the program up from the seed, measures for ``--seconds`` and checks
what the timed path produced against the plain reference. With
``--trace 0`` the last line of standard output is the cell's end-to-end
metrics, with ``--trace 1`` its per-layer metrics, read from a traced
stretch after the window. The numbers that decide ``correct`` are printed
beside their limits as the last lines of standard error and, under
``checks``, as the last key of the result.

Without a CUDA card, with fewer cards than the cell asks for, without the
program in the checkout, or with JAX or the JAX package loaded when the
window has closed, it prints no result and exits with a code other
than 0.
"""

from __future__ import annotations

import time

START = time.perf_counter()  # before torch is imported: set-up starts here

import argparse  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

from benchmark import spec  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "cyclegan_tpu")
PROGRAM = "cyclegan_tpu_torch"
# build and kernel caches of anything the run loads, inside the checkout
CACHE_DIRS = {"TRITON_CACHE_DIR": "triton",
              "TORCH_EXTENSIONS_DIR": "torch_extensions"}
# one host thread for the CPU math libraries, so that the load is one
# process with few threads: on a shared host the program's default pool
# ran the U-Net train cell faster but spread its rate three times as
# wide from run to run (PERF.md)
THREAD_VARS = ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS")
EXIT_NO_CARD, EXIT_NO_PROGRAM, EXIT_FORBIDDEN = 3, 4, 5


def forbidden_modules() -> list:
    """Top-level names in ``sys.modules`` that belong to JAX or the JAX
    package, compared whole."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def fail(code: int, message: str) -> None:
    print(f"benchmark: {message}", file=sys.stderr, flush=True)
    sys.exit(code)


def _program_in_checkout() -> bool:
    found = importlib.util.find_spec(PROGRAM)
    return (found is not None and found.origin is not None
            and Path(found.origin).resolve().is_relative_to(spec.ROOT))


def device_info(chips: int) -> dict:
    import torch

    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": chips}


def card_limits() -> str:
    """The card's name and power limit as nvidia-smi reads them."""
    import subprocess

    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip() or out.stderr.strip()
    except (OSError, subprocess.SubprocessError) as exc:
        return f"nvidia-smi: {exc}"


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    for var, sub in CACHE_DIRS.items():
        os.environ[var] = str(spec.ROOT / ".bench_cache" / sub)
    for var in THREAD_VARS:
        os.environ[var] = "1"
    cell = spec.cell(args.workload)
    if not _program_in_checkout():
        fail(EXIT_NO_PROGRAM, f"the program {PROGRAM} is not in the "
             f"checkout {spec.ROOT}")
    import torch

    if not torch.cuda.is_available():
        fail(EXIT_NO_CARD, "no CUDA device")
    if torch.cuda.device_count() < cell.chips:
        fail(EXIT_NO_CARD, f"{cell.name} needs {cell.chips} cards, "
             f"{torch.cuda.device_count()} visible")
    result = execute(cell, args.seed, args.seconds, bool(args.trace),
                     device="cuda")
    # after the window, so that nvidia-smi's start-up is not set-up
    print(f"card: {card_limits()}; host cores {os.cpu_count()}, usable "
          f"{len(os.sched_getaffinity(0))}, torch threads "
          f"{torch.get_num_threads()}", flush=True)
    found = forbidden_modules()
    if found:
        fail(EXIT_FORBIDDEN, f"modules of JAX or the JAX package were "
             f"loaded: {found}")
    result["device"] = {**device_info(cell.chips), **result["device"]}
    emit(result)
    return 0


def execute(cell: spec.Cell, seed: int, seconds: float, trace: bool,
            device: str, start: float = None) -> dict:
    """Drive the cell once and assemble the result (without the card's
    name, which ``main`` adds): the driver's numbers, the metrics the
    cell reports and the checks."""
    driver = importlib.import_module(f"benchmark.drivers."
                                     f"{cell.traffic['driver']}")
    out = driver.run(cell, seed=seed, seconds=seconds, trace=trace,
                     device=device, start=START if start is None else start)
    if trace:
        metrics = {}
        for m in cell.per_layer:
            value = spec.metric_reader(m["name"])(out["records"])
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        missing = [m["name"] for m in cell.end_to_end
                   if m["name"] not in out["end_to_end"]]
        if missing:
            raise RuntimeError(f"{cell.name}: the driver reported no "
                               f"{missing}")
        metrics = {m["name"]: {"value": out["end_to_end"][m["name"]],
                               "unit": m["unit"]} for m in cell.end_to_end}
    checks = out["checks"]
    correct = bool(checks) and all(
        math.isfinite(c["value"]) and c["value"] <= c["limit"]
        for c in checks.values())
    result = {"correct": correct, "attempted": out["attempted"],
              "failed": out["failed"], "metrics": metrics,
              "device": out["device"]}
    if trace:
        tr = out["records"]["trace"]
        result["device"].update(busy_s=tr["busy_s"], window_s=tr["window_s"])
        result["breakdown"] = {"device_ops": [list(x) for x in
                                              tr["device_ops"]],
                               "idle_gaps": [list(x) for x in
                                             tr["idle_gaps"]]}
    result["checks"] = checks
    return result


def _finite(value):
    return value if math.isfinite(value) else str(value)


def emit(result: dict) -> None:
    """The checks as the last lines of standard error, the result as the
    last line of standard output."""
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    result["checks"] = {k: {"value": _finite(c["value"]),
                            "limit": c["limit"]}
                        for k, c in result["checks"].items()}
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    sys.exit(main())
