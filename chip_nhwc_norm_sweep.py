#!/usr/bin/env python3
"""Variants of the NHWC instance norm kernel K13 on one NVIDIA GPU.

    python3 chip_nhwc_norm_sweep.py --work DIR [--only NAME ...]

from the root of the repository, on a machine with a CUDA card and nvcc.
For each variant it copies ``chip_smoke.py``, this script,
``chip_norm_act_sweep.py`` (whose copy and run loop it shares) and
``cyclegan_tpu_torch/`` (with only K13's source) into DIR/<variant>,
changes the kernel's geometry constants there (in the CUDA source and in
``ops/cuda_norm.py``, which must agree), and runs ``python3
chip_nhwc_norm_sweep.py --run`` in that copy, in its own process: it
builds the kernel (ptxas' register report), holds it against its plain
version at every unique K13 launch of the NHWC train steps (batch 8,
256x256, ``chip_smoke.nhwc_train_launches``) and at
``chip_smoke.EDGE_NHWC_NORM_SHAPES`` (``chip_smoke.check_kernels``), times
it beside a ``copy_`` of each launch's bytes (``chip_smoke.time_kernels``)
and prints, per step, the kernel's time summed over the step's launches
beside its bound. DIR is filled with the copies; give a directory that
``.gitignore`` lists.

Variants (``VARIANTS``): ``base``, the committed constants; the others
change one constant of the geometry: the widest resident tile (``tile8``),
the largest cluster (``cluster8``, the portable size, with room for a
256x256 tile of one vector), the shared memory a CTA may hold (``smem96``:
at least two CTAs an SM), the CTA's threads (``threads512``) and the bytes
a CTA's cluster grows to (``target16``, ``target64``); ``split_all`` runs
every launch on the streamed two-launch design, the kernel's earlier
design; ``no_exchange``, ``no_load_store`` and ``empty`` leave out
the cluster's exchange of partial sums, the device-memory traffic of the
resident path and the whole kernel body, which gives wrong results (their
checks fail, by design) and measures what each part costs.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import chip_norm_act_sweep as sweep

CU = "cyclegan_tpu_torch/kernels/csrc/instance_norm_nhwc.cu"
PY = "cyclegan_tpu_torch/ops/cuda_norm.py"
NAME = "instance_norm_nhwc"
RECIPES = {"unet_train_nhwc": "model_instances/converged256/model_config.yaml",
           "resnet_train_nhwc": "configs/resnet.yaml"}


def _const(kind, name, old, new):
    """One constant's edit in the source (``kind`` "cu") or in Python."""
    if kind == "cu":
        decl = {"THREADS": "constexpr int THREADS = {};",
                "MAX_TILE": "constexpr int MAX_TILE = {};",
                "MAX_CLUSTER": "constexpr int MAX_CLUSTER = {};",
                "TARGET_BYTES": "constexpr long long TARGET_BYTES = {};",
                "SMEM_MAX": "constexpr long long SMEM_MAX = {};"}[name]
        return (CU, decl.format(old), decl.format(new))
    line = {"THREADS": "THREADS, MAX_TILE, MAX_CLUSTER = {}, 4, 16",
            "MAX_TILE": "THREADS, MAX_TILE, MAX_CLUSTER = 256, {}, 16",
            "MAX_CLUSTER": "THREADS, MAX_TILE, MAX_CLUSTER = 256, 4, {}",
            "TARGET_BYTES": "TARGET_BYTES, SMEM_MAX = {}, 160 << 10",
            "SMEM_MAX": "TARGET_BYTES, SMEM_MAX = 32 << 10, {}"}[name]
    return (PY, line.format(old), line.format(new))


def _both(name, old, new):
    return [_const("cu", name, old, new), _const("py", name, old, new)]


# variant: [(file, old text, new text)], each old text required
VARIANTS = {
    "base": [],
    "tile8": _both("MAX_TILE", 4, 8),
    "cluster8": _both("MAX_CLUSTER", 16, 8) + [
        _const("cu", "SMEM_MAX", "160 << 10", "200 << 10"),
        _const("py", "SMEM_MAX", "160 << 10", "200 << 10")],
    "smem96": _both("SMEM_MAX", "160 << 10", "96 << 10"),
    "threads512": _both("THREADS", 256, 512),
    "target16": _both("TARGET_BYTES", "32 << 10", "16 << 10"),
    "target64": _both("TARGET_BYTES", "32 << 10", "64 << 10"),
    # every launch on the streamed (two-launch) design, K13's earlier one
    "split_all": _both("SMEM_MAX", "160 << 10", "0"),
    # where the time goes, each result wrong by design (its check fails):
    # the cluster's exchange of partial sums left out; the copy of x into
    # shared memory and the stores of y left out; the whole body left out
    "no_exchange": [(CU, "  if (cluster > 1) {\n    na::cluster_arrive();",
                     "  if (false) {\n    na::cluster_arrive();"),
                    (CU, "  if (cluster > 1) cluster_arrive_relaxed();",
                     "  if (false) cluster_arrive_relaxed();"),
                    (CU, "  if (cluster > 1) na::cluster_wait();\n}",
                     "  if (false) na::cluster_wait();\n}")],
    "no_load_store": [
        (CU, "    cp_async16(buf + k * STEP, xs + k * stride);",
         "    if (eps < 0.f) cp_async16(buf + k * STEP, xs + k * stride);"),
        (CU, "    na::store<T, V>(ys + k * stride, o);",
         "    if (eps < 0.f) na::store<T, V>(ys + k * stride, o);")],
    "empty": [(CU, "  __shared__ Red red;\n",
               "  __shared__ Red red;\n  if (eps > 0.f) return;\n")],
}
EXPECTED_TO_FAIL = ("no_exchange", "no_load_store", "empty")


def make_copy(work: Path, name: str) -> Path:
    """DIR/<name>: the files a run needs, with the variant's edits."""
    return sweep.make_copy(work, name, VARIANTS, Path(CU).stem, __file__)


def run_here() -> int:
    """One variant, in its copy: build, check, time, summarise."""
    import chip_smoke as cs
    from cyclegan_tpu_torch.config import yaml2namespace
    from cyclegan_tpu_torch.kernels import _build

    print(cs.smi_line(), flush=True)
    build = _build.build_dir()
    for line in (build / f"{NAME}.log").read_text().splitlines():
        if "registers" in line or "spill" in line:
            print(f"ptxas {NAME}: {line.strip()}")
    paths = {path: cs.unique_shapes(cs.nhwc_train_launches(
        yaml2namespace(cfg), 8, 256)) for path, cfg in RECIPES.items()}
    with cs.no_tf32():
        cs.check_kernels(cs.union_shapes(paths))
        cs.check_kernels(cs.unique_shapes(cs.EDGE_NHWC_NORM_SHAPES), "edge ")
        rows = cs.time_kernels(paths)
    for path in paths:
        used = [(r, r["per_step"][path]) for r in rows if r["per_step"][path]]
        ms = sum(r["ms"] * n for r, n in used)
        copy = sum(r["copy_ms"] * n for r, n in used)
        bound = sum(r["bound_ms"] * n for r, n in used)
        print(f"sum {path} {NAME} ms {ms:.4f} copy {copy:.4f} bound "
              f"{bound:.4f} share {bound / ms:.4f}", flush=True)
    print(f"failures {len(cs.failures)}", flush=True)
    return 1 if cs.failures else 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--work", type=Path,
                        help="directory for the variants' copies")
    parser.add_argument("--only", nargs="*", default=None,
                        help="variants to run (default: all)")
    parser.add_argument("--run", action="store_true",
                        help="run one variant in the current copy")
    args = parser.parse_args(argv)
    if args.run:
        return run_here()
    if args.work is None:
        parser.error("--work is required")
    return sweep.run_variants(args.work, args.only or VARIANTS, make_copy,
                              EXPECTED_TO_FAIL, __file__)


if __name__ == "__main__":
    sys.exit(main())
