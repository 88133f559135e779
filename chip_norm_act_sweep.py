#!/usr/bin/env python3
"""Variants of the instance norm kernels K2 and K6 on one NVIDIA GPU.

    python3 chip_norm_act_sweep.py --work DIR [--only NAME ...]

from the root of the repository, on a machine with a CUDA card and nvcc.
For each variant it copies ``chip_smoke.py``, this script and
``cyclegan_tpu_torch/`` (with only the instance norm kernels' sources)
into DIR/<variant>, changes the kernels' constants there, and runs
``python3 chip_norm_act_sweep.py --run`` in that copy, in its own process:
it builds the kernels (ptxas' register report), holds K2 and K6 against
their plain versions at every unique launch shape of the four recipes'
batch-8 256x256 train steps and at ``chip_smoke.EDGE_NORM_SHAPES``
(``chip_smoke.check_kernels``), times them (``chip_smoke.time_kernels``)
and prints, per recipe, each kernel's time summed over the step's
launches beside its bound. The ``base`` run also times PyTorch's own
elementwise kernels at each launch shape as a yardstick: ``copy_`` moves
K2's bytes and ``add`` K6's, with no reduction. DIR is filled with the
copies; give a directory that ``.gitignore`` lists.

Variants (``VARIANTS``): ``base``, the committed constants;
``k2_unbounded``, K2 without its four-CTAs-per-SM register bound;
``slots8``, eight slots of each operand a thread; ``threads512``,
512-thread CTAs; ``no_exchange``, the cluster exchange of partial sums
left out, which gives wrong sums (its check fails, by design) and
measures what the exchange costs.
"""

from __future__ import annotations

import argparse
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
CSRC = "cyclegan_tpu_torch/kernels/csrc"
PY = "cyclegan_tpu_torch/ops/cuda_norm_act.py"
NAMES = ("instance_norm_act", "instance_norm_act_bwd")
RECIPES = {"unet_train": "model_instances/converged256/model_config.yaml",
           "resnet_train": "configs/resnet.yaml",
           "unet_transpose_train": "configs/unet_transpose.yaml",
           "strided_train": "configs/strided_unet.yaml"}

# variant: [(file, old text, new text)], each old text required
_CONSTS = "NA_THREADS, NA_SLOTS, NA_MAX_CLUSTER = 256, 4, 8"
VARIANTS = {
    "base": [],
    "k2_unbounded": [(f"{CSRC}/norm_act.cu", "constexpr int MIN_BLOCKS = 4;",
                      "constexpr int MIN_BLOCKS = 1;")],
    "slots8": [(f"{CSRC}/norm_act.cuh", "constexpr int SLOTS = 4;",
                "constexpr int SLOTS = 8;"),
               (PY, _CONSTS, _CONSTS.replace("256, 4, 8", "256, 8, 8"))],
    "threads512": [(f"{CSRC}/norm_act.cuh", "constexpr int THREADS = 256;",
                    "constexpr int THREADS = 512;"),
                   (f"{CSRC}/norm_act.cu", "constexpr int MIN_BLOCKS = 4;",
                    "constexpr int MIN_BLOCKS = 2;"),
                   (PY, _CONSTS, _CONSTS.replace("256, 4, 8", "512, 4, 8"))],
    "no_exchange": [
        (f"{CSRC}/norm_act.cuh", "  if (cluster > 1) {  // one plane per CTA",
         "  if (false) {"),
        (f"{CSRC}/norm_act.cu", "  if (cluster > 1) na::cluster_arrive();",
         ""),
        (f"{CSRC}/norm_act.cu", "  if (cluster > 1) na::cluster_wait();", ""),
        (f"{CSRC}/norm_act_bwd.cu",
         "  if (cluster > 1) na::cluster_arrive();", ""),
        (f"{CSRC}/norm_act_bwd.cu", "  if (cluster > 1) na::cluster_wait();",
         "")],
}
EXPECTED_TO_FAIL = ("no_exchange",)


def make_copy(work: Path, name: str, variants=None, keep="norm_act",
              script=__file__) -> Path:
    """DIR/<name>: the files a run needs, with the variant's edits (from
    ``variants``, by default this script's) and only the CUDA sources whose
    names start with ``keep``; ``script`` is the sweep that runs it."""
    variants = VARIANTS if variants is None else variants
    d = work / name
    shutil.rmtree(d, ignore_errors=True)
    d.mkdir(parents=True)
    for f in {"chip_smoke.py", Path(__file__).name, Path(script).name}:
        shutil.copy(ROOT / f, d / f)
    shutil.copytree(ROOT / "cyclegan_tpu_torch", d / "cyclegan_tpu_torch",
                    ignore=shutil.ignore_patterns("build", "__pycache__"))
    for link in ("configs", "model_instances"):
        (d / link).symlink_to(ROOT / link)
    for src in (d / CSRC).glob("*.cu"):
        if not src.name.startswith(keep):
            src.unlink()
    for rel, old, new in variants[name]:
        text = (d / rel).read_text()
        if old not in text:
            raise RuntimeError(f"{name}: {old!r} not in {rel}")
        (d / rel).write_text(text.replace(old, new))
    return d


def run_here(yardstick: bool) -> int:
    """One variant, in its copy: build, check, time, summarise; with
    ``yardstick``, time PyTorch's copy_ and add at each shape too."""
    import torch

    import chip_smoke as cs
    from cyclegan_tpu_torch.config import yaml2namespace
    from cyclegan_tpu_torch.kernels import _build

    print(cs.smi_line(), flush=True)
    build = _build.build_dir()
    for log in sorted(build.glob("norm_act*.log")):
        for line in log.read_text().splitlines():
            if "registers" in line or "spill" in line:
                print(f"ptxas {log.stem}: {line.strip()}")
    paths = {}
    for path, cfg in RECIPES.items():
        plan = (cs.resnet_train_launches if path == "resnet_train"
                else cs.train_launches)(yaml2namespace(cfg), 8, 256)
        paths[path] = {k: v for k, v in cs.unique_shapes(plan).items()
                       if k in NAMES}
    with cs.no_tf32():
        cs.check_kernels(cs.union_shapes(paths))
        cs.check_kernels(cs.unique_shapes(cs.EDGE_NORM_SHAPES), "edge ")
        rows = cs.time_kernels(paths)
    for path in paths:
        for name in NAMES:
            used = [(r, r["per_step"][path]) for r in rows
                    if r["kernel"] == name and r["per_step"][path]]
            ms = sum(r["ms"] * n for r, n in used)
            bound = sum(r["bound_ms"] * n for r, n in used)
            print(f"sum {path} {name} ms {ms:.4f} bound {bound:.4f} "
                  f"share {bound / ms:.4f}", flush=True)
    if yardstick:
        for b, h, c in sorted({s[:3] for s in cs.union_shapes(
                paths)["instance_norm_act"]}):
            x = torch.randn(b, h, c, h, device="cuda").bfloat16()
            g = torch.randn_like(x)
            y = torch.empty_like(x)
            nbytes = x.numel() * 2
            copy_ms = cs.time_ms(lambda: y.copy_(x))
            add_ms = cs.time_ms(lambda: torch.add(x, g, out=y))
            bound = nbytes / cs.HBM_BYTES_PER_S * 1e3
            print(f"yardstick {(b, h, c)} copy_ {copy_ms:.4f} ms "
                  f"({2 * bound / copy_ms:.3f} of its bound) add "
                  f"{add_ms:.4f} ms ({3 * bound / add_ms:.3f})", flush=True)
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
    parser.add_argument("--yardstick", action="store_true",
                        help="with --run: time copy_ and add as well")
    args = parser.parse_args(argv)
    if args.run:
        return run_here(args.yardstick)
    if args.work is None:
        parser.error("--work is required")
    return run_variants(args.work, args.only or VARIANTS, make_copy,
                        EXPECTED_TO_FAIL, __file__,
                        lambda name: ["--yardstick"] if name == "base" else [])


def run_variants(work: Path, names, copy, expected_to_fail, script,
                 flags=lambda name: []) -> int:
    """Each variant of ``names`` in its copy (``copy(work, name)``), by
    ``script --run`` plus ``flags(name)`` in its own process; prints the
    summary lines of each run and returns 1 if a variant not expected to
    fail did."""
    failed = []
    for name in names:
        d = copy(work.resolve(), name)
        print(f"=== {name}", flush=True)
        try:
            proc = subprocess.run(
                [sys.executable, Path(script).name, "--run", *flags(name)],
                cwd=d, capture_output=True, text=True, timeout=300)
            out, rc = proc.stdout + proc.stderr, proc.returncode
        except subprocess.TimeoutExpired as err:
            out, rc = f"{err.stdout or ''}\ntimed out", -1
        (d / "run.log").write_text(out)
        for line in out.splitlines():
            if line.startswith(("sum ", "time ", "yardstick", "ptxas",
                                "failures", "check", "Traceback")) \
                    or "rror" in line:
                print(f"{name}: {line}", flush=True)
        if rc != 0 and name not in expected_to_fail:
            failed.append(name)
        print(f"{name}: exit {rc}", flush=True)
    print(f"variants failed: {failed}")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
