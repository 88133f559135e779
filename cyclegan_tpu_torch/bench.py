"""Train-step throughput of the port (the counterpart of the JAX package's
``bench.py``), in images per second on one card.

    python -m cyclegan_tpu_torch.bench [--batch 8] [--image-size 256]
        [--steps 30] [--warmup 5] [--dtype bfloat16|float32]
        [--model_config configs/cycle.yaml] [--device cuda|cpu]
        [--layout nhcw|nhwc] [--pallas] [--remat] [--paired] [--fuse-apps]

from the root of the repository. It builds the four networks and their
optimizers from ``--model_config`` and ``configs/training_config.yaml``
(random weights from seed 0), feeds seeded uint8 noise through the jitter
inside every step, and times ``--steps`` steps after ``--warmup`` on the
host clock between two ``torch.cuda.synchronize()``. It prints one JSON
line: ``metric``, ``value``, ``unit`` (images/sec/chip), the device's name,
the layout and the mean step time. ``--layout nhcw`` (the default) is the
kernel path K1-K12; ``--layout nhwc`` the library convolutions, with
``--pallas`` every instance norm on K13 (the JAX bench's flags).
``--remat``, ``--paired`` and ``--fuse-apps`` are the step's options
(``steps.make_train_step``); ``--paired`` runs NHWC whatever ``--layout``
says, as the JAX bench forces it.
``--device`` defaults to ``cuda`` and the run raises where there is no
card; ``--device cpu`` runs the kernels' plain versions on the CPU (a check
that the path runs, not a device number).
"""

from __future__ import annotations

import argparse
import json
import time
from typing import Any, Dict, Optional, Sequence

import torch

from cyclegan_tpu_torch.config import yaml2namespace
from cyclegan_tpu_torch.data.augment import random_jitter_batch
from cyclegan_tpu_torch.steps import (
    build_models,
    init_train_state,
    make_train_step,
)

TRAIN_CONFIG = "configs/training_config.yaml"


def build(batch: int, image_size: int, dtype: str, model_config_path: str,
          device: str, seed: int = 0, tpu_layout: bool = True,
          pallas_norm: bool = False, **options):
    """(train_step, state, real_a, real_b): the recipe's step with the
    jitter inside it (``options``: remat, paired, fuse_apps), and one
    seeded uint8 batch per domain on ``device``."""
    model_config = yaml2namespace(model_config_path)
    state = init_train_state(build_models(model_config, seed),
                             yaml2namespace(TRAIN_CONFIG), seed, device)

    def preprocess(generator, a, b):
        return (random_jitter_batch(generator, a, image_size),
                random_jitter_batch(generator, b, image_size))

    step = make_train_step(model_config.loss, model_config.loss_weights,
                           dtype, preprocess, tpu_layout=tpu_layout,
                           pallas_norm=pallas_norm, **options)
    noise = torch.Generator(device=device).manual_seed(seed)
    shape = (batch, image_size, image_size, 3)
    real_a, real_b = (torch.randint(0, 256, shape, generator=noise,
                                    dtype=torch.uint8, device=device)
                      for _ in range(2))
    return step, state, real_a, real_b


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, Any]:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--batch", type=int, default=8)
    parser.add_argument("--image-size", type=int, default=256)
    parser.add_argument("--steps", type=int, default=30)
    parser.add_argument("--warmup", type=int, default=5)
    parser.add_argument("--dtype", default="bfloat16",
                        choices=["float32", "bfloat16"],
                        help="compute dtype of the networks (parameters "
                        "stay f32, losses are f32)")
    parser.add_argument("--model_config", default="configs/cycle.yaml")
    parser.add_argument("--layout", default="nhcw", choices=["nhcw", "nhwc"],
                        help="activation layout of the step: nhcw (the "
                        "kernels K1-K12) or nhwc (library convolutions)")
    parser.add_argument("--pallas", action="store_true",
                        help="with --layout nhwc, every instance norm on "
                        "K13")
    parser.add_argument("--remat", action="store_true",
                        help="recompute the generator forwards in the "
                        "backward (less memory)")
    parser.add_argument("--paired", action="store_true",
                        help="vmap each twin pair of networks over stacked "
                        "parameters (runs NHWC)")
    parser.add_argument("--fuse-apps", action="store_true",
                        help="each generator's translation and identity "
                        "applications as one at batch 2N")
    parser.add_argument("--device", default="cuda",
                        help="cuda (the default; raises without a card) or "
                        "cpu (the kernels' plain versions)")
    args = parser.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("bench: no CUDA device; pass --device cpu to run "
                           "on the CPU")

    layout = "nhwc" if args.paired else args.layout
    step, state, real_a, real_b = build(
        args.batch, args.image_size, args.dtype, args.model_config,
        args.device, tpu_layout=layout == "nhcw", pallas_norm=args.pallas,
        remat=args.remat, paired=args.paired, fuse_apps=args.fuse_apps)
    for _ in range(args.warmup):
        step(state, real_a, real_b)
    _sync(device)
    start = time.perf_counter()
    for _ in range(args.steps):
        metrics = step(state, real_a, real_b)
    _sync(device)
    seconds = (time.perf_counter() - start) / max(args.steps, 1)
    result = {
        "metric": f"train_images_per_sec_{args.image_size}px_b{args.batch}_"
                  f"{args.dtype}",
        "layout": layout, "pallas_norm": args.pallas,
        "remat": args.remat, "paired": args.paired,
        "fuse_apps": args.fuse_apps,
        "value": args.batch / seconds,
        "unit": "images/sec/chip",
        "device": (torch.cuda.get_device_name(device)
                   if device.type == "cuda" else "cpu"),
        "step_ms": seconds * 1e3,
        "gAB_loss": float(metrics["gAB_loss"]) if args.steps else None,
    }
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
