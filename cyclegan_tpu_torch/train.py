"""Training CLI of the port (the counterpart of the JAX package's
``train.py``):

    python -m cyclegan_tpu_torch.train --model_config configs/cycle.yaml \\
        --train_config configs/training_config.yaml --data_dir data \\
        [--device cuda|cpu]

from the root of the repository. ``--data_dir`` holds ``tabby_records/``
and ``tortie_records/`` of ``*.tfrecords`` shards; the train config's
``data_loader`` picks the loader, ``memory`` (the default: every image
decoded up front) or ``streaming`` (decoded per batch,
``data/streaming.py``). The flags are the JAX
CLI's plus ``--device``, which defaults to ``cuda`` and raises without a
card (``cpu`` runs the kernels' plain versions). ``--vram`` is accepted and
unused, as in the JAX CLI. One device only: ``--num_devices`` other than 1
or -1, ``--spatial_devices`` > 1, ``--dp_shard_map``, ``--distributed`` and
``--coordinator`` raise until parallelism is ported (ROADMAP.md queue 1,
item 7).
"""

from __future__ import annotations

import logging
from argparse import ArgumentParser
from pathlib import Path
from typing import Optional, Sequence

from cyclegan_tpu_torch.config import yaml2namespace
from cyclegan_tpu_torch.data.pipeline import create_dataset
from cyclegan_tpu_torch.data.streaming import create_streaming_dataset
from cyclegan_tpu_torch.trainer import CycleGan

logger = logging.getLogger(__name__)


def parse_arguments(argv: Optional[Sequence[str]] = None):
    parser = ArgumentParser("Train cycle GAN")
    parser.add_argument("--model_config",
                        default=Path("configs", "cycle.yaml"),
                        help="Path to model config.")
    parser.add_argument("--train_config",
                        default=Path("configs", "training_config.yaml"),
                        help="Path to training config")
    parser.add_argument("--vram", type=int, default=20000,
                        help="Accepted for CLI parity; unused.")
    parser.add_argument("--data_dir", default=Path("data"), type=Path,
                        help="Directory containing tabby_records/ and "
                        "tortie_records/")
    parser.add_argument("--device", default="cuda",
                        help="cuda (the default; raises without a card) or "
                        "cpu (the kernels' plain versions)")
    parser.add_argument("--num_devices", type=int, default=-1,
                        help="Devices to train on: 1 (or -1, all, which is "
                        "one here).")
    parser.add_argument("--spatial_devices", type=int, default=1,
                        help="Not ported: must be 1.")
    parser.add_argument("--dp_shard_map", action="store_true",
                        help="Not ported.")
    parser.add_argument("--distributed", action="store_true",
                        help="Not ported.")
    parser.add_argument("--coordinator", default=None, help="Not ported.")
    parser.add_argument("--num_processes", type=int, default=None,
                        help="Read only with --coordinator (not ported).")
    parser.add_argument("--process_id", type=int, default=None,
                        help="Read only with --coordinator (not ported).")
    return parser.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None):
    """Train as the flags say; returns the ``CycleGan`` after training."""
    args = parse_arguments(argv)
    logging.basicConfig(level=logging.INFO)
    unported = []
    if args.num_devices not in (1, -1):
        unported.append(f"--num_devices {args.num_devices}")
    if args.spatial_devices > 1:
        unported.append(f"--spatial_devices {args.spatial_devices}")
    if args.dp_shard_map:
        unported.append("--dp_shard_map")
    if args.distributed or args.coordinator:
        unported.append("--distributed/--coordinator")
    if unported:
        raise NotImplementedError(
            f"{', '.join(unported)}: the port trains on one device; "
            f"parallelism is not ported yet (ROADMAP.md queue 1, item 7)")

    model_config = yaml2namespace(args.model_config)
    training_config = yaml2namespace(args.train_config)
    loader = str(training_config.get("data_loader", "memory"))
    if loader == "streaming":
        dataset_fn = create_streaming_dataset
    elif loader == "memory":
        dataset_fn = create_dataset
    else:
        raise ValueError(f"unknown data_loader {loader!r} "
                         "(expected 'memory' or 'streaming')")
    gan = CycleGan(model_config, training_config, device=args.device)

    records_a = sorted(map(str, (args.data_dir / "tabby_records")
                           .glob("*.tfrecords")))
    records_b = sorted(map(str, (args.data_dir / "tortie_records")
                           .glob("*.tfrecords")))
    train_ds, val_ds = dataset_fn(
        records_a=records_a, records_b=records_b,
        width=int(training_config.image_size),
        seed=int(model_config.get("seed", 0)))
    logger.info("device %s, %s loader: %d train and %d validation pairs",
                args.device, loader, len(train_ds), len(val_ds))
    gan.train(train_dataset=train_ds, validation_dataset=val_ds)
    return gan


if __name__ == "__main__":
    main()
