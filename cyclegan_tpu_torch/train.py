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
unused, as in the JAX CLI.

Parallelism: one process per device, each running this CLI with the same
flags. ``--distributed`` joins the group a launcher describes in the
environment (``torchrun --nproc_per_node N -m cyclegan_tpu_torch.train
--distributed ...``); ``--coordinator host:port --num_processes N
--process_id r`` joins it explicitly. NCCL on cards, gloo with
``--device cpu``; rank r binds ``cuda:(local_rank % device_count)``. The
mesh is JAX's: ``--num_devices`` (-1: the world size) split into
``--spatial_devices`` strips of each image and ``num_devices /
spatial_devices`` data ranks, and ``--dp_shard_map`` sets the train
config's ``dp_shard_map``. The train config's ``batch_size`` is what each
data rank is fed (its slice of a global batch ``batch_size`` x data
ranks); the spatial ranks of one data rank load the same images.
"""

from __future__ import annotations

import logging
from argparse import ArgumentParser
from pathlib import Path
from typing import Optional, Sequence

import torch.distributed as dist

from cyclegan_tpu_torch.config import yaml2namespace
from cyclegan_tpu_torch.data.pipeline import create_dataset
from cyclegan_tpu_torch.data.streaming import create_streaming_dataset
from cyclegan_tpu_torch.parallel import (
    create_mesh,
    create_spatial_mesh,
    init_distributed,
)
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
                        help="Devices (processes) in the mesh (-1 = the "
                        "world size; 1 without a process group).")
    parser.add_argument("--spatial_devices", type=int, default=1,
                        help="Shard each image's H axis over this many "
                        "ranks; the remaining num_devices/spatial_devices "
                        "stay data-parallel.")
    parser.add_argument("--dp_shard_map", action="store_true",
                        help="The JAX package's explicit per-shard path: "
                        "per-data-shard batch-norm statistics and random "
                        "streams; needed to combine --spatial_devices with "
                        "the kernels (tpu_layout).")
    parser.add_argument("--distributed", action="store_true",
                        help="Join the process group the launcher's "
                        "environment describes (env://, as torchrun sets).")
    parser.add_argument("--coordinator", default=None,
                        help="host:port of rank 0 (tcp://), with "
                        "--num_processes and --process_id")
    parser.add_argument("--num_processes", type=int, default=None)
    parser.add_argument("--process_id", type=int, default=None)
    return parser.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None):
    """Train as the flags say; returns the ``CycleGan`` after training."""
    args = parse_arguments(argv)
    logging.basicConfig(level=logging.INFO)
    device, mesh = args.device, None
    if args.distributed or args.coordinator:
        device = init_distributed(args.device, args.coordinator,
                                  args.num_processes, args.process_id)
        num_devices = (args.num_devices if args.num_devices > 0
                       else dist.get_world_size())
        if num_devices % args.spatial_devices != 0:
            raise SystemExit(
                f"--num_devices {num_devices} must be a multiple of "
                f"--spatial_devices {args.spatial_devices}")
        if args.spatial_devices > 1:
            mesh = create_spatial_mesh(
                data=num_devices // args.spatial_devices,
                spatial=args.spatial_devices)
        else:
            mesh = create_mesh(num_devices)
        logger.info("rank %d of %d on %s, %s backend, mesh %s",
                    dist.get_rank(), dist.get_world_size(), device,
                    dist.get_backend(), mesh.shape)
    elif args.num_devices not in (1, -1) or args.spatial_devices > 1:
        raise SystemExit(
            f"--num_devices {args.num_devices} --spatial_devices "
            f"{args.spatial_devices}: one process is one device; start one "
            f"process per device with --distributed (a launcher's "
            f"environment) or --coordinator")

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
    if args.dp_shard_map:
        training_config.dp_shard_map = True
    gan = CycleGan(model_config, training_config, mesh=mesh, device=device)

    records_a = sorted(map(str, (args.data_dir / "tabby_records")
                           .glob("*.tfrecords")))
    records_b = sorted(map(str, (args.data_dir / "tortie_records")
                           .glob("*.tfrecords")))
    # each data rank feeds its disjoint slice of every global batch; the
    # spatial ranks of one data rank load the same images
    train_ds, val_ds = dataset_fn(
        records_a=records_a, records_b=records_b,
        width=int(training_config.image_size),
        seed=int(model_config.get("seed", 0)),
        process_index=0 if mesh is None else mesh.index("data"),
        process_count=1 if mesh is None else mesh.axis_size("data"))
    logger.info("device %s, %s loader: %d train and %d validation pairs",
                device, loader, len(train_ds), len(val_ds))
    try:
        gan.train(train_dataset=train_ds, validation_dataset=val_ds)
    finally:
        if mesh is not None:
            dist.destroy_process_group()
    return gan


if __name__ == "__main__":
    main()
