"""Offline evaluation: checkpoint + TFRecords -> validation metrics
(cyclegan_tpu/apps/evaluate.py ``evaluate``, ``evaluate_quality``,
``main``).

Runs the validate step (the six metrics the trainer logs: dA/dB loss,
gAB/gBA loss, dA/dB accuracy) over a dataset split and prints one JSON
line; with ``--quality`` also the FID-class statistics of the stylized
split against the real one (``utils/quality.py``).

    python -m cyclegan_tpu_torch.apps.evaluate --model_dir \\
        model_instances/converged256 --records_a data/tabby_records \\
        --records_b data/tortie_records --batch 8 --split val [--quality] \\
        [--device cpu]

``evaluate`` runs the validate step in NHWC (``tpu_layout`` False, the JAX
step's default), which launches no kernel; ``evaluate_quality`` stylizes
through the serving session, so in bf16 on the card it runs the NHCW
kernels.
"""

from __future__ import annotations

import argparse
import json
import logging
from pathlib import Path

import numpy as np
import torch

logger = logging.getLogger(__name__)


def _train_image_size(model_dir: Path) -> int:
    """The training config's image size beside the checkpoint, else 0."""
    from cyclegan_tpu_torch.config import yaml2namespace

    train_cfg = Path(model_dir) / "train_config.yaml"
    if train_cfg.exists():
        return int(yaml2namespace(train_cfg).image_size)
    return 0


def evaluate(model_dir: Path, records_a, records_b, batch: int = 8,
             split: str = "val", validation_split: float = 0.2,
             compute_dtype: str = "float32", device="cuda") -> dict:
    """The validate step's six metrics, averaged over the split's batches
    (the dataset split as the trainer makes it, from the model config's
    seed), with ``batches`` and ``split``."""
    from cyclegan_tpu_torch.apps.inference import InferenceSession
    from cyclegan_tpu_torch.data.augment import prepare_eval_batch
    from cyclegan_tpu_torch.data.pipeline import create_dataset
    from cyclegan_tpu_torch.steps import make_validate_step
    from cyclegan_tpu_torch.trainer import METRIC_NAMES
    from cyclegan_tpu_torch.utils.metrics import make_metric_dict

    session = InferenceSession(model_dir, device=device)
    width = (int(session.model_config.get("image_size", 0))
             or _train_image_size(model_dir) or 256)
    train_ds, val_ds = create_dataset(
        records_a, records_b, validation_split=validation_split,
        width=width, seed=int(session.model_config.get("seed", 0)))
    dataset = val_ds if split == "val" else train_ds

    validate_step = make_validate_step(
        session.model_config.loss, dict(session.model_config.loss_weights),
        compute_dtype=compute_dtype, preprocess=prepare_eval_batch,
        tpu_layout=False)
    metrics = make_metric_dict(METRIC_NAMES)
    pending = []
    for images_a, images_b in dataset.batches(batch, epoch=0):
        pending.append(validate_step(
            session.state, torch.from_numpy(images_a).to(session.device),
            torch.from_numpy(images_b).to(session.device)))
    for values in pending:
        for name in metrics:
            metrics[name].update_state(float(values[name]))
    result = {name: metric.result() for name, metric in metrics.items()}
    result["batches"] = len(pending)
    result["split"] = split
    return result


def evaluate_quality(model_dir: Path, records_a, records_b,
                     batch: int = 8, split: str = "val",
                     validation_split: float = 0.2,
                     max_images: int = 256, seed: int = 0,
                     compute_dtype: str = "float32",
                     extractor_path=None, device="cuda") -> dict:
    """FID-class statistics: the split's domain-A images stylized through
    g_AB against the real domain-B images, and the other way, with
    FID/KID on the seeded random-feature extractor (``fid_proxy``,
    ``kid_proxy``) plus SWD. With ``extractor_path`` (a pretrained
    extractor ``.npz``, ``utils/extractor.py``) the statistics are FID
    and KID, under ``fid``/``kid``."""
    from cyclegan_tpu_torch.apps.inference import InferenceSession
    from cyclegan_tpu_torch.data.pipeline import create_dataset
    from cyclegan_tpu_torch.utils.quality import compute_quality

    extractor = None
    if extractor_path is not None:
        from cyclegan_tpu_torch.utils.extractor import load_extractor

        extractor = load_extractor(extractor_path, device)

    session = InferenceSession(model_dir, compute_dtype=compute_dtype,
                               device=device)
    width = _train_image_size(model_dir) or 256
    train_ds, val_ds = create_dataset(
        records_a, records_b, validation_split=validation_split,
        width=width, seed=seed)
    dataset = val_ds if split == "val" else train_ds

    reals_a, reals_b = [], []
    for images_a, images_b in dataset.batches(batch, epoch=0):
        reals_a.append(np.asarray(images_a))
        reals_b.append(np.asarray(images_b))
        if sum(len(x) for x in reals_a) >= max_images:
            break
    real_a = np.concatenate(reals_a)[:max_images]
    real_b = np.concatenate(reals_b)[:max_images]

    fake_b = np.concatenate(
        [session.stylize(real_a[i:i + batch], "a2b")
         for i in range(0, len(real_a), batch)])
    fake_a = np.concatenate(
        [session.stylize(real_b[i:i + batch], "b2a")
         for i in range(0, len(real_b), batch)])

    result = {}
    for tag, fake, real in (("a2b", fake_b, real_b), ("b2a", fake_a, real_a)):
        stats = compute_quality(fake, real, extractor=extractor, seed=seed,
                                device=session.device)
        result.update({f"{tag}_{k}": v for k, v in stats.items()
                       if k not in ("n_a", "n_b")})
    result["n_images"] = int(len(real_a))
    result["split"] = split
    return result


def main(argv=None):
    logging.basicConfig(level=logging.INFO)
    parser = argparse.ArgumentParser("cyclegan_tpu_torch evaluation")
    parser.add_argument("--model_dir", type=Path,
                        default=Path("model_instances", "model"))
    parser.add_argument("--records_a", nargs="+", required=True,
                        help="domain-A shard files or one directory")
    parser.add_argument("--records_b", nargs="+", required=True)
    parser.add_argument("--batch", type=int, default=8)
    parser.add_argument("--split", choices=["val", "train"], default="val")
    parser.add_argument("--validation_split", type=float, default=0.2)
    parser.add_argument("--quality", "--fid", action="store_true",
                        dest="quality",
                        help="also compute FID-class statistics "
                        "(FID/KID + SWD) between stylized and real image "
                        "sets; on the random-feature proxy extractor "
                        "unless --extractor is given")
    parser.add_argument("--extractor", type=Path, default=None,
                        help="pretrained feature-extractor .npz "
                        "(utils/extractor.py format): makes the "
                        "statistics real FID/KID")
    parser.add_argument("--max_images", type=int, default=256,
                        help="image budget per domain for --quality")
    parser.add_argument("--device", default="cuda",
                        help="torch device (cuda by default; cpu runs the "
                        "plain versions)")
    args = parser.parse_args(argv)

    def expand(paths):
        if len(paths) == 1 and Path(paths[0]).is_dir():
            return sorted(str(p) for p in Path(paths[0]).glob("*.tfrecords"))
        return paths

    result = evaluate(args.model_dir, expand(args.records_a),
                      expand(args.records_b), args.batch, args.split,
                      args.validation_split, device=args.device)
    if args.quality:
        result.update(
            evaluate_quality(args.model_dir, expand(args.records_a),
                             expand(args.records_b), args.batch, args.split,
                             args.validation_split,
                             max_images=args.max_images,
                             extractor_path=args.extractor,
                             device=args.device))
    print(json.dumps({k: (round(v, 6) if isinstance(v, float) else v)
                      for k, v in result.items()}))


if __name__ == "__main__":
    main()
