"""Batched inference export: TFRecords -> stylized PNGs
(cyclegan_tpu/apps/export.py, BASELINE config #5: stylization at 512x512,
TFRecord -> PNG).

Reads one domain's shards, stylizes them in fixed-size batches at the
requested resolution and writes one PNG per image,
``{index:06d}_{direction}.png``. bf16 is the default, as in the JAX
package; with ``tpu_layout`` "auto" that is the NHCW kernel path on the
card.

    python -m cyclegan_tpu_torch.apps.export --records \\
        data/tabby_records/*.tfrecords --model_dir model_instances/model \\
        --direction a2b --size 512 --batch 8 --out exports/ [--device cpu]
"""

from __future__ import annotations

import argparse
import logging
from pathlib import Path
from typing import List, Sequence

import numpy as np

logger = logging.getLogger(__name__)


def export_records(records: Sequence[str], model_dir: Path, out_dir: Path,
                   direction: str = "a2b", size: int = 512, batch: int = 8,
                   compute_dtype: str = "bfloat16",
                   device: str = "cuda") -> List[Path]:
    """Stylize every image of the shards; returns the written paths.
    Batches have one size (the tail is padded with zeros and its padding
    dropped), so every forward runs at one shape."""
    from cyclegan_tpu_torch.apps.inference import InferenceSession
    from cyclegan_tpu_torch.data.codec import encode_png_bgr
    from cyclegan_tpu_torch.data.pipeline import _load_domain

    session = InferenceSession(model_dir, compute_dtype=compute_dtype,
                               device=device)
    images = _load_domain(records, size)
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)

    written: List[Path] = []
    for start in range(0, len(images), batch):
        chunk = images[start:start + batch]
        valid = len(chunk)
        if valid < batch:
            pad = np.zeros((batch - valid, size, size, 3), np.uint8)
            chunk = np.concatenate([chunk, pad])
        stylized = session.stylize(chunk, direction)[:valid]
        for offset, rgb in enumerate(stylized):
            path = out_dir / f"{start + offset:06d}_{direction}.png"
            path.write_bytes(encode_png_bgr(rgb[..., ::-1]))
            written.append(path)
    logger.info("exported %d images to %s", len(written), out_dir)
    return written


def main(argv=None):
    logging.basicConfig(level=logging.INFO)
    parser = argparse.ArgumentParser("cyclegan_tpu_torch batched export")
    parser.add_argument("--records", nargs="+", required=True)
    parser.add_argument("--model_dir", type=Path,
                        default=Path("model_instances", "model"))
    parser.add_argument("--direction", choices=["a2b", "b2a"], default="a2b")
    parser.add_argument("--size", type=int, default=512)
    parser.add_argument("--batch", type=int, default=8)
    parser.add_argument("--out", type=Path, default=Path("exports"))
    parser.add_argument("--dtype", default="bfloat16",
                        choices=["float32", "bfloat16"])
    parser.add_argument("--device", default="cuda",
                        help="torch device (cuda by default; cpu runs the "
                        "kernels' plain versions)")
    args = parser.parse_args(argv)
    export_records(args.records, args.model_dir, args.out, args.direction,
                   args.size, args.batch, args.dtype, args.device)


if __name__ == "__main__":
    main()
