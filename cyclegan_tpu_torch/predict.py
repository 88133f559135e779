"""Stylize one image file from the command line (the non-Streamlit
fallback of the JAX package's ``predict.py``):

    python -m cyclegan_tpu_torch.predict --image cat.png \\
        --model_dir model_instances/converged256 --out predictions \\
        --size 512 [--device cpu]

Writes ``<stem>_original.png``, ``<stem>_a2b.png`` and ``<stem>_b2a.png``
(the resized input and both translations) through the port's codec and
prints their paths. Without cv2 or PIL only a PNG input can be read.
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np

DEFAULT_MODEL_DIR = Path("model_instances", "model")


def main(argv=None):
    from cyclegan_tpu_torch.apps.inference import InferenceSession
    from cyclegan_tpu_torch.data.codec import encode_png_bgr, imread_bgr

    parser = argparse.ArgumentParser("CycleGAN stylization")
    parser.add_argument("--image", required=True, help="input image path")
    parser.add_argument("--model_dir", default=DEFAULT_MODEL_DIR, type=Path)
    parser.add_argument("--out", default=Path("predictions"), type=Path)
    parser.add_argument("--size", type=int, default=256,
                        help="stylization resolution (e.g. 512)")
    parser.add_argument("--device", default="cuda",
                        help="torch device (cuda by default; cpu runs the "
                        "kernels' plain versions)")
    args = parser.parse_args(argv)

    session = InferenceSession(args.model_dir, device=args.device)
    bgr = imread_bgr(args.image)
    if bgr is None:
        raise SystemExit(f"could not read image {args.image}")
    triple = session.prediction_triple(bgr, (args.size, args.size))

    args.out.mkdir(parents=True, exist_ok=True)
    stem = Path(args.image).stem
    for tag, rgb in zip(("original", "a2b", "b2a"), triple):
        out_path = args.out / f"{stem}_{tag}.png"
        out_path.write_bytes(encode_png_bgr(
            np.ascontiguousarray(np.asarray(rgb)[..., ::-1])))
        print(out_path)


if __name__ == "__main__":
    main()
