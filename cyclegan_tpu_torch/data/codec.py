"""Image <-> Example conversion (cyclegan_tpu/data/codec.py
``imread_bgr``, ``encode_png_bgr``, ``decode_image_rgb``, ``image2example``,
``example2image``) and the host-side bilinear resize (``resize_rgb``).

Channel conventions follow the JAX package: images enter in cv2's BGR
order, are PNG-encoded in the right order, and decode back to RGB, as
``tf.image.decode_image`` gives them. The codec is cv2 where it can be
imported, then PIL, as in the JAX package, and otherwise the standard
library's (``data/png.py``: PNG only; a JPEG then raises). The resize
makes the same choice, and without either it is torch's bilinear in
place of cv2's.
"""

from __future__ import annotations

import io
from pathlib import Path
from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from cyclegan_tpu_torch.data import png
from cyclegan_tpu_torch.data.example_proto import (
    decode_example,
    encode_example,
)

try:  # pragma: no cover - import guard
    import cv2
except Exception:  # pragma: no cover
    cv2 = None

try:  # pragma: no cover - import guard
    from PIL import Image
except Exception:  # pragma: no cover
    Image = None


def resize_rgb(image: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """Bilinear resize of an HxWxC uint8 image to ``size`` = (width,
    height), as cv2 takes it: cv2's INTER_LINEAR where cv2 imports, else
    PIL's BILINEAR (which averages over the source when it shrinks), as the
    JAX package chooses, else torch's half-pixel bilinear without
    antialiasing, rounded: cv2's formula in floating point, within one
    step of cv2's fixed-point result."""
    width, height = int(size[0]), int(size[1])
    if image.shape[0] == height and image.shape[1] == width:
        return image
    if cv2 is not None:
        return cv2.resize(image, (width, height),
                          interpolation=cv2.INTER_LINEAR)
    if Image is not None:
        return np.asarray(Image.fromarray(image).resize((width, height),
                                                        Image.BILINEAR))
    x = torch.from_numpy(np.ascontiguousarray(image)).permute(2, 0, 1)
    y = F.interpolate(x[None].float(), size=(height, width), mode="bilinear",
                      align_corners=False, antialias=False)
    return y[0].permute(1, 2, 0).round().clamp(0, 255).to(
        torch.uint8).numpy()


def imread_bgr(path: Union[str, Path],
               image_size: Optional[int] = None) -> Optional[np.ndarray]:
    """Read an image file as HxWx3 uint8 BGR (cv2.imread's convention),
    resized to (image_size, image_size) where given, as the JAX writer
    does; None where the file cannot be decoded (without cv2 or PIL only a
    PNG can)."""
    if cv2 is not None:
        img = cv2.imread(str(path), cv2.IMREAD_COLOR)
    else:
        try:
            img = decode_image_rgb(Path(path).read_bytes())[..., ::-1]
        except (OSError, ValueError, RuntimeError):
            return None
    if img is None:
        return None
    if image_size:
        img = resize_rgb(np.ascontiguousarray(img), (image_size, image_size))
    return np.ascontiguousarray(img)


def encode_png_bgr(image: np.ndarray) -> bytes:
    """PNG-encode an HxWx3 uint8 BGR array (cv2.imencode semantics)."""
    if cv2 is not None:
        ok, buf = cv2.imencode(".png", image)
        if not ok:
            raise ValueError("PNG encoding failed")
        return buf.tobytes()
    rgb = np.ascontiguousarray(image[..., ::-1])
    if Image is not None:
        out = io.BytesIO()
        Image.fromarray(rgb).save(out, format="PNG")
        return out.getvalue()
    return png.encode_png(rgb)


def decode_image_rgb(data: bytes) -> np.ndarray:
    """Decode PNG (or, with cv2 or PIL, JPEG) bytes to HxWx3 uint8 RGB."""
    if cv2 is not None:
        bgr = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)
        if bgr is None:
            raise ValueError("image decoding failed")
        return cv2.cvtColor(bgr, cv2.COLOR_BGR2RGB)
    if Image is not None:
        with Image.open(io.BytesIO(data)) as im:
            return np.asarray(im.convert("RGB"))
    if data[:2] == b"\xff\xd8":
        raise RuntimeError("a JPEG record needs cv2 or PIL to decode; "
                           "neither can be imported here (the standard "
                           "library decoder reads PNG only)")
    return png.decode_png(data)


def image2example(image: np.ndarray) -> bytes:
    """Serialize a BGR uint8 image into Example bytes: the PNG as
    ``image_raw`` beside its height, width and depth."""
    height, width, depth = image.shape
    features: Dict[str, object] = {
        "image_raw": encode_png_bgr(image),
        "height": int(height),
        "width": int(width),
        "depth": int(depth),
    }
    return encode_example(features)


def example2image(example_bytes: bytes) -> np.ndarray:
    """Parse Example bytes back into an HxWx3 uint8 RGB array."""
    features = decode_example(example_bytes)
    image = decode_image_rgb(features["image_raw"][0])
    height = int(features["height"][0])
    width = int(features["width"][0])
    depth = int(features["depth"][0])
    return image.reshape(height, width, depth)
