"""Input pipeline: TFRecords -> decoded, paired epoch batches
(cyclegan_tpu/data/pipeline.py ``ArrayDataset``, ``create_dataset``).

Every shard is decoded once, up front, on a thread pool, into one uint8
array per domain. The train/validation split is a seeded permutation per
domain, and each training epoch reshuffles both domains with a
(seed, epoch)-keyed generator: the same numpy code as the JAX package, so
membership and order are the same. Batches leave the host as uint8; the
jitter and normalization run on the batch's device (``data/augment.py``).

Not ported yet (ROADMAP.md queue 1, item 4): the native C++ loader and the
streaming loader.
"""

from __future__ import annotations

import concurrent.futures as cf
import os
from typing import Iterator, List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from cyclegan_tpu_torch.data.codec import decode_image_rgb
from cyclegan_tpu_torch.data.example_proto import decode_example
from cyclegan_tpu_torch.data.tfrecord import read_tfrecord_file

try:  # pragma: no cover - import guard
    import cv2
except Exception:  # pragma: no cover
    cv2 = None

try:  # pragma: no cover - import guard
    from PIL import Image
except Exception:  # pragma: no cover
    Image = None


def _resize(img: np.ndarray, width: int) -> np.ndarray:
    """Bilinear resize to width x width on the host, where a record's size
    differs: cv2 (INTER_LINEAR), else PIL (BILINEAR), as the JAX package,
    else torch's half-pixel bilinear, rounded."""
    if img.shape[0] == width and img.shape[1] == width:
        return img
    if cv2 is not None:
        return cv2.resize(img, (width, width), interpolation=cv2.INTER_LINEAR)
    if Image is not None:
        return np.asarray(Image.fromarray(img).resize((width, width),
                                                      Image.BILINEAR))
    x = torch.from_numpy(img).permute(2, 0, 1)[None].float()
    y = F.interpolate(x, size=(width, width), mode="bilinear",
                      align_corners=False, antialias=False)
    return y[0].permute(1, 2, 0).round().clamp(0, 255).to(torch.uint8).numpy()


def _load_domain(records: Sequence[str], width: int) -> np.ndarray:
    """Decode (and resize where needed) every example of a list of shard
    files into one (N, width, width, 3) uint8 array, on a thread pool."""
    raw: List[bytes] = []
    for path in records:
        raw.extend(read_tfrecord_file(path))

    def decode_one(example_bytes: bytes) -> np.ndarray:
        features = decode_example(example_bytes)
        return _resize(decode_image_rgb(features["image_raw"][0]), width)

    workers = min(32, max(4, os.cpu_count() or 4))
    with cf.ThreadPoolExecutor(workers) as pool:
        images = list(pool.map(decode_one, raw))
    if not images:
        return np.zeros((0, width, width, 3), np.uint8)
    return np.stack(images).astype(np.uint8)


class ArrayDataset:
    """A paired two-domain dataset yielding per-epoch uint8 batches.

    An epoch has min(len_a, len_b) pairs. Training epochs reshuffle both
    domains independently with a (seed, epoch)-keyed permutation; batches
    that would be partial are dropped, so every batch has one shape.
    """

    def __init__(self, images_a: np.ndarray, images_b: np.ndarray,
                 shuffle: bool = True, seed: int = 0):
        self.images_a = images_a
        self.images_b = images_b
        self.shuffle = shuffle
        self.seed = seed

    def __len__(self) -> int:
        return min(len(self.images_a), len(self.images_b))

    def num_batches(self, batch_size: int) -> int:
        return len(self) // batch_size

    def batches(self, batch_size: int, epoch: int = 0
                ) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        """Yield (a, b) uint8 batch pairs for one epoch."""
        n = len(self)
        if self.shuffle:
            rng = np.random.default_rng((self.seed, epoch))
            idx_a = rng.permutation(len(self.images_a))[:n]
            idx_b = rng.permutation(len(self.images_b))[:n]
        else:
            idx_a = np.arange(n)
            idx_b = np.arange(n)
        for start in range(0, n - n % batch_size, batch_size):
            yield (self.images_a[idx_a[start:start + batch_size]],
                   self.images_b[idx_b[start:start + batch_size]])

    def take_pairs(self, count: int) -> Tuple[np.ndarray, np.ndarray]:
        """The first ``count`` (a, b) pairs in storage order: the fixed
        sample images of the summaries."""
        return self.images_a[:count], self.images_b[:count]


def create_dataset(records_a: Sequence[str], records_b: Sequence[str],
                   validation_split: float = 0.2, width: int = 128,
                   seed: int = 0) -> Tuple[ArrayDataset, ArrayDataset]:
    """(train, validation) datasets from two domains' TFRecord shards. The
    validation size is ``int(validation_split * len(domain_a))`` for both
    domains; membership is a seeded permutation per domain."""
    images_a = _load_domain(records_a, width)
    images_b = _load_domain(records_b, width)

    num_validation = int(validation_split * len(images_a))
    rng = np.random.default_rng(seed)
    perm_a = rng.permutation(len(images_a))
    perm_b = rng.permutation(len(images_b))

    val_a = images_a[perm_a[:num_validation]]
    train_a = images_a[perm_a[num_validation:]]
    val_b = images_b[perm_b[:num_validation]]
    train_b = images_b[perm_b[num_validation:]]
    return (ArrayDataset(train_a, train_b, shuffle=True, seed=seed),
            ArrayDataset(val_a, val_b, shuffle=False, seed=seed))
