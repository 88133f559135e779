"""Input pipeline: TFRecords -> decoded, paired epoch batches
(cyclegan_tpu/data/pipeline.py ``ArrayDataset``, ``create_dataset``).

Every shard is decoded once, up front, on a thread pool, into one uint8
array per domain. The train/validation split is a seeded permutation per
domain, and each training epoch reshuffles both domains with a
(seed, epoch)-keyed generator: the same numpy code as the JAX package, so
membership and order are the same. Batches leave the host as uint8; the
jitter and normalization run on the batch's device (``data/augment.py``).

The shards are written by ``data/tfrecord.py`` ``tfrecord_writer``. The
native C++ loader (``data/native.py``) decodes them where it builds, the
Python path otherwise; ``data/streaming.py`` is the loader that decodes
per batch.

Several processes feeding one global batch (``process_index`` of
``process_count``, the data ranks of a mesh) walk the same permutation and
each take their disjoint ``batch_size`` slice of every global
``batch_size * process_count`` batch; tails that do not fill a global batch
are dropped on every process. One process keeps its partial last batch
where ``drop_remainder=False`` (``epoch_limit``).
"""

from __future__ import annotations

import concurrent.futures as cf
import os
from typing import Iterator, List, Sequence, Tuple

import numpy as np

from cyclegan_tpu_torch.data.codec import decode_image_rgb, resize_rgb
from cyclegan_tpu_torch.data.example_proto import decode_example
from cyclegan_tpu_torch.data.tfrecord import read_tfrecord_file


def decode_record(example_bytes: bytes, width: int) -> np.ndarray:
    """One serialized example -> its (width, width, 3) uint8 RGB image."""
    features = decode_example(example_bytes)
    return resize_rgb(decode_image_rgb(features["image_raw"][0]),
                      (width, width))


def decode_workers() -> int:
    """The decode thread pool's size, the JAX package's."""
    return min(32, max(4, os.cpu_count() or 4))


def _load_domain(records: Sequence[str], width: int) -> np.ndarray:
    """Decode (and resize where needed) every example of a list of shard
    files into one (N, width, width, 3) uint8 array: through the native
    loader (``data/native.py``) where it builds, else on a Python thread
    pool."""
    from cyclegan_tpu_torch.data import native

    images = native.load_domain_native(records, width)
    if images is not None:
        return images
    raw: List[bytes] = []
    for path in records:
        raw.extend(read_tfrecord_file(path))
    with cf.ThreadPoolExecutor(decode_workers()) as pool:
        images = list(pool.map(lambda r: decode_record(r, width), raw))
    native.decoded["python"] += len(images)
    if not images:
        return np.zeros((0, width, width, 3), np.uint8)
    return np.stack(images).astype(np.uint8)


def _check_host_shard(process_index: int, process_count: int) -> None:
    if process_count < 1:
        raise ValueError(f"process_count must be >= 1, got {process_count}")
    if not 0 <= process_index < process_count:
        raise ValueError(f"process_index {process_index} out of range for "
                         f"process_count {process_count}")


def epoch_limit(n: int, batch_size: int, process_count: int,
                drop_remainder: bool) -> int:
    """How many of an epoch's ``n`` pairs the global batches cover: whole
    ``batch_size * process_count`` batches, or all ``n`` where one process
    keeps its partial tail (``drop_remainder=False``); several processes
    always drop it, since a partial batch on some of them only would put
    them out of step."""
    stride = batch_size * process_count
    if drop_remainder or process_count > 1:
        return n - n % stride
    return n


def epoch_batches(n: int, batch_size: int, process_count: int,
                  drop_remainder: bool) -> int:
    """The number of batches ``epoch_limit``'s pairs make."""
    stride = batch_size * process_count
    return -(-epoch_limit(n, batch_size, process_count, drop_remainder)
             // stride)


class ArrayDataset:
    """A paired two-domain dataset yielding per-epoch uint8 batches.

    An epoch has min(len_a, len_b) pairs. Training epochs reshuffle both
    domains independently with a (seed, epoch)-keyed permutation; batches
    that would be partial are dropped, so every batch has one shape, unless
    ``drop_remainder=False`` on one process (``epoch_limit``). With
    ``process_count`` > 1, ``batch_size`` is this process's slice of each
    global batch (the module docstring).
    """

    def __init__(self, images_a: np.ndarray, images_b: np.ndarray,
                 shuffle: bool = True, seed: int = 0,
                 process_index: int = 0, process_count: int = 1):
        _check_host_shard(process_index, process_count)
        self.images_a = images_a
        self.images_b = images_b
        self.shuffle = shuffle
        self.seed = seed
        self.process_index = process_index
        self.process_count = process_count

    def __len__(self) -> int:
        return min(len(self.images_a), len(self.images_b))

    def num_batches(self, batch_size: int,
                    drop_remainder: bool = True) -> int:
        return epoch_batches(len(self), batch_size, self.process_count,
                             drop_remainder)

    def batches(self, batch_size: int, epoch: int = 0,
                drop_remainder: bool = True
                ) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        """Yield (a, b) uint8 batch pairs for one epoch: this process's
        slice of each global batch (with ``drop_remainder=False`` on one
        process, the partial last batch too)."""
        n = len(self)
        if self.shuffle:
            rng = np.random.default_rng((self.seed, epoch))
            idx_a = rng.permutation(len(self.images_a))[:n]
            idx_b = rng.permutation(len(self.images_b))[:n]
        else:
            idx_a = np.arange(n)
            idx_b = np.arange(n)
        stride = batch_size * self.process_count
        limit = epoch_limit(n, batch_size, self.process_count,
                            drop_remainder)
        off = self.process_index * batch_size
        for start in range(off, limit, stride):
            yield (self.images_a[idx_a[start:start + batch_size]],
                   self.images_b[idx_b[start:start + batch_size]])

    def take_pairs(self, count: int) -> Tuple[np.ndarray, np.ndarray]:
        """The first ``count`` (a, b) pairs in storage order: the fixed
        sample images of the summaries."""
        return self.images_a[:count], self.images_b[:count]


def create_dataset(records_a: Sequence[str], records_b: Sequence[str],
                   validation_split: float = 0.2, width: int = 128,
                   seed: int = 0, process_index: int = 0,
                   process_count: int = 1
                   ) -> Tuple[ArrayDataset, ArrayDataset]:
    """(train, validation) datasets from two domains' TFRecord shards. The
    validation size is ``int(validation_split * len(domain_a))`` for both
    domains; membership is a seeded permutation per domain. Each of
    ``process_count`` processes feeds its slice of every global batch
    (``ArrayDataset``); every process decodes the whole corpus (the
    streaming loader reads only what a process feeds)."""
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
    shard = dict(seed=seed, process_index=process_index,
                 process_count=process_count)
    return (ArrayDataset(train_a, train_b, shuffle=True, **shard),
            ArrayDataset(val_a, val_b, shuffle=False, **shard))
