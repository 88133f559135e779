"""The streaming dataset: the input pipeline at O(batch) host memory
(cyclegan_tpu/data/streaming.py).

The same semantics as ``data/pipeline.py`` (the seeded split, the
(seed, epoch)-keyed reshuffle, min-zip pairing), but nothing is decoded up
front: each shard is indexed once (the byte offset and length of each
record, from its 12-byte headers), and batches are decoded when asked for,
on a thread pool with one batch decoded ahead. Selected by the train
config's ``data_loader: streaming``.

Several processes feeding one global batch (``process_index`` of
``process_count``) each take their disjoint slice of every global batch by
numpy slicing, as the JAX package does; nothing here talks to the other
processes.
"""

from __future__ import annotations

import concurrent.futures as cf
import os
import struct
from pathlib import Path
from typing import Iterator, List, Sequence, Tuple, Union

import numpy as np

from cyclegan_tpu_torch.data.pipeline import (
    _check_host_shard,
    decode_record,
    decode_workers,
    epoch_batches,
    epoch_limit,
)

# (shard path, payload byte offset, payload length) of one record
RecordRef = Tuple[str, int, int]


def index_shard(path: Union[str, Path]) -> List[Tuple[int, int]]:
    """[(payload offset, length), ...] of one TFRecord file, from its
    12-byte record headers alone."""
    out: List[Tuple[int, int]] = []
    with open(path, "rb") as f:
        while True:
            header = f.read(12)
            if not header:
                return out
            if len(header) < 12:
                raise IOError(f"truncated TFRecord header in {path}")
            (length,) = struct.unpack("<Q", header[:8])
            out.append((f.tell(), length))
            f.seek(length + 4, os.SEEK_CUR)  # payload and its crc


def _index_domain(records: Sequence[str]) -> List[RecordRef]:
    return [(str(path), offset, length) for path in records
            for offset, length in index_shard(path)]


def _decode_ref(ref: RecordRef, width: int) -> np.ndarray:
    path, offset, length = ref
    with open(path, "rb") as f:
        f.seek(offset)
        payload = f.read(length)
    return decode_record(payload, width)


class StreamingDataset:
    """``pipeline.ArrayDataset``'s interface (``num_batches``,
    ``batches``, ``take_pairs``) over record references."""

    def __init__(self, refs_a: Sequence[RecordRef],
                 refs_b: Sequence[RecordRef], width: int,
                 shuffle: bool = True, seed: int = 0,
                 process_index: int = 0, process_count: int = 1):
        _check_host_shard(process_index, process_count)
        self.refs_a = list(refs_a)
        self.refs_b = list(refs_b)
        self.width = width
        self.shuffle = shuffle
        self.seed = seed
        self.process_index = process_index
        self.process_count = process_count

    def __len__(self) -> int:
        return min(len(self.refs_a), len(self.refs_b))

    def num_batches(self, batch_size: int,
                    drop_remainder: bool = True) -> int:
        return epoch_batches(len(self), batch_size, self.process_count,
                             drop_remainder)

    def _decode_batch(self, pool: cf.ThreadPoolExecutor, sel_a, sel_b
                      ) -> Tuple[np.ndarray, np.ndarray]:
        refs = ([self.refs_a[i] for i in sel_a]
                + [self.refs_b[i] for i in sel_b])
        images = list(pool.map(lambda r: _decode_ref(r, self.width), refs))
        k = len(sel_a)
        return (np.stack(images[:k]).astype(np.uint8),
                np.stack(images[k:]).astype(np.uint8))

    def batches(self, batch_size: int, epoch: int = 0,
                drop_remainder: bool = True
                ) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        """Yield decoded (a, b) uint8 batch pairs for one epoch, in
        ``ArrayDataset.batches``' order; batch i + 1 decodes while the
        caller works on batch i. With ``process_count`` > 1,
        ``batch_size`` is this process's share and it takes its slice of
        every global ``batch_size * process_count`` batch."""
        n = len(self)
        if self.shuffle:
            rng = np.random.default_rng((self.seed, epoch))
            idx_a = rng.permutation(len(self.refs_a))[:n]
            idx_b = rng.permutation(len(self.refs_b))[:n]
        else:
            idx_a = idx_b = np.arange(n)
        stride = batch_size * self.process_count
        limit = epoch_limit(n, batch_size, self.process_count,
                            drop_remainder)
        off = self.process_index * batch_size
        starts = list(range(0, limit, stride))
        if not starts:
            return
        with cf.ThreadPoolExecutor(decode_workers()) as pool:
            def submit(start):
                sel = slice(start + off, start + off + batch_size)
                return pool.submit(self._decode_batch, pool, idx_a[sel],
                                   idx_b[sel])

            future = submit(starts[0])
            for start in starts[1:]:
                ahead = submit(start)
                yield future.result()
                future = ahead
            yield future.result()

    def take_pairs(self, count: int) -> Tuple[np.ndarray, np.ndarray]:
        """The first ``count`` (a, b) pairs in storage order (the fixed
        sample images), at most ``len(self)``."""
        count = min(count, len(self))
        with cf.ThreadPoolExecutor(decode_workers()) as pool:
            return self._decode_batch(pool, range(count), range(count))


def create_streaming_dataset(records_a: Sequence[str],
                             records_b: Sequence[str],
                             validation_split: float = 0.2,
                             width: int = 128, seed: int = 0,
                             process_index: int = 0, process_count: int = 1
                             ) -> Tuple[StreamingDataset, StreamingDataset]:
    """(train, validation) streaming datasets over two domains' shards,
    split as ``pipeline.create_dataset`` splits: ``int(validation_split *
    len(domain_a))`` validation records per domain, membership fixed by
    one seeded permutation per domain."""
    refs_a, refs_b = _index_domain(records_a), _index_domain(records_b)
    num_validation = int(validation_split * len(refs_a))
    rng = np.random.default_rng(seed)
    perm_a = rng.permutation(len(refs_a))
    perm_b = rng.permutation(len(refs_b))

    def pick(refs, perm):
        return [refs[i] for i in perm]

    shard = dict(seed=seed, process_index=process_index,
                 process_count=process_count)
    return (StreamingDataset(pick(refs_a, perm_a[num_validation:]),
                             pick(refs_b, perm_b[num_validation:]), width,
                             shuffle=True, **shard),
            StreamingDataset(pick(refs_a, perm_a[:num_validation]),
                             pick(refs_b, perm_b[:num_validation]), width,
                             shuffle=False, **shard))
