"""Read a TensorFlow tensor bundle (a SavedModel's ``variables/variables``
checkpoint) with numpy alone, no TensorFlow.

A bundle with prefix P is two kinds of file:

- ``P.index``: a LevelDB-format table (an SSTable) mapping each tensor's
  name to a serialized ``BundleEntryProto`` (dtype, shape, shard, byte
  offset and size); the empty key holds the ``BundleHeaderProto``
  (number of shards, endianness).
- ``P.data-<shard>-of-<num_shards>``: the tensors' raw bytes, in the
  byte order the header names.

The table ends in a 48-byte footer: the block handles (varint64 offset
and size) of the metaindex and index blocks, zero padding to 40 bytes,
and the magic number ``0xdb4775248b80fb57`` (fixed64). The index block's
values are the handles of the data blocks, whose entries are the
bundle's keys in order. Every block is followed by a one-byte compression
type and a crc32; a block is read in full, entry by entry (shared key
bytes, unshared key bytes and value length as varint32s, then the key's
unshared bytes and the value), so its restart array is not needed.

Only uncompressed blocks (type 0, what TensorFlow's bundle writer
produces) are read; any other type raises rather than be misparsed. The
blocks' crc32s and the entries' ``crc32c`` (field 6) are not verified:
the byte counts and the shapes are (``TensorBundle.tensor``). String
tensors (the object graph, ``DT_STRING``) are never decoded.
"""

from __future__ import annotations

import struct
from pathlib import Path
from typing import Dict, Iterator, NamedTuple, Tuple, Union

import numpy as np

from cyclegan_tpu_torch.data.example_proto import _decode_varint, _iter_fields

TABLE_MAGIC = 0xDB4775248B80FB57
FOOTER_BYTES = 48
BLOCK_TRAILER_BYTES = 5  # compression type, crc32
# tensorflow/core/framework/types.proto
DT_FLOAT, DT_DOUBLE, DT_STRING, DT_HALF = 1, 2, 7, 19
NUMPY_DTYPES = {DT_FLOAT: "<f4", DT_DOUBLE: "<f8", DT_HALF: "<f2"}


class BundleEntry(NamedTuple):
    """One tensor's ``BundleEntryProto``."""

    dtype: int
    shape: Tuple[int, ...]
    shard_id: int
    offset: int
    size: int
    sliced: bool  # a partitioned variable: its bytes live in slices


def _block_handle(buf: bytes, pos: int) -> Tuple[int, int, int]:
    """(offset, size, next position) of the varint64 pair at ``pos``."""
    offset, pos = _decode_varint(buf, pos)
    size, pos = _decode_varint(buf, pos)
    return offset, size, pos


def _read_block(data: bytes, offset: int, size: int, path: Path) -> bytes:
    if offset + size + BLOCK_TRAILER_BYTES > len(data):
        raise ValueError(f"{path}: block at {offset} (+{size} bytes) runs "
                         f"past the end of the file ({len(data)} bytes)")
    kind = data[offset + size]
    if kind != 0:
        raise ValueError(f"{path}: block at {offset} has compression type "
                         f"{kind}; only uncompressed (0) blocks are read")
    return data[offset:offset + size]


def _block_entries(block: bytes) -> Iterator[Tuple[bytes, bytes]]:
    """(key, value) of every entry of one block, in order."""
    (num_restarts,) = struct.unpack_from("<I", block, len(block) - 4)
    end = len(block) - 4 - 4 * num_restarts
    pos, key = 0, b""
    while pos < end:
        shared, pos = _decode_varint(block, pos)
        unshared, pos = _decode_varint(block, pos)
        value_len, pos = _decode_varint(block, pos)
        key = key[:shared] + block[pos:pos + unshared]
        pos += unshared
        yield key, block[pos:pos + value_len]
        pos += value_len


def table_entries(path: Union[str, Path]) -> Iterator[Tuple[bytes, bytes]]:
    """Every (key, value) of a LevelDB-format table file, in key order."""
    path = Path(path)
    data = path.read_bytes()
    if len(data) < FOOTER_BYTES:
        raise ValueError(f"{path}: {len(data)} bytes, shorter than a table "
                         "footer")
    footer = data[-FOOTER_BYTES:]
    (magic,) = struct.unpack_from("<Q", footer, FOOTER_BYTES - 8)
    if magic != TABLE_MAGIC:
        raise ValueError(f"{path}: table magic {magic:#x}, expected "
                         f"{TABLE_MAGIC:#x}")
    _, _, pos = _block_handle(footer, 0)  # the metaindex: not needed
    index_offset, index_size, _ = _block_handle(footer, pos)
    index = _read_block(data, index_offset, index_size, path)
    for _, handle in _block_entries(index):
        offset, size, _ = _block_handle(handle, 0)
        yield from _block_entries(_read_block(data, offset, size, path))


def _entry(value: bytes) -> BundleEntry:
    fields = {"dtype": 0, "shape": (), "shard_id": 0, "offset": 0,
              "size": 0, "sliced": False}
    for field, v in _iter_fields(value):
        if field == 1:
            fields["dtype"] = v
        elif field == 2:  # TensorShapeProto: repeated Dim dim = 2
            fields["shape"] = tuple(
                next((s for f, s in _iter_fields(dim) if f == 1), 0)
                for f, dim in _iter_fields(v) if f == 2)
        elif field == 3:
            fields["shard_id"] = v
        elif field == 4:
            fields["offset"] = v
        elif field == 5:
            fields["size"] = v
        elif field == 7:
            fields["sliced"] = True
    return BundleEntry(**fields)


class TensorBundle:
    """A bundle's entries by name (``entries``, the header excluded) and
    its tensors on demand (``tensor``), as ``tf.train.load_checkpoint``'s
    reader gives them."""

    def __init__(self, prefix: Union[str, Path]):
        self.prefix = str(prefix)
        self.num_shards = 1
        self.entries: Dict[str, BundleEntry] = {}
        index = Path(self.prefix + ".index")
        for key, value in table_entries(index):
            if key == b"":
                header = dict(_iter_fields(value))
                if header.get(2, 0) != 0:
                    raise ValueError(f"{index}: a big-endian bundle; only "
                                     "little-endian bundles are read")
                self.num_shards = header.get(1, 1)
                continue
            self.entries[key.decode("utf-8")] = _entry(value)

    def tensor(self, key: str) -> np.ndarray:
        """The tensor under ``key``; a float type (DT_FLOAT, DT_DOUBLE,
        DT_HALF) unsliced, else ``ValueError``."""
        entry = self.entries[key]
        if entry.dtype not in NUMPY_DTYPES:
            raise ValueError(f"{self.prefix}: {key} has dtype enum "
                             f"{entry.dtype}; only DT_FLOAT, DT_DOUBLE and "
                             "DT_HALF tensors are read")
        if entry.sliced:
            raise ValueError(f"{self.prefix}: {key} is a partitioned "
                             "variable; its slices are not read")
        dtype = np.dtype(NUMPY_DTYPES[entry.dtype])
        count = int(np.prod(entry.shape, dtype=np.int64))
        if count * dtype.itemsize != entry.size:
            raise ValueError(f"{self.prefix}: {key} holds {entry.size} "
                             f"bytes, its shape {entry.shape} needs "
                             f"{count * dtype.itemsize}")
        shard = (f"{self.prefix}.data-{entry.shard_id:05d}-of-"
                 f"{self.num_shards:05d}")
        with open(shard, "rb") as f:
            f.seek(entry.offset)
            raw = f.read(entry.size)
        if len(raw) != entry.size:
            raise ValueError(f"{shard}: {key} runs past the end of the file")
        return np.frombuffer(raw, dtype).reshape(entry.shape).copy()
