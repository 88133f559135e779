"""TFRecord file framing (cyclegan_tpu/data/tfrecord.py
``write_tfrecord_file``, ``read_tfrecord_file``), byte-compatible with
``tf.io.TFRecordWriter`` and the JAX package:

    uint64 little-endian length
    uint32 masked crc32c(length bytes)
    byte   data[length]
    uint32 masked crc32c(data)

CRC32C (Castagnoli) is computed here from a table: the JAX package's
``google_crc32c`` is not on the card's machine. Reads do not verify the
checksums unless asked, as in the JAX package.
"""

from __future__ import annotations

import struct
from pathlib import Path
from typing import Iterable, Iterator, Union

_CRC_MASK_DELTA = 0xA282EAD8
_POLY = 0x82F63B78  # CRC32C, reflected


def _table():
    table = []
    for n in range(256):
        crc = n
        for _ in range(8):
            crc = (crc >> 1) ^ _POLY if crc & 1 else crc >> 1
        table.append(crc)
    return tuple(table)


_TABLE = _table()


def crc32c(data: bytes) -> int:
    """CRC32C of ``data`` (the value ``google_crc32c.value`` gives)."""
    crc = 0xFFFFFFFF
    table = _TABLE
    for byte in data:
        crc = table[(crc ^ byte) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _masked_crc32c(data: bytes) -> int:
    crc = crc32c(data)
    return (((crc >> 15) | (crc << 17)) + _CRC_MASK_DELTA) & 0xFFFFFFFF


def write_tfrecord_file(path: Union[str, Path],
                        records: Iterable[bytes]) -> int:
    """Write serialized records to one TFRecord file. Returns the count."""
    count = 0
    with open(path, "wb") as f:
        for record in records:
            length = struct.pack("<Q", len(record))
            f.write(length)
            f.write(struct.pack("<I", _masked_crc32c(length)))
            f.write(record)
            f.write(struct.pack("<I", _masked_crc32c(record)))
            count += 1
    return count


def read_tfrecord_file(path: Union[str, Path],
                       verify_crc: bool = False) -> Iterator[bytes]:
    """Yield the serialized records of a TFRecord file; with
    ``verify_crc``, raise IOError on a checksum that does not match."""
    with open(path, "rb") as f:
        while True:
            header = f.read(12)
            if not header:
                return
            if len(header) < 12:
                raise IOError(f"truncated TFRecord header in {path}")
            (length,) = struct.unpack("<Q", header[:8])
            if verify_crc:
                (expected,) = struct.unpack("<I", header[8:12])
                if _masked_crc32c(header[:8]) != expected:
                    raise IOError(f"corrupt length crc in {path}")
            data = f.read(length)
            if len(data) < length:
                raise IOError(f"truncated TFRecord payload in {path}")
            footer = f.read(4)
            if verify_crc:
                (expected,) = struct.unpack("<I", footer)
                if _masked_crc32c(data) != expected:
                    raise IOError(f"corrupt data crc in {path}")
            yield data
