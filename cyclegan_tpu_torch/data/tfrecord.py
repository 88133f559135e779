"""TFRecord file framing and the sharded image -> records writer
(cyclegan_tpu/data/tfrecord.py ``write_tfrecord_file``,
``read_tfrecord_file``, ``tfrecord_writer``), byte-compatible with
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

import logging
import random
import struct
from pathlib import Path
from typing import Iterable, Iterator, List, Optional, Union

logger = logging.getLogger(__name__)

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


def tfrecord_writer(image_paths: Union[str, Path], target: Union[str, Path],
                    image_size: Optional[int] = None, shard_size: int = 800,
                    seed: Optional[int] = None,
                    use_native: bool = True) -> List[Path]:
    """Shard a directory of images into ``NNNNN.tfrecords`` files of
    ``shard_size`` examples each, and pin them in ``manifest.json``
    (``data/manifest.py``); returns the shard paths.

    The file list is sorted, then shuffled by ``random.Random(seed)``, as
    the JAX writer does, so shard membership and order are the same; each
    image is read as BGR, resized to (image_size, image_size) where given,
    and PNG-encoded (``codec.image2example``). An unreadable file is
    skipped with a warning. With ``use_native`` the C++ writer
    (``data/native.py``) writes where it builds, and the manifest records
    ``writer: "native"``; else the Python path, ``writer: "python"``, as
    the JAX writer does."""
    from cyclegan_tpu_torch.data.codec import image2example, imread_bgr
    from cyclegan_tpu_torch.data.manifest import write_manifest

    images = sorted(Path(image_paths).iterdir())
    random.Random(seed).shuffle(images)
    logger.info("Images Found: %d", len(images))
    target = Path(target)
    target.mkdir(parents=True, exist_ok=True)
    extra = dict(image_size=image_size, shard_size=shard_size, seed=seed)

    if use_native:
        from cyclegan_tpu_torch.data.native import write_domain_native

        written = write_domain_native([str(p) for p in images], target,
                                      image_size, shard_size)
        if written is not None:
            logger.info("native writer: %d images", written)
            write_manifest(target, extra=dict(extra, writer="native"))
            return sorted(target.glob("*.tfrecords"))

    def shard_records(paths: List[Path]) -> Iterator[bytes]:
        for image_path in paths:
            img = imread_bgr(image_path, image_size)
            if img is None:
                logger.warning("skipping unreadable image %s", image_path)
                continue
            yield image2example(img)

    shard_paths: List[Path] = []
    for i in range(0, len(images), shard_size):
        record_file = target / f"{i // shard_size:05d}.tfrecords"
        write_tfrecord_file(record_file,
                            shard_records(images[i:i + shard_size]))
        shard_paths.append(record_file)
    write_manifest(target, extra=dict(extra, writer="python"))
    return shard_paths
