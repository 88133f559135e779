"""Minimal tf.train.Example protobuf codec, no TF dependency (the port's
copy of cyclegan_tpu/data/example_proto.py).

Implements exactly the wire format the reference produces and consumes
(transform/tfrecords.py:12-29 writes {image_raw: bytes, height/width/depth:
int64}; transform/data_load.py:7-17 parses it back). Message schema:

    Example  { Features features = 1; }
    Features { repeated FeatureEntry feature = 1; }   # proto map<string,Feature>
    FeatureEntry { string key = 1; Feature value = 2; }
    Feature  { BytesList bytes_list = 1; FloatList float_list = 2;
               Int64List int64_list = 3; }
    BytesList{ repeated bytes value = 1; }
    FloatList{ repeated float value = 1 [packed]; }
    Int64List{ repeated int64 value = 1 [packed]; }
"""

from __future__ import annotations

import struct
from typing import Any, Dict, List, Tuple, Union

FeatureValue = Union[bytes, int, float, List[bytes], List[int], List[float]]

_WIRE_VARINT = 0
_WIRE_I64 = 1
_WIRE_LEN = 2
_WIRE_I32 = 5


def _encode_varint(value: int) -> bytes:
    out = bytearray()
    while True:
        byte = value & 0x7F
        value >>= 7
        if value:
            out.append(byte | 0x80)
        else:
            out.append(byte)
            return bytes(out)


def _decode_varint(buf: bytes, pos: int) -> Tuple[int, int]:
    result = 0
    shift = 0
    while True:
        byte = buf[pos]
        pos += 1
        result |= (byte & 0x7F) << shift
        if not byte & 0x80:
            return result, pos
        shift += 7


def _tag(field: int, wire: int) -> bytes:
    return _encode_varint((field << 3) | wire)


def _len_delimited(field: int, payload: bytes) -> bytes:
    return _tag(field, _WIRE_LEN) + _encode_varint(len(payload)) + payload


def _encode_feature(value: FeatureValue) -> bytes:
    """Encode one Feature message, choosing the list type from the python
    type (bytes -> bytes_list, int -> int64_list, float -> float_list)."""
    if isinstance(value, (bytes, int, float)):
        values: List[Any] = [value]
    else:
        values = list(value)
        if not values:
            raise ValueError("empty feature value")
    first = values[0]
    if isinstance(first, bytes):
        body = b"".join(_len_delimited(1, v) for v in values)
        return _len_delimited(1, body)
    if isinstance(first, bool):
        raise TypeError("bool feature values are ambiguous")
    if isinstance(first, int):
        packed = b"".join(_encode_varint(v & 0xFFFFFFFFFFFFFFFF) for v in values)
        body = _len_delimited(1, packed)
        return _len_delimited(3, body)
    if isinstance(first, float):
        packed = struct.pack(f"<{len(values)}f", *values)
        body = _len_delimited(1, packed)
        return _len_delimited(2, body)
    raise TypeError(f"unsupported feature type {type(first)}")


def encode_example(features: Dict[str, FeatureValue]) -> bytes:
    """Serialize {name: value} into tf.train.Example bytes."""
    entries = b""
    for key, value in features.items():
        entry = _len_delimited(1, key.encode("utf-8")) + _len_delimited(
            2, _encode_feature(value)
        )
        entries += _len_delimited(1, entry)
    # Example.features (field 1) wraps Features (repeated entry field 1)
    return _len_delimited(1, entries)


def _skip_field(buf: bytes, pos: int, wire: int) -> int:
    if wire == _WIRE_VARINT:
        _, pos = _decode_varint(buf, pos)
    elif wire == _WIRE_I64:
        pos += 8
    elif wire == _WIRE_LEN:
        size, pos = _decode_varint(buf, pos)
        pos += size
    elif wire == _WIRE_I32:
        pos += 4
    else:
        raise ValueError(f"unsupported wire type {wire}")
    return pos


def _iter_fields(buf: bytes):
    pos = 0
    end = len(buf)
    while pos < end:
        key, pos = _decode_varint(buf, pos)
        field, wire = key >> 3, key & 0x7
        if wire == _WIRE_LEN:
            size, pos = _decode_varint(buf, pos)
            yield field, buf[pos : pos + size]
            pos += size
        elif wire == _WIRE_VARINT:
            value, pos = _decode_varint(buf, pos)
            yield field, value
        else:
            pos = _skip_field(buf, pos, wire)


def _signed64(value: int) -> int:
    return value - (1 << 64) if value >= (1 << 63) else value


def _decode_feature(buf: bytes) -> List[Any]:
    for field, payload in _iter_fields(buf):
        if field == 1:  # BytesList
            return [v for f, v in _iter_fields(payload) if f == 1]
        if field == 2:  # FloatList (packed or repeated)
            values: List[float] = []
            for f, v in _iter_fields(payload):
                if f != 1:
                    continue
                if isinstance(v, bytes):
                    values.extend(struct.unpack(f"<{len(v) // 4}f", v))
                else:  # non-packed i32 is impossible for float; ignore
                    pass
            return values
        if field == 3:  # Int64List (packed or repeated varints)
            ints: List[int] = []
            for f, v in _iter_fields(payload):
                if f != 1:
                    continue
                if isinstance(v, bytes):
                    pos = 0
                    while pos < len(v):
                        value, pos = _decode_varint(v, pos)
                        ints.append(_signed64(value))
                else:
                    ints.append(_signed64(v))
            return ints
    return []


def decode_example(data: bytes) -> Dict[str, List[Any]]:
    """Parse tf.train.Example bytes into {name: list-of-values}."""
    features: Dict[str, List[Any]] = {}
    for field, payload in _iter_fields(data):
        if field != 1 or not isinstance(payload, bytes):
            continue
        for entry_field, entry in _iter_fields(payload):
            if entry_field != 1 or not isinstance(entry, bytes):
                continue
            key = None
            value: List[Any] = []
            for f, v in _iter_fields(entry):
                if f == 1 and isinstance(v, bytes):
                    key = v.decode("utf-8")
                elif f == 2 and isinstance(v, bytes):
                    value = _decode_feature(v)
            if key is not None:
                features[key] = value
    return features
