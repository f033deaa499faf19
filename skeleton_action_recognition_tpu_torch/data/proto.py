"""Minimal protobuf wire-format encode/decode (no protobuf dependency).

A copy of ``skeleton_action_recognition_tpu/data/proto.py`` (pure Python
and numpy).

Implements exactly the message subset the TFRecord data path needs:

* ``tf.train.Example`` / ``Features`` / ``Feature`` / ``BytesList`` /
  ``Int64List`` / ``FloatList`` (tensorflow/core/example/feature.proto);
* ``TensorProto`` + ``TensorShapeProto`` (tensorflow/core/framework/
  tensor.proto) as produced by ``tf.io.serialize_tensor`` for float32
  tensors.

Wire format: each field is a varint key ``(field_number << 3) | wire_type``
followed by a varint (type 0), 64-bit (type 1), length-delimited blob
(type 2), or 32-bit (type 5) payload.
"""

from __future__ import annotations

import struct
from typing import Dict, Iterator, List, Tuple

import numpy as np

_WIRE_VARINT = 0
_WIRE_64BIT = 1
_WIRE_LEN = 2
_WIRE_32BIT = 5


def encode_varint(value: int) -> bytes:
    out = bytearray()
    while True:
        bits = value & 0x7F
        value >>= 7
        if value:
            out.append(bits | 0x80)
        else:
            out.append(bits)
            return bytes(out)


def decode_varint(buf: bytes, pos: int) -> Tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def _key(field: int, wire: int) -> bytes:
    return encode_varint((field << 3) | wire)


def _len_field(field: int, payload: bytes) -> bytes:
    return _key(field, _WIRE_LEN) + encode_varint(len(payload)) + payload


def _varint_field(field: int, value: int) -> bytes:
    return _key(field, _WIRE_VARINT) + encode_varint(value)


def iter_fields(buf: bytes) -> Iterator[Tuple[int, int, object]]:
    """Yield ``(field_number, wire_type, value)`` over a message buffer."""
    pos = 0
    n = len(buf)
    while pos < n:
        key, pos = decode_varint(buf, pos)
        field, wire = key >> 3, key & 7
        if wire == _WIRE_VARINT:
            value, pos = decode_varint(buf, pos)
        elif wire == _WIRE_LEN:
            length, pos = decode_varint(buf, pos)
            value = buf[pos : pos + length]
            pos += length
        elif wire == _WIRE_64BIT:
            value = buf[pos : pos + 8]
            pos += 8
        elif wire == _WIRE_32BIT:
            value = buf[pos : pos + 4]
            pos += 4
        else:
            raise ValueError(f"unsupported wire type {wire}")
        yield field, wire, value


# --------------------------------------------------------------------------
# TensorProto (float32 via tensor_content, as tf.io.serialize_tensor emits)
# --------------------------------------------------------------------------

_DT_FLOAT = 1
_DT_INT64 = 9

_NP_TO_DT = {np.dtype(np.float32): _DT_FLOAT, np.dtype(np.int64): _DT_INT64}
_DT_TO_NP = {v: k for k, v in _NP_TO_DT.items()}


def encode_tensor(array: np.ndarray) -> bytes:
    """Serialize like ``tf.io.serialize_tensor`` (dtype + shape + raw LE)."""
    array = np.ascontiguousarray(array)
    dt = _NP_TO_DT.get(array.dtype)
    if dt is None:
        raise ValueError(f"unsupported dtype {array.dtype}")
    dims = b"".join(
        _len_field(2, _varint_field(1, int(d))) for d in array.shape
    )
    out = _varint_field(1, dt)
    out += _len_field(2, dims)
    out += _len_field(4, array.astype(array.dtype, copy=False).tobytes())
    return out


def decode_tensor(buf: bytes) -> np.ndarray:
    dtype = None
    shape: List[int] = []
    content = b""
    float_vals: List[float] = []
    for field, wire, value in iter_fields(buf):
        if field == 1 and wire == _WIRE_VARINT:
            dtype = _DT_TO_NP.get(value)
            if dtype is None:
                raise ValueError(f"unsupported TensorProto dtype {value}")
        elif field == 2 and wire == _WIRE_LEN:
            for f2, w2, v2 in iter_fields(value):
                if f2 == 2 and w2 == _WIRE_LEN:  # Dim message
                    for f3, w3, v3 in iter_fields(v2):
                        if f3 == 1 and w3 == _WIRE_VARINT:
                            shape.append(v3)
        elif field == 4 and wire == _WIRE_LEN:
            content = value
        elif field == 5 and wire == _WIRE_LEN:  # packed float_val
            float_vals = np.frombuffer(value, "<f4").tolist()
    if dtype is None:
        raise ValueError("TensorProto missing dtype")
    if content:
        return np.frombuffer(content, dtype.newbyteorder("<")).reshape(shape)
    return np.asarray(float_vals, dtype).reshape(shape)


# --------------------------------------------------------------------------
# tf.train.Example
# --------------------------------------------------------------------------

def encode_example(features: Dict[str, object]) -> bytes:
    """Build a serialized ``tf.train.Example``.

    Values may be ``bytes`` (BytesList), ``int`` (Int64List), ``float``
    (FloatList), or lists thereof.
    """
    entries = b""
    for name, value in features.items():
        if isinstance(value, bytes):
            feature = _len_field(1, _len_field(1, value))
        elif isinstance(value, (int, np.integer)):
            feature = _len_field(3, _len_field(1, encode_varint(int(value) & (2**64 - 1))))
        elif isinstance(value, float):
            feature = _len_field(2, _len_field(1, struct.pack("<f", value)))
        else:
            raise ValueError(f"unsupported feature type for {name!r}")
        entry = _len_field(1, name.encode()) + _len_field(2, feature)
        entries += _len_field(1, entry)
    return _len_field(1, entries)


def decode_example(buf: bytes) -> Dict[str, object]:
    """Parse a serialized Example into ``{name: bytes | int | floats}``."""
    out: Dict[str, object] = {}
    for field, _wire, features_buf in iter_fields(buf):
        if field != 1:
            continue
        for f2, _w2, entry in iter_fields(features_buf):
            if f2 != 1:
                continue
            name = None
            feature_buf = b""
            for f3, _w3, v3 in iter_fields(entry):
                if f3 == 1:
                    name = v3.decode()
                elif f3 == 2:
                    feature_buf = v3
            if name is None:
                continue
            for f4, _w4, v4 in iter_fields(feature_buf):
                if f4 == 1:  # BytesList
                    for f5, _w5, v5 in iter_fields(v4):
                        if f5 == 1:
                            out[name] = v5
                elif f4 == 3:  # Int64List (packed or unpacked)
                    vals = []
                    pos = 0
                    while pos < len(v4):
                        fk, pos = decode_varint(v4, pos)
                        if fk >> 3 == 1 and fk & 7 == _WIRE_LEN:
                            ln, pos = decode_varint(v4, pos)
                            end = pos + ln
                            while pos < end:
                                v, pos = decode_varint(v4, pos)
                                vals.append(_to_signed(v))
                        elif fk >> 3 == 1:
                            v, pos = decode_varint(v4, pos)
                            vals.append(_to_signed(v))
                    out[name] = vals[0] if len(vals) == 1 else vals
                elif f4 == 2:  # FloatList
                    for f5, w5, v5 in iter_fields(v4):
                        if f5 == 1 and w5 == _WIRE_LEN:
                            out[name] = np.frombuffer(v5, "<f4")
                        elif f5 == 1 and w5 == _WIRE_32BIT:
                            out[name] = np.frombuffer(v5, "<f4")
    return out


def _to_signed(v: int) -> int:
    return v - 2**64 if v >= 2**63 else v
