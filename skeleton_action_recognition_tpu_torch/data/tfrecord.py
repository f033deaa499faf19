"""TFRecord container IO (no TensorFlow).

Counterpart of ``skeleton_action_recognition_tpu/data/tfrecord.py``; the
bytes written are the same. Record framing:

    uint64 LE   payload length
    uint32 LE   masked crc32c of the length bytes
    bytes       payload (a serialized tf.train.Example here)
    uint32 LE   masked crc32c of the payload

with ``masked = ((crc >> 15 | crc << 17) + 0xa282ead8) mod 2^32``.

As in the JAX package, :func:`crc32c`, :func:`count_records` and
:func:`decode_shard` go through the C++ runtime (:mod:`..native`) by
default; ``use_native=False`` takes the numpy route. A failed native build
raises rather than falling back. The numpy crc32c is vectorised
(:func:`crc32c_rows`): :class:`TFRecordReader` checks the records of a
shard together, each split into chunks whose crcs are taken side by side
and then combined.
"""

from __future__ import annotations

import functools
import os
import struct
from typing import Iterator, List, Optional, Tuple

import numpy as np

from skeleton_action_recognition_tpu_torch import native
from skeleton_action_recognition_tpu_torch.data import proto

_MASK_DELTA = 0xA282EAD8


def _make_table() -> np.ndarray:
    poly = 0x82F63B78
    table = np.zeros(256, np.uint32)
    for i in range(256):
        crc = i
        for _ in range(8):
            crc = (crc >> 1) ^ (poly if crc & 1 else 0)
        table[i] = crc
    return table


_TABLE = _make_table()


def _advance(crc: np.ndarray, columns: np.ndarray) -> np.ndarray:
    """Run the crc register ``crc (n,)`` over the bytes ``columns (L, n)``,
    one column of bytes a step (no init or final xor)."""
    low = np.empty(len(crc), np.uint8)
    for col in columns:
        np.bitwise_xor(crc, col, out=low, casting="unsafe")  # low byte
        crc = _TABLE.take(low) ^ (crc >> 8)
    return crc


@functools.cache
def _shift_tables(zeros: int) -> np.ndarray:
    """``(4, 256)``: the register after ``zeros`` zero bytes, from each byte
    value at each of its four byte positions. The register is linear over
    GF(2), so the shift of any state is the xor of its four bytes' rows."""
    start = (
        np.arange(256, dtype=np.uint32)[None, :]
        << (8 * np.arange(4, dtype=np.uint32))[:, None]
    ).reshape(-1)
    return _advance(start, np.zeros((zeros, 1), np.uint8)).reshape(4, 256)


def crc32c_rows(rows: np.ndarray) -> np.ndarray:
    """crc32c (Castagnoli) of each row of ``rows (n, L)`` uint8 ->
    ``(n,)`` uint32.

    The crc's initial value 0xFFFFFFFF is folded into the first four bytes
    (for this reflected crc, starting from ``s`` equals starting from 0
    with the data's first four bytes xored with ``s``), the rows are
    left-padded with zeros to ``m`` chunks of ``c`` bytes (zeros before
    the data leave a zero register at zero), the chunks' crcs are taken
    together, and ``state <- shift_c(state) ^ crc(chunk)`` combines them.
    """
    rows = np.asarray(rows, np.uint8)
    n, length = rows.shape
    if length < 4:
        crc = _advance(np.full(n, 0xFFFFFFFF, np.uint32), rows.T)
        return crc ^ np.uint32(0xFFFFFFFF)
    chunk = max(8, int(length**0.5))
    m = -(-length // chunk)
    padded = np.zeros((n, m * chunk), np.uint8)
    padded[:, m * chunk - length:] = rows
    padded[:, m * chunk - length: m * chunk - length + 4] ^= 0xFF
    columns = np.ascontiguousarray(
        padded.reshape(n * m, chunk).T
    )  # (chunk, n * m)
    parts = _advance(np.zeros(n * m, np.uint32), columns).reshape(n, m)
    shift = _shift_tables(chunk)
    state = np.zeros(n, np.uint32)
    for j in range(m):
        state = (
            shift[0][state & 0xFF] ^ shift[1][(state >> 8) & 0xFF]
            ^ shift[2][(state >> 16) & 0xFF] ^ shift[3][state >> 24]
            ^ parts[:, j]
        )
    return state ^ np.uint32(0xFFFFFFFF)


def crc32c(data: bytes, use_native: bool = True) -> int:
    if use_native:
        return native.crc32c(data)
    return int(crc32c_rows(np.frombuffer(data, np.uint8)[None])[0])


def _mask(crc):
    return ((crc >> 15 | crc << 17) + _MASK_DELTA) & 0xFFFFFFFF


def masked_crc32c(data: bytes) -> int:
    return _mask(crc32c(data))


class TFRecordWriter:
    """Streaming TFRecord writer."""

    def __init__(self, path: str):
        self._f = open(path, "wb")

    def write(self, payload: bytes) -> None:
        length = struct.pack("<Q", len(payload))
        self._f.write(length)
        self._f.write(struct.pack("<I", masked_crc32c(length)))
        self._f.write(payload)
        self._f.write(struct.pack("<I", masked_crc32c(payload)))

    def flush(self) -> None:
        self._f.flush()

    def close(self) -> None:
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def _frames(buf: bytes) -> List[Tuple[int, int]]:
    """``(offset, length)`` of each record's payload in a shard's bytes."""
    out = []
    pos = 0
    while pos + 12 <= len(buf):
        (length,) = struct.unpack_from("<Q", buf, pos)
        if pos + 16 + length > len(buf):
            raise IOError("truncated record")
        out.append((pos + 12, length))
        pos += 16 + length
    return out


def _check_crcs(buf: bytes, frames, path) -> None:
    """Check every record's two crcs, the records of one length
    together."""
    data = np.frombuffer(buf, np.uint8)
    offsets = np.asarray([o for o, _ in frames], np.int64)
    heads = data[(offsets - 12)[:, None] + np.arange(8)]
    want = np.frombuffer(
        b"".join(buf[o - 4: o] for o, _ in frames), "<u4"
    )
    if np.any(_mask(crc32c_rows(heads).astype(np.uint64)) != want):
        raise IOError(f"{path}: corrupt length crc")
    by_length: dict = {}
    for i, (_, length) in enumerate(frames):
        by_length.setdefault(length, []).append(i)
    for length, idx in by_length.items():
        starts = offsets[idx]
        payloads = data[starts[:, None] + np.arange(length)]
        want = np.frombuffer(
            b"".join(buf[s + length: s + length + 4] for s in starts), "<u4"
        )
        if np.any(_mask(crc32c_rows(payloads).astype(np.uint64)) != want):
            raise IOError(f"{path}: corrupt payload crc")


class TFRecordReader:
    """Iterate raw payloads of one or more TFRecord files; each file's crcs
    are checked together when it is opened."""

    def __init__(self, paths, check_crc: bool = True):
        if isinstance(paths, (str, os.PathLike)):
            paths = [paths]
        self.paths: List[str] = [str(p) for p in paths]
        self.check_crc = check_crc

    def __iter__(self) -> Iterator[bytes]:
        for path in self.paths:
            with open(path, "rb") as f:
                buf = f.read()
            frames = _frames(buf)
            if self.check_crc and frames:
                _check_crcs(buf, frames, path)
            for offset, length in frames:
                yield buf[offset: offset + length]


def count_records(path, use_native: bool = True) -> int:
    """Record count of one shard by walking the framing (no crc, no
    payload decode)."""
    if use_native:
        return native.count_records(str(path))
    count = 0
    with open(path, "rb") as f:
        while True:
            header = f.read(12)
            if len(header) < 12:
                break
            (length,) = struct.unpack("<Q", header[:8])
            f.seek(length + 4, os.SEEK_CUR)
            count += 1
    return count


def first_payload(path) -> Optional[bytes]:
    """The payload of a shard's first record (its crcs unchecked), or None
    for an empty shard."""
    with open(path, "rb") as f:
        header = f.read(12)
        if len(header) < 12:
            return None
        (length,) = struct.unpack("<Q", header[:8])
        payload = f.read(length)
    if len(payload) < length:
        raise IOError(f"{path}: truncated record")
    return payload


def decode_shard(path, sample_shape=None,
                 use_native: bool = True) -> Tuple[np.ndarray, np.ndarray]:
    """Decode one whole shard -> ``(feats (N, *shape) f32, labels (N,)
    i64)``, crcs checked; every record holds ``sample_shape`` (None: the
    first record's shape). The native decoder takes the whole shard in one
    call, without the GIL, so shards decode in parallel from threads."""
    if sample_shape is None:
        first = first_payload(path)
        if first is None:
            return np.empty((0,), np.float32), np.empty((0,), np.int64)
        sample_shape = parse_example(first)[0].shape
    if use_native:
        return native.decode_tfrecord(
            str(path), count_records(path), tuple(sample_shape))
    parsed = [parse_example(p) for p in TFRecordReader([str(path)])]
    feats = np.empty((len(parsed),) + tuple(sample_shape), np.float32)
    for i, (f, _) in enumerate(parsed):
        feats[i] = f.reshape(sample_shape)
    labels = np.asarray([label for _, label in parsed], np.int64)
    return feats, labels


def serialize_example(features: np.ndarray, label: int) -> bytes:
    """Skeleton sample -> serialized Example (a ``features`` BytesList
    holding a float32 TensorProto and an int64 ``label``)."""
    tensor = proto.encode_tensor(np.asarray(features, np.float32))
    return proto.encode_example(
        {"features": tensor, "label": int(label)}
    )


def parse_example(payload: bytes) -> Tuple[np.ndarray, int]:
    """Serialized Example -> ``(float32 array, label)``."""
    fields = proto.decode_example(payload)
    tensor = proto.decode_tensor(fields["features"])
    return tensor, int(fields["label"])  # type: ignore[arg-type]


def write_dataset(
    data: np.ndarray,
    labels: np.ndarray,
    out_dir: str,
    prefix: str,
    num_shards: int = 40,
    shuffle: bool = False,
    seed: Optional[int] = 0,
) -> List[str]:
    """Shard a ``(N, ...)`` array + labels into TFRecord files named
    ``{prefix}-{shard}.tfrecord``, optionally permuted from ``seed``, as
    the JAX package's ``write_dataset`` does."""
    os.makedirs(out_dir, exist_ok=True)
    n = len(labels)
    order = np.arange(n)
    if shuffle:
        order = np.random.default_rng(seed).permutation(n)
    per_shard = max(1, n // num_shards)
    paths = []
    writer = None
    shard = 0
    for i, idx in enumerate(order):
        if i % per_shard == 0 and shard < num_shards:
            if writer:
                writer.close()
            path = os.path.join(out_dir, f"{prefix}-{shard}.tfrecord")
            paths.append(path)
            writer = TFRecordWriter(path)
            shard += 1
        writer.write(serialize_example(data[idx], labels[idx]))
    if writer:
        writer.close()
    return paths


def read_dataset(directory: str):
    """Yield ``(features, label)`` from every ``*.tfrecord`` in a dir."""
    records = sorted(
        os.path.join(directory, f)
        for f in os.listdir(directory)
        if f.endswith("tfrecord")
    )
    for payload in TFRecordReader(records):
        yield parse_example(payload)
