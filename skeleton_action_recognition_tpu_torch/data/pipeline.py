"""Host input pipelines: TFRecord shards, or ``.npy`` arrays, into batches.

Counterpart of ``skeleton_action_recognition_tpu/data/pipeline.py``:
``stream_transform``; ``TFRecordDataset``, in RAM (every shard decoded once
into host memory, a global permutation per epoch) or streamed shard by
shard (``stream=True``, for data larger than RAM, with a cross-shard
reservoir shuffle), each with the per-process shard split
``records[process_index::process_count]``, ``drop_remainder``, a per-batch
transform and a prefetch thread; and ``NumpyDataset``, the spectrogram
trainer's ``.npy`` + pickled-label input. The seeded numpy generator is
drawn in the JAX datasets' order, so the same seed gives the same batches.
"""

from __future__ import annotations

import os
import pickle
import queue
import threading
from concurrent import futures
from typing import Callable, Iterator, List, Optional, Tuple

import numpy as np

from skeleton_action_recognition_tpu_torch.data import streams, tfrecord

_DECODE_THREADS = min(16, (os.cpu_count() or 1) * 2)


def _one_hot(labels: np.ndarray, num_classes: int) -> np.ndarray:
    out = np.zeros((len(labels), num_classes), np.float32)
    out[np.arange(len(labels)), labels] = 1.0
    return out


def stream_transform(name: str):
    """Batch transform deriving a stream from joint data on the fly:
    ``joint``, ``bone``, ``joint_motion`` or ``bone_motion``."""
    transforms = {
        "joint": lambda x: x,
        "bone": streams.bone_stream,
        "joint_motion": streams.motion_stream,
        "bone_motion": lambda x: streams.motion_stream(
            streams.bone_stream(x)
        ),
    }
    if name not in transforms:
        raise ValueError(f"unknown stream: {name!r}")
    return transforms[name]


def _prefetched(produce: Callable[[Callable], None],
                depth: int) -> Iterator:
    """Run ``produce(put)`` on a background thread, ``depth`` items ahead
    of the consumer, and yield what it puts. An exception in the producer
    is raised in the consumer; a consumer that stops early (or is closed)
    ends the thread."""
    q: "queue.Queue" = queue.Queue(maxsize=depth)
    stop = threading.Event()
    done = object()

    def put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                pass
        return False

    def run():
        try:
            produce(put)
        except Exception as err:  # raised in the consumer instead
            put(err)
            return
        put(done)

    thread = threading.Thread(target=run, daemon=True)
    thread.start()
    try:
        while (item := q.get()) is not done:
            if isinstance(item, Exception):
                raise item
            yield item
    finally:
        stop.set()
        thread.join()


class _Stop(Exception):
    """The consumer went away: the producer ends."""


class TFRecordDataset:
    """Batched iterator over a directory of TFRecord shards.

    Shards are split statically across processes (``process_index`` /
    ``process_count``), so each process reads a disjoint subset. With
    ``stream=False`` every shard of the subset is decoded once into host
    memory and each epoch draws a global permutation; with ``stream=True``
    each epoch decodes shard by shard, shuffling the shard order, each
    shard's records and, across shards, through a reservoir of
    ``shuffle_buffer`` samples (0: within-shard mixing only), as tf.data's
    ``shuffle(buffer_size)``.
    """

    def __init__(
        self,
        directory: str,
        batch_size: int,
        num_classes: int = 60,
        shuffle: bool = False,
        drop_remainder: bool = False,
        seed: int = 0,
        process_index: int = 0,
        process_count: int = 1,
        prefetch: int = 2,
        transform=None,
        stream: bool = False,
        shuffle_buffer: int = 1024,
    ):
        records = sorted(
            os.path.join(directory, f)
            for f in os.listdir(directory)
            if f.endswith("tfrecord")
        )
        if not records:
            raise FileNotFoundError(f"no .tfrecord files in {directory}")
        self.records: List[str] = records[process_index::process_count]
        self.batch_size = batch_size
        self.num_classes = num_classes
        self.shuffle = shuffle
        self.drop_remainder = drop_remainder
        self.prefetch = prefetch
        self.transform = transform
        self.stream = stream
        self.shuffle_buffer = shuffle_buffer
        self._rng = np.random.default_rng(seed)
        self._cache: Optional[Tuple[np.ndarray, np.ndarray]] = None
        self._count: Optional[int] = None
        self._shape: Optional[Tuple[int, ...]] = None

    def _sample_shape(self) -> Tuple[int, ...]:
        """Shape of one sample, from the first record of the first
        non-empty shard."""
        if self._shape is None:
            for path in self.records:
                payload = tfrecord.first_payload(path)
                if payload is not None:
                    self._shape = tuple(
                        tfrecord.parse_example(payload)[0].shape)
                    break
            else:
                raise ValueError("dataset has no records")
        return self._shape

    def _load_all(self) -> Tuple[np.ndarray, np.ndarray]:
        """Decode every shard once (crcs checked), shards in parallel: the
        native decoder releases the GIL."""
        if self._cache is None:
            shape = self._sample_shape()
            with futures.ThreadPoolExecutor(
                max_workers=min(len(self.records), _DECODE_THREADS)
            ) as pool:
                parts = list(pool.map(
                    lambda p: tfrecord.decode_shard(p, shape), self.records
                ))
            self._cache = (
                np.concatenate([f for f, _ in parts]),
                np.concatenate([label for _, label in parts]),
            )
        return self._cache

    def iter_decoded(self) -> Iterator[Tuple[np.ndarray, int]]:
        """Yield ``(features, label)`` of every record, shard by shard."""
        for payload in tfrecord.TFRecordReader(self.records):
            yield tfrecord.parse_example(payload)

    def num_samples(self) -> int:
        """Total record count, from the framing alone (``stream=True``
        never holds the corpus for it)."""
        if self._count is None:
            self._count = sum(
                tfrecord.count_records(p) for p in self.records
            )
        return self._count

    def __len__(self) -> int:
        n = self.num_samples()
        if self.drop_remainder:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _batch(self, feats: np.ndarray, labels: np.ndarray):
        if self.transform is not None:
            feats = self.transform(feats)
        return feats, _one_hot(labels, self.num_classes)

    def _stream_batches(self) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        """Decode shard by shard on the prefetch thread. The generator is
        drawn as the JAX dataset draws it: the shard order when the epoch
        starts, then each shard's permutation as the shard is reached and
        each reservoir pick as a sample leaves it."""
        shards = list(self.records)
        if self.shuffle:
            self._rng.shuffle(shards)
        use_reservoir = self.shuffle and self.shuffle_buffer > 0

        def produce(put):
            carry_x, carry_y = [], []
            reservoir: list = []

            def emit(x, y):
                carry_x.append(x)
                carry_y.append(y)
                if len(carry_x) == self.batch_size:
                    batch = self._batch(np.stack(carry_x).astype(np.float32),
                                        np.asarray(carry_y))
                    carry_x.clear(), carry_y.clear()
                    if not put(batch):
                        raise _Stop

            def pop():
                k = int(self._rng.integers(len(reservoir)))
                reservoir[k], reservoir[-1] = reservoir[-1], reservoir[k]
                emit(*reservoir.pop())

            for shard in shards:
                feats, labels = tfrecord.decode_shard(shard)
                order = np.arange(len(feats))
                if self.shuffle:
                    order = self._rng.permutation(order)
                for idx in order:
                    if use_reservoir:
                        reservoir.append((feats[idx], labels[idx]))
                        if len(reservoir) >= self.shuffle_buffer:
                            pop()
                    else:
                        emit(feats[idx], labels[idx])
            while reservoir:
                pop()
            if carry_x and not self.drop_remainder:
                put(self._batch(np.stack(carry_x).astype(np.float32),
                                np.asarray(carry_y)))

        def guarded(put):
            try:
                produce(put)
            except _Stop:
                pass

        return _prefetched(guarded, self.prefetch)

    def _ram_batches(self) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        data, labels = self._load_all()
        order = np.arange(len(data))
        if self.shuffle:
            order = self._rng.permutation(order)
        n = len(order)
        end = n - n % self.batch_size if self.drop_remainder else n

        def produce(put):
            for i in range(0, end, self.batch_size):
                idx = order[i: i + self.batch_size]
                if not put(self._batch(data[idx], labels[idx])):
                    return

        return _prefetched(produce, self.prefetch)

    def batches(self) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        """Yield ``(features, one_hot_labels)`` batches, made by a
        background thread ``prefetch`` batches ahead. The epoch's
        permutation (stream: its shard order) is drawn when the first
        batch is asked for."""
        yield from (self._stream_batches() if self.stream
                    else self._ram_batches())


class NumpyDataset:
    """Batches of a ``(N, 3, T, V, M)`` ``.npy`` array (memory-mapped) and
    the labels of a pickled ``(names, labels)`` pair, the reference
    spectrogram trainer's files: a permutation per epoch from a seeded
    numpy generator when ``shuffle``, ``drop_remainder``, and each batch's
    indices sorted, as the JAX dataset does. Unpickles ``label_path``:
    give it only a file of the dataset's own making."""

    def __init__(
        self,
        data_path: str,
        label_path: str,
        batch_size: int,
        num_classes: int = 60,
        shuffle: bool = False,
        drop_remainder: bool = False,
        seed: int = 0,
    ):
        with open(label_path, "rb") as f:
            _, labels = pickle.load(f, encoding="latin1")
        self.data = np.load(data_path, mmap_mode="r")
        self.labels = np.asarray(labels, np.int64)
        self.batch_size = batch_size
        self.num_classes = num_classes
        self.shuffle = shuffle
        self.drop_remainder = drop_remainder
        self._rng = np.random.default_rng(seed)

    def __len__(self) -> int:
        if self.drop_remainder:
            return len(self.labels) // self.batch_size
        return (len(self.labels) + self.batch_size - 1) // self.batch_size

    def batches(self) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        """Yield ``(float32 features, one_hot_labels)`` batches."""
        order = np.arange(len(self.labels))
        if self.shuffle:
            order = self._rng.permutation(order)
        if self.drop_remainder:
            order = order[: len(order) - len(order) % self.batch_size]
        for i in range(0, len(order), self.batch_size):
            idx = np.sort(order[i: i + self.batch_size])
            yield (
                np.asarray(self.data[idx], np.float32),
                _one_hot(self.labels[idx], self.num_classes),
            )
