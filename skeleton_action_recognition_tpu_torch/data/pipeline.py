"""Host input pipeline: TFRecord shards into batches.

Counterpart of ``skeleton_action_recognition_tpu/data/pipeline.py``'s
``stream_transform`` and the in-RAM mode of ``TFRecordDataset`` as the GNN
trainer uses it: every shard decoded once into host memory, a global
permutation per epoch from a seeded numpy generator, ``drop_remainder``,
a per-batch transform and a prefetch thread. The same seed gives the same
batches as the JAX dataset. Its ``stream=True`` (larger than RAM) and
multi-host modes are not ported yet.
"""

from __future__ import annotations

import os
import queue
import threading
from concurrent import futures
from typing import Iterator, List, Optional, Tuple

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


class TFRecordDataset:
    """Batched iterator over a directory of TFRecord shards, decoded once
    into host memory."""

    def __init__(
        self,
        directory: str,
        batch_size: int,
        num_classes: int = 60,
        shuffle: bool = False,
        drop_remainder: bool = False,
        seed: int = 0,
        prefetch: int = 2,
        transform=None,
    ):
        records = sorted(
            os.path.join(directory, f)
            for f in os.listdir(directory)
            if f.endswith("tfrecord")
        )
        if not records:
            raise FileNotFoundError(f"no .tfrecord files in {directory}")
        self.records: List[str] = records
        self.batch_size = batch_size
        self.num_classes = num_classes
        self.shuffle = shuffle
        self.drop_remainder = drop_remainder
        self.prefetch = prefetch
        self.transform = transform
        self._rng = np.random.default_rng(seed)
        self._cache: Optional[Tuple[np.ndarray, np.ndarray]] = None
        self._count: Optional[int] = None

    def _load_all(self) -> Tuple[np.ndarray, np.ndarray]:
        """Decode every shard once (crcs checked), shards in parallel."""
        if self._cache is None:
            with futures.ThreadPoolExecutor(
                max_workers=min(len(self.records), _DECODE_THREADS)
            ) as pool:
                parts = [
                    p for p in pool.map(tfrecord.decode_shard, self.records)
                    if len(p[1])
                ]
            if not parts:
                raise ValueError("dataset has no records")
            self._cache = (
                np.concatenate([f for f, _ in parts]),
                np.concatenate([label for _, label in parts]),
            )
        return self._cache

    def num_samples(self) -> int:
        """Total record count, from the framing alone."""
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

    def batches(self) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        """Yield ``(features, one_hot_labels)`` batches, made by a
        background thread ``prefetch`` batches ahead. The epoch's
        permutation is drawn when the first batch is asked for."""
        data, labels = self._load_all()
        order = np.arange(len(data))
        if self.shuffle:
            order = self._rng.permutation(order)
        n = len(order)
        end = n - n % self.batch_size if self.drop_remainder else n

        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
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

        def producer():
            try:
                for i in range(0, end, self.batch_size):
                    idx = order[i: i + self.batch_size]
                    batch = data[idx]
                    if self.transform is not None:
                        batch = self.transform(batch)
                    one_hot = _one_hot(labels[idx], self.num_classes)
                    if not put((batch, one_hot)):
                        return
            except Exception as err:  # raised in the consumer instead
                put(err)
                return
            put(done)

        thread = threading.Thread(target=producer, daemon=True)
        thread.start()
        try:
            while (item := q.get()) is not done:
                if isinstance(item, Exception):
                    raise item
                yield item
        finally:
            # a consumer that stops early (or is closed) ends the thread
            stop.set()
            thread.join()
