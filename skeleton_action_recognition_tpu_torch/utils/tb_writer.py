"""TensorBoard event-file writer (no TensorFlow or TensorBoard).

Counterpart of ``skeleton_action_recognition_tpu/utils/tb_writer.py``:
event files are TFRecord-framed serialized ``Event`` protos, so this reuses
the port's TFRecord framing and wire-format helpers. Scalars and PNG
images, the two summary kinds the trainers emit.
"""

from __future__ import annotations

import os
import socket
import struct
import time
from typing import Optional

from skeleton_action_recognition_tpu_torch.data import proto
from skeleton_action_recognition_tpu_torch.data.tfrecord import (
    TFRecordWriter,
)


def _double_field(field: int, value: float) -> bytes:
    return proto._key(field, 1) + struct.pack("<d", value)


def _float_field(field: int, value: float) -> bytes:
    return proto._key(field, 5) + struct.pack("<f", value)


class SummaryWriter:
    """Minimal TB writer: ``add_scalar`` / ``add_image_png`` / ``flush``."""

    def __init__(self, log_dir: str):
        os.makedirs(log_dir, exist_ok=True)
        fname = (
            f"events.out.tfevents.{int(time.time())}."
            f"{socket.gethostname()}"
        )
        self.path = os.path.join(log_dir, fname)
        self._writer = TFRecordWriter(self.path)
        self._write_event(  # file-header event
            proto._len_field(3, b"brain.Event:2"), step=None
        )

    def _write_event(self, body: bytes, step: Optional[int]):
        event = _double_field(1, time.time())
        if step is not None:
            event += proto._varint_field(2, step)
        event += body
        self._writer.write(event)

    def add_scalar(self, tag: str, value: float, step: int):
        value_msg = proto._len_field(1, tag.encode()) + _float_field(
            2, float(value)
        )
        summary = proto._len_field(1, value_msg)
        self._write_event(proto._len_field(5, summary), step)

    def add_image_png(
        self, tag: str, png_bytes: bytes, height: int, width: int, step: int
    ):
        image = (
            proto._varint_field(1, height)
            + proto._varint_field(2, width)
            + proto._varint_field(3, 4)  # RGBA colorspace
            + proto._len_field(4, png_bytes)
        )
        value_msg = proto._len_field(1, tag.encode()) + proto._len_field(
            4, image
        )
        summary = proto._len_field(1, value_msg)
        self._write_event(proto._len_field(5, summary), step)

    def flush(self):
        self._writer.flush()

    def close(self):
        self._writer.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class NullWriter:
    """A :class:`SummaryWriter` that writes nothing: the trainers' ranks
    other than 0 in a process group, where rank 0 writes the run's
    summaries."""

    def add_scalar(self, tag: str, value: float, step: int):
        pass

    def add_image_png(self, *args, **kwargs):
        pass

    def close(self):
        pass
