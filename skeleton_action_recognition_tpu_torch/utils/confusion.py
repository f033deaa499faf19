"""Confusion-matrix rendering to PNG, for TensorBoard image summaries.

Counterpart of ``skeleton_action_recognition_tpu/utils/confusion.py``,
which draws with matplotlib. The card's machine has no matplotlib, so the
row-normalized matrix is drawn here as a heatmap of square cells (white for
0 to orange for 1) and encoded as an RGBA PNG with ``zlib``; the per-cell
text annotations of the JAX package are left out.
"""

from __future__ import annotations

import struct
import zlib
from typing import Tuple

import numpy as np

_LOW = np.array([255, 245, 235], np.float64)  # matplotlib "Oranges" ends
_HIGH = np.array([127, 39, 4], np.float64)


def _chunk(kind: bytes, data: bytes) -> bytes:
    body = kind + data
    return (
        struct.pack(">I", len(data)) + body
        + struct.pack(">I", zlib.crc32(body) & 0xFFFFFFFF)
    )


def encode_png(rgba: np.ndarray) -> bytes:
    """``(H, W, 4)`` uint8 -> PNG bytes."""
    h, w, _ = rgba.shape
    raw = b"".join(
        b"\x00" + row.tobytes() for row in np.ascontiguousarray(rgba)
    )
    header = struct.pack(">IIBBBBB", w, h, 8, 6, 0, 0, 0)
    return (
        b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", header)
        + _chunk(b"IDAT", zlib.compress(raw, 6)) + _chunk(b"IEND", b"")
    )


def confusion_matrix_png(cm: np.ndarray, cell: int = 8
                         ) -> Tuple[bytes, int, int]:
    """Render a confusion matrix, row-normalized, ``cell`` pixels a class;
    returns ``(png_bytes, height, width)``."""
    cm = np.asarray(cm, np.float64)
    row = cm.sum(axis=1, keepdims=True)
    norm = cm / np.maximum(row, 1)
    rgb = _LOW + norm[..., None] * (_HIGH - _LOW)
    rgba = np.concatenate(
        [rgb, np.full(norm.shape + (1,), 255.0)], axis=-1
    ).round().astype(np.uint8)
    rgba = rgba.repeat(cell, axis=0).repeat(cell, axis=1)
    return encode_png(rgba), rgba.shape[0], rgba.shape[1]
