"""Streaming metrics: CE mean, top-1/top-5 accuracy, confusion matrix.

A copy of ``skeleton_action_recognition_tpu/train/metrics.py`` (pure
numpy): equivalents of the Keras metric set and the sklearn confusion
matrix the trainers render to TensorBoard, as plain accumulators over the
summed statistics the train/eval steps emit.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


@dataclass
class Mean:
    total: float = 0.0
    count: int = 0

    def update(self, value: float, n: int = 1):
        self.total += float(value) * n
        self.count += n

    def result(self) -> float:
        return self.total / max(self.count, 1)

    def reset(self):
        self.total, self.count = 0.0, 0


@dataclass
class Accuracy:
    correct: int = 0
    count: int = 0

    def update(self, correct: int, count: int):
        self.correct += int(correct)
        self.count += int(count)

    def result(self) -> float:
        return self.correct / max(self.count, 1)

    def reset(self):
        self.correct, self.count = 0, 0


@dataclass
class ConfusionMatrix:
    num_classes: int = 60
    matrix: np.ndarray = field(default=None)  # type: ignore[assignment]

    def __post_init__(self):
        if self.matrix is None:
            self.matrix = np.zeros(
                (self.num_classes, self.num_classes), np.int64
            )

    def update(self, y_true, y_pred):
        y_true = np.asarray(y_true).reshape(-1)
        y_pred = np.asarray(y_pred).reshape(-1)
        np.add.at(self.matrix, (y_true, y_pred), 1)

    def result(self) -> np.ndarray:
        return self.matrix

    def normalized(self) -> np.ndarray:
        row = self.matrix.sum(axis=1, keepdims=True)
        return np.where(row > 0, self.matrix / np.maximum(row, 1), 0.0)

    def reset(self):
        self.matrix[...] = 0


def unstack_steps(metrics: dict):
    """Split a metrics dict whose leaves are stacked ``(K,)`` arrays
    (K steps' metrics) into K per-step dicts; a plain single-step dict
    (scalar leaves) yields ``[metrics]``."""
    count = np.asarray(metrics["count"])
    if count.ndim == 0:
        return [metrics]
    return [
        {k: np.asarray(v)[i] for k, v in metrics.items()}
        for i in range(count.shape[0])
    ]
