"""The GNN trainer's learning-rate schedule.

Counterpart of ``skeleton_action_recognition_tpu/train/schedules.py``'s
piecewise-constant SGD schedule with 10x decays at iteration boundaries.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np


def reference_gnn_boundaries(
    step_epochs: Sequence[int], batch_size: int,
    samples_per_epoch: int = 40000,
):
    """Iteration boundaries of the reference trainer (``main_gnn.py:303``),
    which counts 40000 samples to an epoch."""
    return [(s * samples_per_epoch) // batch_size for s in step_epochs]


def piecewise_constant(base_lr: float, boundaries: Sequence[int],
                       decay=0.1):
    """``base_lr * decay^i`` after the i-th boundary, as a function of the
    step count.

    Matches TF ``PiecewiseConstantDecay`` and the JAX package: boundaries
    are left-inclusive (``values[0]`` while ``count <= boundaries[0]``),
    and the values are float32, as the JAX schedule's are."""
    bounds = list(boundaries)
    values = [
        float(np.float32(base_lr * decay**i)) for i in range(len(bounds) + 1)
    ]

    def schedule(count: int) -> float:
        return values[sum(count > b for b in bounds)]

    return schedule
