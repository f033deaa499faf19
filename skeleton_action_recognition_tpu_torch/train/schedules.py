"""The trainers' learning-rate schedules.

Counterpart of ``skeleton_action_recognition_tpu/train/schedules.py``: the
GNN trainer's piecewise-constant SGD schedule with 10x decays at iteration
boundaries, and the spectrogram trainer's triangular cycle. Each is a
function of the optimizer's step count, taken before the count is
incremented (as optax and Keras take it), returning a Python float.
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


def cyclic_triangular(base_lr: float, max_lr: float, step_size_up: int):
    """torch ``CyclicLR(mode='triangular', cycle_momentum=False)`` as the
    JAX package writes it, ``lr(t) = base + (max - base) * max(0, 1 -
    |t / step - 2 cycle + 1|)`` with ``cycle = floor(1 + t / (2 step))``,
    evaluated in float32 as JAX evaluates it."""
    f32 = np.float32
    base, top, step = f32(base_lr), f32(max_lr), f32(step_size_up)

    def schedule(count: int) -> float:
        t = f32(count)
        cycle = np.floor(f32(1.0) + t / (f32(2.0) * step))
        x = np.abs(t / step - f32(2.0) * cycle + f32(1.0))
        return float(base + (top - base) * np.maximum(f32(0.0), f32(1.0) - x))

    return schedule
