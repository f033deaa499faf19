"""Rotation math (Rodrigues axis-angle), numpy and torch variants.

Counterpart of ``skeleton_action_recognition_tpu/data/rotation.py``.
Semantics match ``data_gen/rotation.py:5-42`` including the degenerate
guards: near-zero axis or angle yields the identity; near-zero vectors give
a zero angle; the axis-angle matrix is built from quaternion components
with the *negated* axis convention the reference uses.

The torch variants take any leading batch shape (``(..., 3)`` vectors,
``(...)`` angles) and compute on their inputs' device, where the JAX ones
take one vector and are ``vmap``-ed.
"""

from __future__ import annotations

import numpy as np
import torch


def rotation_matrix_np(axis, theta) -> np.ndarray:
    if np.abs(axis).sum() < 1e-6 or np.abs(theta) < 1e-6:
        return np.eye(3)
    axis = np.asarray(axis, np.float64)
    axis = axis / np.sqrt(axis @ axis)
    a = np.cos(theta / 2.0)
    b, c, d = -axis * np.sin(theta / 2.0)
    return np.array(
        [
            [a * a + b * b - c * c - d * d, 2 * (b * c + a * d), 2 * (b * d - a * c)],
            [2 * (b * c - a * d), a * a + c * c - b * b - d * d, 2 * (c * d + a * b)],
            [2 * (b * d + a * c), 2 * (c * d - a * b), a * a + d * d - b * b - c * c],
        ]
    )


def angle_between_np(v1, v2) -> float:
    if np.abs(v1).sum() < 1e-6 or np.abs(v2).sum() < 1e-6:
        return 0.0
    u1 = v1 / np.linalg.norm(v1)
    u2 = v2 / np.linalg.norm(v2)
    return float(np.arccos(np.clip(u1 @ u2, -1.0, 1.0)))


def rotation_matrix(axis: torch.Tensor, theta: torch.Tensor) -> torch.Tensor:
    """``(..., 3)`` axes and ``(...)`` angles -> ``(..., 3, 3)`` matrices,
    with the same degenerate-input guards."""
    degenerate = (axis.abs().sum(-1) < 1e-6) | (theta.abs() < 1e-6)
    safe_axis = torch.where(
        degenerate[..., None], axis.new_tensor([1.0, 0.0, 0.0]), axis
    )
    safe_axis = safe_axis / torch.sqrt((safe_axis * safe_axis).sum(-1,
                                                                   True))
    a = torch.cos(theta / 2.0)
    bcd = -safe_axis * torch.sin(theta / 2.0)[..., None]
    b, c, d = bcd.unbind(-1)
    m = torch.stack([
        torch.stack([a * a + b * b - c * c - d * d, 2 * (b * c + a * d),
                     2 * (b * d - a * c)], -1),
        torch.stack([2 * (b * c - a * d), a * a + c * c - b * b - d * d,
                     2 * (c * d + a * b)], -1),
        torch.stack([2 * (b * d + a * c), 2 * (c * d - a * b),
                     a * a + d * d - b * b - c * c], -1),
    ], -2)
    eye = torch.eye(3, dtype=m.dtype, device=m.device)
    return torch.where(degenerate[..., None, None], eye, m)


def angle_between(v1: torch.Tensor, v2: torch.Tensor) -> torch.Tensor:
    """Angle between ``(..., 3)`` vectors, ``(...)``; 0 where either is
    near zero."""
    degenerate = (v1.abs().sum(-1) < 1e-6) | (v2.abs().sum(-1) < 1e-6)
    n1 = torch.linalg.vector_norm(v1, dim=-1)
    n2 = torch.linalg.vector_norm(v2, dim=-1)
    cos = (v1 * v2).sum(-1) / torch.where(
        degenerate, torch.ones_like(n1), n1 * n2
    )
    return torch.where(
        degenerate, torch.zeros_like(cos),
        torch.arccos(torch.clamp(cos, -1.0, 1.0)),
    )
