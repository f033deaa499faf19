"""Bone and motion stream derivation (numpy).

Counterpart of ``skeleton_action_recognition_tpu/data/streams.py``:

* bone: ``bone[..., v1-1, :] = joint[..., v1-1, :] - joint[..., v2-1, :]``
  over the 25 directed 1-indexed pairs of ``BONE_PAIRS``;
* motion: ``motion[t] = x[t+1] - x[t]`` with the final frame zeroed.

Both take any leading batch layout ``(..., C, T, V, M)``.
"""

from __future__ import annotations

import numpy as np

from skeleton_action_recognition_tpu_torch.graphs.ntu_rgb_d import BONE_PAIRS

_V1 = np.asarray([p[0] - 1 for p in BONE_PAIRS])
_V2 = np.asarray([p[1] - 1 for p in BONE_PAIRS])


def bone_stream(joint: np.ndarray) -> np.ndarray:
    """``(..., C, T, V, M)`` joints -> same-shape bone vectors."""
    if joint.shape[-2] != len(BONE_PAIRS):
        raise ValueError(
            f"expected V={len(BONE_PAIRS)} joints, got {joint.shape[-2]}"
        )
    out = joint[..., _V1, :] - joint[..., _V2, :]
    # scatter back into v1 order (v1 covers 0..24 once each)
    order = np.empty(len(BONE_PAIRS), np.intp)
    order[_V1] = np.arange(len(BONE_PAIRS))
    return out[..., order, :]


def motion_stream(x: np.ndarray) -> np.ndarray:
    """``(..., C, T, V, M)`` -> frame-difference stream, last frame zero."""
    diff = x[..., 1:, :, :] - x[..., :-1, :, :]
    return np.concatenate([diff, np.zeros_like(x[..., :1, :, :])], axis=-3)
