"""Pre-normalization of raw NTU joint tensors.

Counterpart of ``skeleton_action_recognition_tpu/data/preprocess.py``.
Semantics of ``data_gen/preprocess.py:8-88``, four passes over
``(N, C, T, V, M)``:

1. **Null-frame padding** — per body: if the first frame is empty, compact
   valid frames to the front (dropping interior empties); then cyclically
   tile the valid prefix over the trailing empty block.
2. **Centering** — subtract body 0's per-frame spine joint (joint 1)
   position from every body, masking empty (joint, frame) entries so they
   stay zero.
3. **Z-alignment** — rotate all joints by the matrix that maps body 0 /
   frame 0's hip→spine bone onto the z axis.
4. **X-alignment** — likewise for the shoulder bone onto the x axis.

Two implementations with identical results:

* :func:`pre_normalize_np` — host-side numpy, vectorized per sample, a
  copy of the JAX package's (``cli/data_gen.py`` calls it);
* :func:`pre_normalize` — torch, batched over samples on the tensor's own
  device, the counterpart of the JAX package's ``vmap``-ed version.

Note the reference applies rotations to *all* frames including empty ones —
rotation of zeros is zeros, so skipping the empty-person/frame guards
changes nothing; both implementations exploit that.
"""

from __future__ import annotations

import numpy as np
import torch

from skeleton_action_recognition_tpu_torch.data import rotation


# --------------------------------------------------------------------------
# numpy implementation (host-side oracle + data_gen path)
# --------------------------------------------------------------------------

def _pad_person_np(person: np.ndarray) -> np.ndarray:
    """Pass-1 padding for one ``(T, V, C)`` body."""
    t = person.shape[0]
    frame_valid = person.sum((1, 2)) != 0
    if not frame_valid.any():
        return person
    if not frame_valid[0]:
        valid = person[frame_valid]
        person = np.zeros_like(person)
        person[: len(valid)] = valid
        frame_valid = person.sum((1, 2)) != 0
    last_valid = np.nonzero(frame_valid)[0].max()
    length = last_valid + 1
    if length < t:
        idx = np.arange(t)
        person = person[np.where(idx < length, idx, idx % length)]
    return person


def pre_normalize_np(
    data: np.ndarray, zaxis=(0, 1), xaxis=(8, 4)
) -> np.ndarray:
    """Vectorized numpy pre-normalization of ``(N, C, T, V, M)``."""
    n, c, t, v, m = data.shape
    s = np.transpose(data, (0, 4, 2, 3, 1)).copy()  # N, M, T, V, C

    for i in range(n):
        if s[i].sum() == 0:
            continue
        for p in range(m):
            if s[i, p].sum() == 0:
                continue
            s[i, p] = _pad_person_np(s[i, p])

        center = s[i, 0][:, 1:2, :].copy()  # (T, 1, C) spine of body 0
        for p in range(m):
            if s[i, p].sum() == 0:
                continue
            mask = (s[i, p].sum(-1) != 0)[..., None]
            s[i, p] = (s[i, p] - center) * mask

        bottom = s[i, 0, 0, zaxis[0]]
        top = s[i, 0, 0, zaxis[1]]
        axis = np.cross(top - bottom, [0, 0, 1])
        angle = rotation.angle_between_np(top - bottom, np.array([0.0, 0.0, 1.0]))
        mz = rotation.rotation_matrix_np(axis, angle)

        s[i] = np.einsum("ij,mtvj->mtvi", mz, s[i])

        rs = s[i, 0, 0, xaxis[0]]
        ls = s[i, 0, 0, xaxis[1]]
        axis = np.cross(rs - ls, [1, 0, 0])
        angle = rotation.angle_between_np(rs - ls, np.array([1.0, 0.0, 0.0]))
        mx = rotation.rotation_matrix_np(axis, angle)

        s[i] = np.einsum("ij,mtvj->mtvi", mx, s[i])

    return np.transpose(s, (0, 4, 2, 3, 1)).astype(data.dtype)


# --------------------------------------------------------------------------
# torch implementation (batched, on the tensor's device)
# --------------------------------------------------------------------------

def _gather_frames(s: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``s[n, m, idx[n, m, t]]`` for ``(N, M, T, V, C)`` bodies."""
    return torch.gather(
        s, 2, idx[..., None, None].expand(-1, -1, -1, *s.shape[3:])
    )


def _pad_persons(s: torch.Tensor) -> torch.Tensor:
    """Pass 1 on every ``(T, V, C)`` body of ``(N, M, T, V, C)``."""
    t = s.shape[2]
    frame_valid = s.sum((3, 4)) != 0
    # compaction when frame 0 is empty: a stable sort moves valid frames
    # first, in order
    order = torch.argsort((~frame_valid).to(torch.uint8), dim=-1,
                          stable=True)
    kept = torch.gather(frame_valid, 2, order)
    compacted = _gather_frames(s, order) * kept[..., None, None]
    s = torch.where(~frame_valid[..., :1, None, None], compacted, s)

    idx = torch.arange(t, device=s.device)
    last_valid = torch.where(s.sum((3, 4)) != 0, idx, -1).amax(-1)
    length = torch.clamp(last_valid + 1, min=1)[..., None]
    tiled = _gather_frames(s, torch.where(idx < length, idx, idx % length))
    return torch.where(frame_valid.any(-1)[..., None, None, None], tiled, s)


def _align(s: torch.Tensor, bone: torch.Tensor, target) -> torch.Tensor:
    """Rotate every joint of each sample of ``(N, M, T, V, C)`` by the
    matrix mapping its ``(N, 3)`` ``bone`` onto the axis ``target``."""
    target = bone.new_tensor(target).expand_as(bone)
    m = rotation.rotation_matrix(
        torch.linalg.cross(bone, target), rotation.angle_between(bone,
                                                                 target)
    )
    return torch.einsum("nij,nmtvj->nmtvi", m, s)


def pre_normalize(data: torch.Tensor, zaxis=(0, 1), xaxis=(8, 4)
                  ) -> torch.Tensor:
    """Pre-normalization of ``(N, C, T, V, M)`` on ``data``'s device, in
    its dtype."""
    s = data.permute(0, 4, 2, 3, 1)  # N, M, T, V, C
    person_valid = (s.sum((2, 3, 4)) != 0)[..., None, None, None]
    s = torch.where(person_valid, _pad_persons(s), s)

    center = s[:, :1, :, 1:2, :]  # the spine of body 0, every frame
    mask = (s.sum(-1, keepdim=True) != 0)
    s = torch.where(person_valid, (s - center) * mask, s)

    s = _align(s, s[:, 0, 0, zaxis[1]] - s[:, 0, 0, zaxis[0]],
               [0.0, 0.0, 1.0])
    s = _align(s, s[:, 0, 0, xaxis[0]] - s[:, 0, 0, xaxis[1]],
               [1.0, 0.0, 0.0])

    sample_valid = (data.sum((1, 2, 3, 4)) != 0)[:, None, None, None, None]
    return torch.where(sample_valid, s.permute(0, 4, 2, 3, 1), data)
