"""NTU RGB+D ``.skeleton`` file parsing and body selection (numpy).

Counterpart of ``skeleton_action_recognition_tpu/data/skeleton.py``, with
the same constants and results.

Format (per ``data_gen/gen_joint_data.py:22-62``): a text file with the
frame count, then per frame the body count, and per body one line of 10
tracking-info fields, the joint count, and one line of 12 floats per joint
(x, y, z, depth/color coords, orientation quaternion, tracking state).
Only the first 3 fields (x, y, z) are retained.

Body selection (``gen_joint_data.py:65-90``): clips are captured with up to
``max_body=4`` tracked bodies; the two with the highest motion energy
(sum of per-channel standard deviations over valid frames) are kept.
"""

from __future__ import annotations

import os
import re
from typing import List, Optional, Tuple

import numpy as np

# Split constants (gen_joint_data.py:9-16).
TRAINING_SUBJECTS = (
    1, 2, 4, 5, 8, 9, 13, 14, 15, 16, 17, 18, 19, 25, 27, 28, 31, 34, 35, 38,
)
TRAINING_CAMERAS = (2, 3)
MAX_BODY_TRUE = 2
MAX_BODY_KINECT = 4
NUM_JOINTS = 25
MAX_FRAMES = 300

_NAME_RE = re.compile(r"S(\d{3})C(\d{3})P(\d{3})R(\d{3})A(\d{3})")


def sample_metadata(filename: str) -> Tuple[int, int, int, int, int]:
    """Parse ``SsssCcccPpppRrrrAaaa`` -> (setup, camera, subject,
    replication, action). Matches the substring parses at
    ``gen_joint_data.py:113-118``."""
    m = _NAME_RE.search(os.path.basename(filename))
    if not m:
        raise ValueError(f"not an NTU sample name: {filename!r}")
    return tuple(int(g) for g in m.groups())  # type: ignore[return-value]


def parse_skeleton_file(path: str, num_joints: int = NUM_JOINTS):
    """Parse one ``.skeleton`` file into per-frame joint arrays.

    Returns ``(num_frames, joints)`` where ``joints`` is a list of
    ``(num_bodies_in_frame, num_joints, 3)`` float arrays.
    """
    with open(path, "r") as f:
        tokens = f.read().split()
    pos = 0

    def take(n):
        nonlocal pos
        out = tokens[pos : pos + n]
        pos += n
        return out

    num_frames = int(take(1)[0])
    frames = []
    for _ in range(num_frames):
        num_bodies = int(take(1)[0])
        bodies = np.zeros((num_bodies, num_joints, 3), np.float64)
        for b in range(num_bodies):
            take(10)  # body-info fields (ids, hand states, lean, tracking)
            nj = int(take(1)[0])
            vals = np.asarray(take(nj * 12), np.float64).reshape(nj, 12)
            keep = min(nj, num_joints)
            bodies[b, :keep] = vals[:keep, :3]
        frames.append(bodies)
    return num_frames, frames


def nonzero_std_energy(body: np.ndarray) -> float:
    """Motion energy: summed per-channel std over valid frames
    (``gen_joint_data.py:65-73``)."""
    valid = body.sum(-1).sum(-1) != 0
    sel = body[valid]
    if len(sel) == 0:
        return 0.0
    return float(
        sel[:, :, 0].std() + sel[:, :, 1].std() + sel[:, :, 2].std()
    )


def read_xyz(
    path: str,
    max_body: int = MAX_BODY_KINECT,
    num_joint: int = NUM_JOINTS,
    max_body_true: int = MAX_BODY_TRUE,
) -> np.ndarray:
    """Parse + select the ``max_body_true`` highest-energy bodies.

    Returns ``(3, T, V, max_body_true)`` like ``gen_joint_data.py:76-93``.
    This is the JAX package's Python tokenizer route; its C++ parser
    (``native/``, ~100x faster) is not ported, so the port parses at the
    Python route's rate.
    """
    num_frames, frames = parse_skeleton_file(path, num_joint)
    data = np.zeros((max_body, num_frames, num_joint, 3), np.float64)
    for t, bodies in enumerate(frames):
        n = min(len(bodies), max_body)
        data[:n, t] = bodies[:n]

    energy = np.array([nonzero_std_energy(b) for b in data])
    order = energy.argsort()[::-1][:max_body_true]
    data = data[order]
    return data.transpose(3, 1, 2, 0)


def load_ignored_samples(path: Optional[str]) -> List[str]:
    """Missing-skeleton skip list (``gen_joint_data.py:101-107``)."""
    if path is None or not os.path.exists(path):
        return []
    with open(path) as f:
        return [line.strip() + ".skeleton" for line in f if line.strip()]


def split_samples(
    filenames: List[str],
    benchmark: str,
    part: str,
    ignored: Optional[List[str]] = None,
) -> Tuple[List[str], List[int]]:
    """Benchmark/split filtering (``gen_joint_data.py:110-136``).

    ``benchmark``: ``'xview'`` (camera split) or ``'xsub'`` (subject split);
    ``part``: ``'train'`` or ``'val'``. Returns (names, 0-based labels).
    """
    ignored_set = set(ignored or [])
    if part not in ("train", "val"):
        raise ValueError(f"unknown part: {part!r}")
    names, labels = [], []
    for fn in filenames:
        if os.path.basename(fn) in ignored_set:
            continue
        _, camera, subject, _, action = sample_metadata(fn)
        if benchmark == "xview":
            is_training = camera in TRAINING_CAMERAS
        elif benchmark == "xsub":
            is_training = subject in TRAINING_SUBJECTS
        else:
            raise ValueError(f"unknown benchmark: {benchmark!r}")
        keep = is_training if part == "train" else not is_training
        if keep:
            names.append(fn)
            labels.append(action - 1)
    return names, labels
