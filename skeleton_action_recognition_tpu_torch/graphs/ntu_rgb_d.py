"""NTU RGB+D 25-joint skeleton graph: the spatial-partition adjacency, the
bone pairs and the VirtualRadar edge list.

Counterpart of ``skeleton_action_recognition_tpu/graphs/ntu_rgb_d.py`` and
``graphs/tools.py`` with the ``'spatial'`` labeling only, the one ST-GCN
uses: ``(3, V, V)`` ``[I, norm(In), norm(Out)]`` with ``A[dst, src] = 1``
per directed edge and each column divided by its in-degree.
"""

from __future__ import annotations

import numpy as np

NUM_JOINTS = 25

# 1-indexed (child, parent) pairs toward the spine
_INWARD_1INDEXED = [
    (1, 2), (2, 21), (3, 21), (4, 3), (5, 21), (6, 5), (7, 6),
    (8, 7), (9, 21), (10, 9), (11, 10), (12, 11), (13, 1),
    (14, 13), (15, 14), (16, 15), (17, 1), (18, 17), (19, 18),
    (20, 19), (22, 23), (23, 8), (24, 25), (25, 12),
]
INWARD = [(i - 1, j - 1) for (i, j) in _INWARD_1INDEXED]
OUTWARD = [(j, i) for (i, j) in INWARD]

# the 25 directed 1-indexed (joint, parent) pairs of the bone stream,
# including the self-pair (21, 21), which gives a zero bone at the spine
BONE_PAIRS = (
    (1, 2), (2, 21), (3, 21), (4, 3), (5, 21), (6, 5), (7, 6), (8, 7),
    (9, 21), (10, 9), (11, 10), (12, 11), (13, 1), (14, 13), (15, 14),
    (16, 15), (17, 1), (18, 17), (19, 18), (20, 19), (22, 23), (21, 21),
    (23, 8), (24, 25), (25, 12),
)

# the VirtualRadar layer's pruned 0-indexed (src, dst) bone list: the 24
# bones whose returns the spectrogram model sums
RADAR_EDGES = [
    (0, 1), (1, 20), (20, 2), (2, 3), (20, 4), (4, 5), (5, 6), (6, 7),
    (7, 21), (7, 22), (20, 8), (8, 9), (9, 10), (10, 11), (11, 23),
    (11, 24), (0, 16), (0, 12), (12, 13), (13, 14), (14, 15), (16, 17),
    (17, 18), (18, 19),
]


def _normalized(edges) -> np.ndarray:
    a = np.zeros((NUM_JOINTS, NUM_JOINTS))
    for i, j in edges:
        a[j, i] = 1.0
    degree = a.sum(axis=0)
    return a / np.where(degree > 0, degree, 1.0)


def spatial_adjacency() -> np.ndarray:
    """The ``(3, 25, 25)`` float32 spatial-partition stack."""
    return np.stack(
        [np.eye(NUM_JOINTS), _normalized(INWARD), _normalized(OUTWARD)]
    ).astype(np.float32)
