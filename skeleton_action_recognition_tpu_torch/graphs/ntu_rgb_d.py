"""NTU RGB+D 25-joint skeleton graph: its labelings, the bone pairs and the
VirtualRadar edge list.

Counterpart of ``skeleton_action_recognition_tpu/graphs/ntu_rgb_d.py``:

* ``'spatial'`` labeling: ``(3, V, V)`` ``[I, norm(In), norm(Out)]`` with
  ``A[dst, src] = 1`` per directed edge and each column divided by its
  in-degree (ST-GCN, ST-PGCN, ST-PGCN-P; ST-GIN takes its first two);
* ``'GIN'`` labeling: the binary stack without the identity, ``(2, V, V)``.
"""

from __future__ import annotations

import numpy as np

from skeleton_action_recognition_tpu_torch.graphs import tools

NUM_JOINTS = 25

SELF_LINK = [(i, i) for i in range(NUM_JOINTS)]

# 1-indexed (child, parent) pairs toward the spine
_INWARD_1INDEXED = [
    (1, 2), (2, 21), (3, 21), (4, 3), (5, 21), (6, 5), (7, 6),
    (8, 7), (9, 21), (10, 9), (11, 10), (12, 11), (13, 1),
    (14, 13), (15, 14), (16, 15), (17, 1), (18, 17), (19, 18),
    (20, 19), (22, 23), (23, 8), (24, 25), (25, 12),
]
INWARD = [(i - 1, j - 1) for (i, j) in _INWARD_1INDEXED]
OUTWARD = [(j, i) for (i, j) in INWARD]
NEIGHBOR = INWARD + OUTWARD

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


class Graph:
    """NTU RGB+D skeleton graph; ``A`` is the adjacency stack of
    ``labeling_mode`` (``'spatial'`` or ``'GIN'``) in float64."""

    def __init__(self, labeling_mode: str = "spatial"):
        self.num_node = NUM_JOINTS
        self.self_link = SELF_LINK
        self.inward = INWARD
        self.outward = OUTWARD
        self.neighbor = NEIGHBOR
        self.A = self.get_adjacency_matrix(labeling_mode)

    def get_adjacency_matrix(self, labeling_mode: str) -> np.ndarray:
        if labeling_mode == "spatial":
            return tools.get_spatial_graph(
                NUM_JOINTS, SELF_LINK, INWARD, OUTWARD
            )
        if labeling_mode == "GIN":
            return tools.get_spatial_graph(
                NUM_JOINTS, SELF_LINK, INWARD, OUTWARD, normalize=False
            )[1:]
        raise ValueError(f"unknown labeling_mode: {labeling_mode!r}")


def spatial_adjacency() -> np.ndarray:
    """The ``(3, 25, 25)`` float32 spatial-partition stack."""
    return Graph("spatial").A.astype(np.float32)
