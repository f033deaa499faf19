"""Skeleton graph construction (numpy)."""

from skeleton_action_recognition_tpu_torch.graphs.tools import (
    edge2mat,
    get_spatial_graph,
    normalize_digraph,
)
from skeleton_action_recognition_tpu_torch.graphs.ntu_rgb_d import (
    BONE_PAIRS,
    INWARD,
    NEIGHBOR,
    NUM_JOINTS,
    OUTWARD,
    RADAR_EDGES,
    SELF_LINK,
    Graph,
    spatial_adjacency,
)

__all__ = [
    "BONE_PAIRS",
    "Graph",
    "INWARD",
    "NEIGHBOR",
    "NUM_JOINTS",
    "OUTWARD",
    "RADAR_EDGES",
    "SELF_LINK",
    "edge2mat",
    "get_spatial_graph",
    "normalize_digraph",
    "spatial_adjacency",
]
