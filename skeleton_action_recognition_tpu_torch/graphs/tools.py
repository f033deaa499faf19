"""Adjacency-matrix construction (numpy, run once when a model is built).

Counterpart of ``skeleton_action_recognition_tpu/graphs/tools.py``:
directed edge lists become binary adjacency matrices with ``A[dst, src] =
1``, columns are normalized by their in-degree (``A @ D^-1``), and
ST-GCN's spatial labeling stacks ``[I, In, Out]``.
"""

from __future__ import annotations

from typing import Iterable, Sequence, Tuple

import numpy as np

Edge = Tuple[int, int]


def edge2mat(edges: Iterable[Edge], num_nodes: int) -> np.ndarray:
    """Binary adjacency with ``A[j, i] = 1`` for each directed edge
    ``(i, j)``: the column is the source, the row the destination."""
    a = np.zeros((num_nodes, num_nodes), dtype=np.float64)
    for i, j in edges:
        a[j, i] = 1.0
    return a


def normalize_digraph(a: np.ndarray) -> np.ndarray:
    """``A @ D^-1``: each column divided by its sum, zero columns kept."""
    degree = a.sum(axis=0)
    inv = np.where(degree > 0, 1.0 / np.where(degree > 0, degree, 1.0), 0.0)
    return a * inv[None, :]


def get_spatial_graph(
    num_nodes: int,
    self_link: Sequence[Edge],
    inward: Sequence[Edge],
    outward: Sequence[Edge],
    normalize: bool = True,
) -> np.ndarray:
    """The ``(3, V, V)`` stack ``[I, In, Out]``, with ``In`` and ``Out``
    column-normalized when ``normalize`` (ST-GCN's spatial partitioning)
    and binary otherwise (the GIN labeling)."""
    i = edge2mat(self_link, num_nodes)
    inw = edge2mat(inward, num_nodes)
    out = edge2mat(outward, num_nodes)
    if normalize:
        inw = normalize_digraph(inw)
        out = normalize_digraph(out)
    return np.stack([i, inw, out])
