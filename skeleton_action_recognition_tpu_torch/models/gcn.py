"""ST-GCN spatial graph conv layer (channels-last).

Counterpart of ``skeleton_action_recognition_tpu/models/gcn.py``'s
``GraphConvTD``. Adjacency ``A[k, v, w]`` routes source joint ``v`` into
destination ``w`` in partition ``k``.
"""

from __future__ import annotations

import torch.nn as nn

from skeleton_action_recognition_tpu_torch.models.layers import init_layer
from skeleton_action_recognition_tpu_torch.ops.sgcn import (
    K_PARTS,
    fused_graph_conv,
    graph_conv_reference,
)


class GraphConvTD(nn.Module):
    """ST-GCN spatial conv over ``(N, T, V, C)``.

    One 1x1 conv gives ``K * filters`` channels (partition-major), which are
    contracted against the ``(K, V, V)`` spatial-partition stack:
    ``out[.., w, c] = sum_k sum_v A[k, v, w] z[.., v, k, c]``.

    ``fused=True`` runs the CUDA kernels (:func:`..ops.sgcn.fused_graph_conv`,
    an autograd Function) that keep ``z`` and, in the backward, ``dz`` on
    chip. Both paths share the ``Dense_0`` parameters, as in the JAX
    package. The fused path takes the adjacency as a constant, so a
    trainable adjacency (one that requires grad) raises there.
    """

    def __init__(
        self, in_channels: int, filters: int, dtype=None,
        fused: bool = False, generator=None,
    ):
        super().__init__()
        self.dtype = dtype
        self.fused = fused
        self.Dense_0 = init_layer(
            nn.Linear(in_channels, K_PARTS * filters), generator
        )

    def forward(self, x, a):
        x = x.to(self.dtype or x.dtype)
        if self.fused:
            if a.requires_grad:
                raise ValueError(
                    "the fused spatial conv takes the adjacency as a "
                    "constant; it cannot train it (trainable_adjacency)"
                )
            return fused_graph_conv(
                x.contiguous(), self.Dense_0.weight, self.Dense_0.bias, a
            )
        return graph_conv_reference(
            x, self.Dense_0.weight, self.Dense_0.bias, a
        )
