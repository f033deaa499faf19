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
    fused_graph_conv_stats,
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

    ``emit_stats=True`` (with ``fused``): in training the layer returns
    ``(out, s, ss)``, the output and its f32 per-channel sums of ``out``
    and ``out**2`` from the kernel's epilogue, for a BatchNorm fed by them
    (:class:`..stgcn.StatsTemporalConv`); in eval it returns ``out`` alone,
    through the plain fused kernel.
    """

    def __init__(
        self, in_channels: int, filters: int, dtype=None,
        fused: bool = False, emit_stats: bool = False, generator=None,
    ):
        super().__init__()
        self.dtype = dtype
        self.fused = fused
        self.emit_stats = emit_stats
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
            op = (fused_graph_conv_stats if self.emit_stats and self.training
                  else fused_graph_conv)
            return op(
                x.contiguous(), self.Dense_0.weight, self.Dense_0.bias, a
            )
        return graph_conv_reference(
            x, self.Dense_0.weight, self.Dense_0.bias, a
        )
