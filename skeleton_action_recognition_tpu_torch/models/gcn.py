"""Graph-convolution layers (channels-last).

Counterpart of ``skeleton_action_recognition_tpu/models/gcn.py``:
``GraphConv``, ``GraphIsoConv``, ``GraphIsoConvTD``, ``GraphConvTD`` and
``AdjGraphConv``. Adjacency ``A[.., v, w]`` routes source joint ``v`` into
destination ``w``; it is ``(V, V)``, a ``(K, V, V)`` partition stack, or
``(N, V, V)`` per sample.

Activations are ``(N, V, C)`` for the static-graph layers (``GraphConv``,
``GraphIsoConv``), which return ``(x, A)`` as in JAX, since the layers
around them may replace the graph (the projection pools of ST-PGCN-P); and
``(N, T, V, C)`` for the temporal (``*TD``) layers, which return ``x``
alone: the graph of an ST-GCN block never changes. A temporal layer's
``out_channels`` is the width of what it returns.

Data types promote as jnp's do: a float32 parameter (``epsilon``, the
adjacency, a ``Dense`` weight) makes a bfloat16 input compute in float32,
as in the JAX layers, which pass no ``dtype`` to their ``Dense``s.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn

from skeleton_action_recognition_tpu_torch.models.layers import (
    PointwiseMLP,
    init_layer,
)
from skeleton_action_recognition_tpu_torch.ops.graph import gin_aggregate
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
    and ``out**2`` from the kernel's epilogue, for the BatchNorm of a
    temporal chain that takes them (``TemporalConv.takes_sums`` in
    ``stgcn.py``, whose block sets the flag from the chain it routes to);
    in eval it returns ``out`` alone, through the plain fused kernel.
    """

    def __init__(
        self, in_channels: int, filters: int, dtype=None,
        fused: bool = False, emit_stats: bool = False, generator=None,
    ):
        super().__init__()
        self.out_channels = filters
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


def _promoted(*tensors):
    dtype = tensors[0].dtype
    for t in tensors[1:]:
        dtype = torch.promote_types(dtype, t.dtype)
    return [t.to(dtype) for t in tensors]


def _adjacency_einsum(x, a):
    """Contract the node axis of ``(..., V, C)`` with ``a``'s trailing
    ``(V, W)``: ``a`` is ``(V, V)``, shared, or ``(N, V, V)``, one per
    sample; any other shape raises."""
    x, a = _promoted(x, a)
    if a.ndim == 2:
        return torch.einsum("...vc,vw->...wc", x, a)
    if a.ndim == 3 and a.shape[0] == x.shape[0]:
        return torch.einsum("n...vc,nvw->n...wc", x, a)
    raise ValueError(f"unsupported adjacency shape {tuple(a.shape)}")


def _epsilon():
    """GIN's learnable self-loop weight, a float32 scalar starting at 0
    (a plain parameter: no L2 penalty, as in JAX, where it is no
    ``kernel``)."""
    return nn.Parameter(torch.zeros(()))


class GraphConv(nn.Module):
    """1x1 conv, then the adjacency contraction, over ``(N, V, C)``."""

    def __init__(self, in_channels: int, filters: int, generator=None):
        super().__init__()
        self.Dense_0 = init_layer(nn.Linear(in_channels, filters), generator)

    def forward(self, x, a):
        x = self.Dense_0(x.to(self.Dense_0.weight.dtype))
        return _adjacency_einsum(x, a), a


class GraphIsoConv(nn.Module):
    """GIN conv over ``(N, V, C)``: aggregation by ``A + (1 + epsilon) I``,
    then a :class:`..layers.PointwiseMLP` of ``features``."""

    def __init__(self, in_channels: int, features: Sequence[int],
                 return_logits: bool = False, generator=None):
        super().__init__()
        self.epsilon = _epsilon()
        self.PointwiseMLP_0 = PointwiseMLP(
            in_channels, features, return_logits=return_logits,
            generator=generator,
        )

    def forward(self, x, a):
        v = a.shape[-1]
        eye = torch.eye(v, device=x.device, dtype=torch.promote_types(
            x.dtype, self.epsilon.dtype))
        a_hat = a + (1.0 + self.epsilon) * eye
        return self.PointwiseMLP_0(_adjacency_einsum(x, a_hat)), a


class GraphIsoConvTD(nn.Module):
    """GIN conv over ``(N, T, V, C)`` (ST-GIN's spatial module): the binary
    stack ``(K-1, V, V)`` gains a ``(1 + epsilon) I`` partition, appended
    last (:func:`..ops.graph.gin_aggregate`); each of the ``K`` partitions
    has its own MLP ``mlp_k``, and their outputs are summed."""

    def __init__(self, in_channels: int, features: Sequence[int],
                 kernel_size: int = 3, return_logits: bool = False,
                 generator=None):
        super().__init__()
        self.out_channels = features[-1]
        self.kernel_size = kernel_size
        self.epsilon = _epsilon()
        for k in range(kernel_size):
            self.add_module(f"mlp_{k}", PointwiseMLP(
                in_channels, features, return_logits=return_logits,
                generator=generator,
            ))

    def forward(self, x, a):
        agg = gin_aggregate(x, a, self.epsilon)  # (N, T, K, V, C)
        out = self.mlp_0(agg[:, :, 0])
        for k in range(1, self.kernel_size):
            out = out + getattr(self, f"mlp_{k}")(agg[:, :, k])
        return out


class AdjGraphConv(nn.Module):
    """:class:`GraphConvTD` with its own trainable ``(K, V, V)`` adjacency,
    ``adjacency_matrix`` (the name the trainer's freeze looks for)."""

    def __init__(self, in_channels: int, filters: int, adjacency_init,
                 generator=None):
        super().__init__()
        self.out_channels = filters
        self.adjacency_matrix = nn.Parameter(
            torch.as_tensor(adjacency_init, dtype=torch.float32).clone())
        k = self.adjacency_matrix.shape[0]
        self.Dense_0 = init_layer(nn.Linear(in_channels, filters * k),
                                  generator)

    def forward(self, x):
        a = self.adjacency_matrix
        z = self.Dense_0(x.to(self.Dense_0.weight.dtype))
        z = z.reshape(z.shape[:-1] + (a.shape[0], self.out_channels))
        return torch.einsum("ntvko,kvw->ntwo", z, a)
