"""Graph-convolution contractions as plain tensor functions.

Counterpart of ``skeleton_action_recognition_tpu/ops/graph.py``: the
channel contraction and the small ``(V, V)`` adjacency contraction of a
spatial graph conv over channels-last activations, and GIN's aggregation
with its learnable self-loop. ``GraphIsoConvTD`` aggregates through
:func:`gin_aggregate`. :func:`spatial_graph_conv` keeps the JAX function's
``(C_in, K, C_out)`` weight layout for callers of that function; the port's
``GraphConvTD`` computes the same contraction from its ``nn.Linear`` weight
in :func:`..ops.sgcn.graph_conv_reference`, the plain version that the
spatial-conv kernels are held against.
"""

from __future__ import annotations

import torch


def spatial_graph_conv(x, w, a, b=None):
    """ST-GCN spatial conv: a 1x1 conv per partition, then the adjacency
    contraction.

    Args:
      x: ``(..., V, C_in)`` activations.
      w: ``(C_in, K, C_out)`` weights, one 1x1 conv per partition.
      a: ``(K, V, V)`` adjacency stack; ``a[k, v, w]`` routes node ``v``
        into node ``w``.
      b: optional ``(K, C_out)`` or ``(C_out,)`` bias, added after the
        channel product and before the adjacency contraction.

    Returns:
      ``(..., V, C_out)``, in the common type of the operands.
    """
    dtype = torch.promote_types(x.dtype, w.dtype)
    z = torch.einsum("...vi,iko->...vko", x.to(dtype), w.to(dtype))
    if b is not None:
        z = z + b
    dtype = torch.promote_types(z.dtype, a.dtype)
    return torch.einsum("...vko,kvw->...wo", z.to(dtype), a.to(dtype))


def gin_aggregate(x, a, epsilon):
    """GIN aggregation: ``(1 + epsilon) I`` appended as the last partition
    of the binary stack ``a`` ``(K-1, V, V)``, then contracted with ``x``
    ``(..., V, C)``. Returns ``(..., K, V, C)``, one slice per partition.

    Types promote as jnp's do: a float ``epsilon`` takes ``x``'s type, a
    tensor one (a float32 parameter) promotes the self-loop, and the
    contraction runs in the common type of ``x`` and the stack."""
    v = a.shape[-1]
    loop_dtype = x.dtype
    if isinstance(epsilon, torch.Tensor):
        loop_dtype = torch.promote_types(loop_dtype, epsilon.dtype)
    self_loop = (1.0 + epsilon) * torch.eye(v, dtype=loop_dtype,
                                            device=x.device)
    dtype = torch.promote_types(x.dtype, torch.promote_types(
        a.dtype, self_loop.dtype))
    a_full = torch.cat([a.to(dtype), self_loop[None].to(dtype)], dim=0)
    return torch.einsum("...vc,kvw->...kwc", x.to(dtype), a_full)
