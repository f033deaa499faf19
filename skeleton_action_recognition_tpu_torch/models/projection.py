"""Soft-projection graph layers: the projection graph conv of ST-PGCN and
the projection pools of ST-PGCN-P.

Counterpart of ``skeleton_action_recognition_tpu/models/projection.py``:
points are soft-assigned onto ``J`` learnable Gaussian centers, a projected
adjacency ``z z^T`` is built from the normalized centroids, and (for the
conv) a graph conv runs in projected space before un-projecting
residually. As in JAX, the whitened residual ``(x - mu) / s``, of shape
``(N, P, J, C)``, is never materialized: its squared norm and weighted mean
are expanded into ``(P, C) @ (C, J)`` products.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn

from skeleton_action_recognition_tpu_torch.models.gcn import GraphConv


def _glorot_uniform(c: int, j: int, generator=None) -> nn.Parameter:
    """A ``(C, J)`` parameter drawn as TF's default glorot uniform draws the
    reference's ``[1, C, 1, J]`` weight (fan_in C, fan_out C * J). A plain
    parameter: no L2 penalty, as in JAX, where it is no ``kernel``."""
    limit = math.sqrt(6.0 / (c + c * j))
    w = torch.empty(c, j)
    with torch.no_grad():
        w.uniform_(-limit, limit, generator=generator)
    return nn.Parameter(w)


class SoftProjection(nn.Module):
    """Soft assignment of ``(N, P, C)`` points onto ``vertices`` (``J``)
    Gaussian centers, with parameters ``centers`` and ``variance``
    ``(C, J)`` (the spread is ``sigmoid(variance)``).

    Returns ``(q, z, a_proj)``:

    * ``q``: ``(N, P, J)`` softmax assignment weights;
    * ``z``: ``(N, J, C)`` per-center mean whitened residuals, L2-normalized
      over the centers for each channel;
    * ``a_proj``: ``(N, J, J)``, ``z z^T`` over channels.

    Computes in float32 (a bfloat16 input is squared in bfloat16 and then
    promoted, as jnp does). The ``1e-12`` guards are JAX's: a center that
    receives no mass (``q`` sums to 0 in float32) gives zeros, not NaNs.
    """

    def __init__(self, in_channels: int, vertices: int, generator=None):
        super().__init__()
        self.centers = _glorot_uniform(in_channels, vertices, generator)
        self.variance = _glorot_uniform(in_channels, vertices, generator)

    def forward(self, x):
        centers = self.centers
        dtype = torch.promote_types(x.dtype, centers.dtype)
        xx = (x * x).to(dtype)
        x = x.to(dtype)
        s = torch.sigmoid(self.variance)  # (C, J)
        inv_s2 = 1.0 / (s * s)
        mu_over_s2 = centers * inv_s2

        # ||(x - mu) / s||^2 expanded into three product terms
        d2 = (
            torch.einsum("npc,cj->npj", xx, inv_s2)
            - 2.0 * torch.einsum("npc,cj->npj", x, mu_over_s2)
            + torch.sum(centers * centers * inv_s2, dim=0)
        )
        q = torch.softmax(torch.clamp(d2, min=1e-12) * (-0.5), dim=-1)

        q_sum = torch.sum(q, dim=1)  # (N, J)
        qx = torch.einsum("npj,npc->njc", q, x)  # (N, J, C)
        num = (qx - q_sum[..., None] * centers.T[None]) / s.T[None]
        z = num / (q_sum[..., None] + 1e-12)
        norm = torch.sqrt(
            torch.clamp(torch.sum(z * z, dim=1, keepdim=True), min=1e-12))
        z = z / norm
        a_proj = torch.einsum("nic,njc->nij", z, z)
        return q, z, a_proj


class ProjectionGraphConv(nn.Module):
    """Residual graph conv in soft-projected space over ``(N, T, V, C)``:
    ``x + q @ GraphConv(z, z z^T)``, with ``filters`` equal to ``C``. The
    output is float32 (the projected term is), as in JAX."""

    def __init__(self, in_channels: int, filters: int, vertices: int,
                 generator=None):
        super().__init__()
        self.filters = filters
        self.SoftProjection_0 = SoftProjection(in_channels, vertices,
                                               generator)
        self.graph_conv = GraphConv(in_channels, filters, generator)

    def forward(self, x, a):
        n, t, v, c = x.shape
        q, z, a_proj = self.SoftProjection_0(x.reshape(n, t * v, c))
        z, _ = self.graph_conv(z, a_proj)
        x_proj = torch.einsum("npj,njc->npc", q, z)
        return x + x_proj.reshape(n, t, v, self.filters)


class ProjectionGraphPool(nn.Module):
    """Replace the vertex set by the soft-assignment centroids: ``(N, T, V,
    C)`` or an already pooled ``(N, V, C)`` -> ``((N, J, C), (N, J, J))``,
    the new graph's features and adjacency."""

    def __init__(self, in_channels: int, vertices: int, generator=None):
        super().__init__()
        self.SoftProjection_0 = SoftProjection(in_channels, vertices,
                                               generator)

    def forward(self, x, a):
        if x.ndim == 4:
            n, t, v, c = x.shape
            x = x.reshape(n, t * v, c)
        _, z, a_proj = self.SoftProjection_0(x)
        return z, a_proj
