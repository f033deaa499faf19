"""Experimental zoo: the debug ST-GCN with per-timestep adjacency and its
layers.

Counterpart of ``skeleton_action_recognition_tpu/models/experimental.py``:

* :class:`GPool`: top-k vertex pooling by a learnable projection vector,
  the adjacency replaced by its second graph power at the kept vertices;
* :class:`SGCN`: a spatial conv with a per-sample ``(N, K, V, V)``
  adjacency;
* :class:`SGTACN`: a spatial conv with a trainable per-timestep ``(K, T,
  V, V)`` adjacency, the parameter ``adjacency_matrix`` (the trainer's
  freeze applies to it);
* :class:`STGCNDebugBlock` and :class:`Model`: the debug ST-GCN of SGTACN
  blocks at fixed temporal sizes 300/150/75, so its input must have
  T=300. With ``stride == 1`` its residual is the identity unless
  ``downsample``; the plan sets ``downsample`` at every change of width;
* :class:`TemporalAttention`: the sigmoid-gated frame attention MLP, which
  no model uses (as in JAX).

None of these take a ``dtype`` or ``remat``: they compute in float32.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
import torch.nn as nn

from skeleton_action_recognition_tpu_torch.graphs.ntu_rgb_d import (
    NUM_JOINTS,
    spatial_adjacency,
)
from skeleton_action_recognition_tpu_torch.models.layers import (
    BatchNorm,
    init_layer,
    lecun_normal_,
)
from skeleton_action_recognition_tpu_torch.models.stgcn import (
    IN_CHANNELS,
    DataBatchNorm,
    TemporalConv,
    reshape_skeleton_input,
    temporal_conv,
)

# (filters, temporal size, stride, residual, downsample) per block
BLOCK_PLAN = (
    (64, 300, 1, False, False),
    (64, 300, 1, True, False),
    (64, 300, 1, True, False),
    (64, 300, 1, True, False),
    (128, 300, 2, True, True),
    (128, 150, 1, True, False),
    (128, 150, 1, True, False),
    (256, 150, 2, True, True),
    (256, 75, 1, True, False),
    (256, 75, 1, True, False),
)


class GPool(nn.Module):
    """Top-k vertex pooling of ``(N, T, V, C)`` with a ``(K, V, V)`` or
    ``(N, K, V, V)`` adjacency; keeps ``int(keeprate * V)`` vertices
    (rounded down, as the JAX code does), ordered by their projection
    score, highest first (a stable sort, as jnp's ``argsort``). The
    projection vector ``projection_vector`` is ``(C * T, 1)``, in flax's
    layout, and drawn as flax's ``lecun_normal``."""

    def __init__(self, channels: int, temporal_dim: int, keeprate: float,
                 generator=None):
        super().__init__()
        self.keeprate = keeprate
        self.projection_vector = nn.Parameter(lecun_normal_(
            torch.empty(channels * temporal_dim, 1),
            channels * temporal_dim, generator))

    def forward(self, x, a):
        n, t, v, c = x.shape
        keep = int(self.keeprate * v)
        p = self.projection_vector
        feats = x.permute(0, 2, 1, 3).reshape(n, v, t * c)
        p_hat = p / torch.clamp(torch.linalg.norm(p), min=1e-12)
        y = (feats @ p_hat)[..., 0]  # (N, V)

        order = torch.argsort(-y, dim=-1, stable=True)[:, :keep]
        y_hat = torch.sigmoid(torch.gather(y, 1, order))
        kept = torch.gather(
            feats, 1, order[:, :, None].expand(n, keep, t * c)
        ) * y_hat[:, :, None]

        if a.ndim == 3:
            a = a[None].expand((n,) + a.shape)
        a2 = torch.einsum("nkuv,nkvw->nkuw", a, a)  # 2nd graph power
        k = a2.shape[1]
        a2 = torch.gather(a2, 2, order[:, None, :, None].expand(n, k, keep, v))
        a2 = torch.gather(a2, 3,
                          order[:, None, None, :].expand(n, k, keep, keep))

        out = kept.reshape(n, keep, t, c).permute(0, 2, 1, 3)
        return out, a2


class SGCN(nn.Module):
    """Spatial conv of ``(N, T, V, C)`` with a per-sample ``(N, K, V, V)``
    adjacency; returns ``(x, a)``."""

    def __init__(self, in_channels: int, filters: int,
                 kernel_size: int = 3, generator=None):
        super().__init__()
        self.filters = filters
        self.kernel_size = kernel_size
        self.Dense_0 = init_layer(
            nn.Linear(in_channels, filters * kernel_size), generator)

    def forward(self, x, a):
        z = self.Dense_0(x)
        z = z.reshape(z.shape[:-1] + (self.kernel_size, self.filters))
        return torch.einsum("ntvko,nkvw->ntwo", z, a), a


class SGTACN(nn.Module):
    """Spatial conv of ``(N, T, V, C)`` with the trainable per-timestep
    adjacency ``adjacency_matrix`` ``(K, T, V, V)``, each timestep starting
    at ``adjacency_init`` ``(K, V, V)``."""

    def __init__(self, in_channels: int, filters: int, adjacency_init,
                 temporal_dim: int, kernel_size: int = 3, generator=None):
        super().__init__()
        self.filters = filters
        self.kernel_size = kernel_size
        a = torch.as_tensor(np.asarray(adjacency_init, np.float32))
        self.adjacency_matrix = nn.Parameter(
            a[:, None].expand((kernel_size, temporal_dim) + a.shape[1:])
            .clone())
        self.Dense_0 = init_layer(
            nn.Linear(in_channels, filters * kernel_size), generator)

    def forward(self, x):
        z = self.Dense_0(x)
        z = z.reshape(z.shape[:-1] + (self.kernel_size, self.filters))
        return torch.einsum("ntvko,ktvw->ntwo", z, self.adjacency_matrix)


class STGCNDebugBlock(nn.Module):
    """SGTACN + temporal conv + residual: absent (``residual=False``), the
    identity at stride 1 without ``downsample``, else a strided 1x1 conv +
    BN."""

    def __init__(self, in_channels: int, filters: int, adjacency_init,
                 temporal_dim: int, stride: int = 1, residual: bool = True,
                 downsample: bool = False, generator=None):
        super().__init__()
        self.residual = residual
        self.project = residual and (stride != 1 or downsample)
        if self.project:
            self.residual_conv = init_layer(nn.Conv2d(
                in_channels, filters, (1, 1), stride=(stride, 1)), generator)
            self.residual_bn = BatchNorm(filters)
        self.sgcn = SGTACN(in_channels, filters, adjacency_init,
                           temporal_dim, generator=generator)
        self.tgcn = TemporalConv(filters, filters, stride=stride,
                                 generator=generator)

    def forward(self, x):
        if not self.residual:
            res = 0.0
        elif self.project:
            res = self.residual_bn(temporal_conv(self.residual_conv, x))
        else:
            res = x
        return torch.relu(self.tgcn(self.sgcn(x)) + res)


class TemporalAttention(nn.Module):
    """Sigmoid-gated per-frame attention MLP over ``(N, T, V, C)``: the
    frames' ``V * C`` features through ``Dense_i`` + ReLU for each of
    ``num_hidden``, then a one-unit gate. Its ``Dense``s are drawn as
    flax's default (``lecun_normal``, zero bias)."""

    def __init__(self, in_features: int, num_hidden: Sequence[int],
                 generator=None):
        super().__init__()
        self.depth = len(num_hidden)
        for i, units in enumerate(tuple(num_hidden) + (1,)):
            layer = nn.Linear(in_features, units)
            lecun_normal_(layer.weight, in_features, generator)
            nn.init.zeros_(layer.bias)
            self.add_module(f"Dense_{i}", layer)
            in_features = units

    def forward(self, x):
        n, t, v, c = x.shape
        h = x.reshape(n, t, v * c)
        for i in range(self.depth):
            h = torch.relu(getattr(self, f"Dense_{i}")(h))
        gate = torch.sigmoid(getattr(self, f"Dense_{self.depth}")(h))
        return x * gate[..., None]


class Model(nn.Module):
    """The debug ST-GCN: ``(N, 3, 300, V, M)`` -> ``(N, num_classes)``
    logits. Each block's per-timestep adjacency starts at the spatial
    stack. Weights are drawn from ``generator`` on the CPU and moved to
    ``device``."""

    def __init__(self, num_classes: int = 60, device=None, generator=None):
        super().__init__()
        a = spatial_adjacency()
        self.data_bn = DataBatchNorm(NUM_JOINTS * IN_CHANNELS)
        c = IN_CHANNELS
        for i, (f, tdim, stride, residual, down) in enumerate(BLOCK_PLAN):
            self.add_module(f"block_{i}", STGCNDebugBlock(
                c, f, a, tdim, stride=stride, residual=residual,
                downsample=down, generator=generator,
            ))
            c = f
        self.logits = init_layer(nn.Linear(c, num_classes), generator)
        self.to(device)

    def forward(self, x):
        x, n, m = reshape_skeleton_input(x)
        x = self.data_bn(x)
        for i in range(len(BLOCK_PLAN)):
            x = getattr(self, f"block_{i}")(x)
        x = x.mean(dim=(1, 2))
        x = x.reshape(n, m, -1).mean(dim=1)
        return self.logits(x)
