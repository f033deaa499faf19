"""ST-PGCN-P: an ST-GCN trunk ending in a projection-pooling pyramid.

Counterpart of ``skeleton_action_recognition_tpu/models/stpgcnp.py``: 8
ST-GCN blocks (64 x2, 128 @s2, 128, 256 @s2, 256, 256 @s2, 256), then
``ProjectionGraphPool(512) -> GraphConv(256) -> ProjectionGraphPool(256)
-> GraphConv(512)``, the mean over the projected vertices and then over
bodies, and dense logits. It has no ``dtype`` and no ``remat``, as in JAX.
"""

from __future__ import annotations

import torch.nn as nn

from skeleton_action_recognition_tpu_torch.graphs.ntu_rgb_d import (
    NUM_JOINTS,
    spatial_adjacency,
)
from skeleton_action_recognition_tpu_torch.models.gcn import GraphConv
from skeleton_action_recognition_tpu_torch.models.layers import init_layer
from skeleton_action_recognition_tpu_torch.models.projection import (
    ProjectionGraphPool,
)
from skeleton_action_recognition_tpu_torch.models.stgcn import (
    IN_CHANNELS,
    DataBatchNorm,
    STConvBlock,
    adjacency,
    register_adjacency,
    reshape_skeleton_input,
)

BLOCK_PLAN = (
    (64, 1, False),
    (64, 1, True),
    (128, 2, True),
    (128, 1, True),
    (256, 2, True),
    (256, 1, True),
    (256, 2, True),
    (256, 1, True),
)


class Model(nn.Module):
    """ST-PGCN-P: ``(N, 3, T, V, M)`` -> ``(N, num_classes)`` logits.
    ``trainable_adjacency`` makes the spatial stack the parameter
    ``adjacency_matrix``; the pools replace it after the blocks."""

    def __init__(self, num_classes: int = 60,
                 trainable_adjacency: bool = False, device=None,
                 generator=None):
        super().__init__()
        g = generator
        self.data_bn = DataBatchNorm(NUM_JOINTS * IN_CHANNELS)
        c = IN_CHANNELS
        for i, (filters, stride, residual) in enumerate(BLOCK_PLAN):
            self.add_module(f"block_{i}", STConvBlock(
                c, filters, stride=stride, residual=residual, generator=g))
            c = filters
        self.pool_0 = ProjectionGraphPool(c, 512, g)
        self.gconv_0 = GraphConv(c, 256, g)
        self.pool_1 = ProjectionGraphPool(256, 256, g)
        self.gconv_1 = GraphConv(256, 512, g)
        self.logits = init_layer(nn.Linear(512, num_classes), g)
        register_adjacency(self, spatial_adjacency(), trainable_adjacency)
        self.to(device)

    def forward(self, x):
        a = adjacency(self)
        x, n, m = reshape_skeleton_input(x)
        x = self.data_bn(x)
        for i in range(len(BLOCK_PLAN)):
            x = getattr(self, f"block_{i}")(x, a)
        x, a = self.pool_0(x, a)
        x, a = self.gconv_0(x, a)
        x, a = self.pool_1(x, a)
        x, a = self.gconv_1(x, a)
        x = x.mean(dim=1)  # over the projected vertices
        x = x.reshape(n, m, -1).mean(dim=1)  # over bodies
        return self.logits(x)
