"""ST-PGCN: ST-GCN with a projection graph conv after the first block.

Counterpart of ``skeleton_action_recognition_tpu/models/stpgcn.py``: the
10-block plan of ST-GCN plus ``ProjectionGraphConv(64, vertices=32)``,
named ``projection``, after block 0.

With ``dtype=torch.bfloat16`` the blocks compute in bfloat16, but the
projection's output is float32 (its float32 term promotes the sum, as in
JAX), and so is every later block output that adds an identity residual to
it.
"""

from __future__ import annotations

import torch.nn as nn

from skeleton_action_recognition_tpu_torch.graphs.ntu_rgb_d import (
    spatial_adjacency,
)
from skeleton_action_recognition_tpu_torch.models.projection import (
    ProjectionGraphConv,
)
from skeleton_action_recognition_tpu_torch.models.stgcn import (
    STGCNBackbone,
    adjacency,
    register_adjacency,
)


def _projection(in_channels: int, generator=None):
    return "projection", ProjectionGraphConv(in_channels, 64, 32, generator)


class Model(nn.Module):
    """ST-PGCN: ``(N, 3, T, V, M)`` -> ``(N, num_classes)`` logits. The
    options are :class:`..stgin.Model`'s."""

    def __init__(self, num_classes: int = 60,
                 trainable_adjacency: bool = False, dtype=None,
                 remat: bool = True, device=None, generator=None):
        super().__init__()
        self.backbone = STGCNBackbone(
            num_classes, dtype=dtype, remat=remat, extra_block_index=0,
            extra_block_factory=_projection, generator=generator,
        )
        register_adjacency(self, spatial_adjacency(), trainable_adjacency)
        self.to(device)

    def forward(self, x):
        return self.backbone(x, adjacency(self))
