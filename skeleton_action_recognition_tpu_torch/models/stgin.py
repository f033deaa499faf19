"""ST-GIN: ST-GCN's topology with Graph-Isomorphism spatial convs.

Counterpart of ``skeleton_action_recognition_tpu/models/stgin.py``: the
10-block plan of ST-GCN, with each block's spatial conv a
:class:`..gcn.GraphIsoConvTD` of two-layer ``[f/2, f/2]`` MLPs, so that the
temporal conv takes ``f/2`` channels; the adjacency is the first two
matrices of the spatial stack (identity and normalized inward), to which
the GIN layer appends its ``(1 + epsilon) I``.

With ``dtype=torch.bfloat16`` only the temporal convs, their BatchNorms and
the residual convs compute in bfloat16: the GIN layer takes no ``dtype``
in JAX, and its float32 ``epsilon``, adjacency and ``Dense`` parameters
promote its input to float32. The port keeps that promotion.
"""

from __future__ import annotations

import numpy as np
import torch.nn as nn

from skeleton_action_recognition_tpu_torch.graphs.ntu_rgb_d import Graph
from skeleton_action_recognition_tpu_torch.models.gcn import GraphIsoConvTD
from skeleton_action_recognition_tpu_torch.models.stgcn import (
    STGCNBackbone,
    adjacency,
    register_adjacency,
)


def _gin_factory(in_channels: int, filters: int, generator=None):
    return GraphIsoConvTD(
        in_channels, (filters // 2, filters // 2), generator=generator
    )


class Model(nn.Module):
    """ST-GIN: ``(N, 3, T, V, M)`` -> ``(N, num_classes)`` logits.

    ``trainable_adjacency`` makes the ``(2, V, V)`` stack the parameter
    ``adjacency_matrix``; ``remat`` recomputes each block in the backward
    pass. Weights are drawn from ``generator`` on the CPU and moved to
    ``device``."""

    def __init__(self, num_classes: int = 60,
                 trainable_adjacency: bool = False, dtype=None,
                 remat: bool = True, device=None, generator=None):
        super().__init__()
        self.backbone = STGCNBackbone(
            num_classes, dtype=dtype, remat=remat,
            sgcn_factory=_gin_factory, generator=generator,
        )
        register_adjacency(self, Graph("spatial").A[:2].astype(np.float32),
                           trainable_adjacency)
        self.to(device)

    def forward(self, x):
        return self.backbone(x, adjacency(self))
