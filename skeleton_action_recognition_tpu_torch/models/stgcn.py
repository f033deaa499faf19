"""ST-GCN: spatio-temporal graph convolutional network.

Counterpart of ``skeleton_action_recognition_tpu/models/stgcn.py``: a data
BatchNorm over the flattened ``(V * C)`` features, 10 blocks (64 x4,
128 x3 with stride 2 first, 256 x3 with stride 2 first), each a spatial
graph conv, a BN -> ReLU -> ``[9, 1]`` temporal conv -> BN and a residual,
then pooling, the mean over bodies and a dense logits head. Activations are
channels-last ``(N*M, T, V, C)``. Module and parameter names follow the flax
tree, so :func:`..interop.flax_to_state_dict` maps a JAX checkpoint's
variables one to one. ``model.train()`` selects the flax ``train=True``
path (batch statistics); ``model.eval()`` the running statistics.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from skeleton_action_recognition_tpu_torch.graphs.ntu_rgb_d import (
    NUM_JOINTS,
    spatial_adjacency,
)
from skeleton_action_recognition_tpu_torch.models.gcn import GraphConvTD
from skeleton_action_recognition_tpu_torch.models.layers import (
    BatchNorm,
    frozen_stats,
    init_layer,
)

IN_CHANNELS = 3  # x, y, z of each joint
# (filters, temporal stride, residual) per block
BLOCK_PLAN = (
    (64, 1, False),
    (64, 1, True),
    (64, 1, True),
    (64, 1, True),
    (128, 2, True),
    (128, 1, True),
    (128, 1, True),
    (256, 2, True),
    (256, 1, True),
    (256, 1, True),
)


def _same_padding(size: int, kernel: int, stride: int):
    """flax/XLA ``padding="SAME"``: the smaller half before. For 9 taps at
    stride 2 on even T that is 3 before and 4 after, which no symmetric
    ``nn.Conv2d`` padding gives."""
    total = max((-(-size // stride) - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


def temporal_conv(conv: nn.Conv2d, x, dtype=None):
    """Apply ``conv`` (kernel ``(kt, 1)``, stride ``(s, 1)``, no padding of
    its own) over T of channels-last ``x (N, T, V, C)`` with SAME padding,
    computing in ``dtype`` (None: ``x``'s)."""
    before, after = _same_padding(
        x.shape[1], conv.kernel_size[0], conv.stride[0]
    )
    cd = dtype or x.dtype
    x = F.pad(x.to(cd), (0, 0, 0, 0, before, after))
    y = F.conv2d(
        x.permute(0, 3, 1, 2), conv.weight.to(cd), conv.bias.to(cd),
        stride=conv.stride,
    )
    return y.permute(0, 2, 3, 1)


def _conv(in_channels, filters, kernel_size, stride, generator):
    return init_layer(
        nn.Conv2d(
            in_channels, filters, (kernel_size, 1), stride=(stride, 1)
        ),
        generator,
    )


class TemporalConv(nn.Module):
    """BN -> ReLU -> Conv[kt, 1] (stride t, SAME) -> BN."""

    def __init__(
        self, in_channels: int, filters: int, kernel_size: int = 9,
        stride: int = 1, dtype=None, generator=None,
    ):
        super().__init__()
        self.dtype = dtype
        self.BatchNorm_0 = BatchNorm(in_channels, dtype)
        self.Conv_0 = _conv(
            in_channels, filters, kernel_size, stride, generator
        )
        self.BatchNorm_1 = BatchNorm(filters, dtype)

    def forward(self, x):
        x = torch.relu(self.BatchNorm_0(x))
        x = temporal_conv(self.Conv_0, x, self.dtype)
        return self.BatchNorm_1(x)


class STConvBlock(nn.Module):
    """Spatial conv + temporal conv + residual. The residual is absent
    (``residual=False``), the identity when channels and stride match, and
    otherwise a strided 1x1 conv + BN."""

    def __init__(
        self, in_channels: int, filters: int, stride: int = 1,
        residual: bool = True, dtype=None, fused_sgcn: bool = False,
        generator=None,
    ):
        super().__init__()
        self.dtype = dtype
        self.residual = residual
        self.project = residual and (
            in_channels != filters or stride != 1
        )
        if self.project:
            self.residual_conv = _conv(
                in_channels, filters, 1, stride, generator
            )
            self.residual_bn = BatchNorm(filters, dtype)
        self.sgcn = GraphConvTD(
            in_channels, filters, dtype=dtype, fused=fused_sgcn,
            generator=generator,
        )
        self.tgcn = TemporalConv(
            filters, filters, stride=stride, dtype=dtype,
            generator=generator,
        )

    def forward(self, x, a):
        if not self.residual:
            res = 0.0
        elif self.project:
            res = self.residual_bn(
                temporal_conv(self.residual_conv, x, self.dtype)
            )
        else:
            res = x
        x = self.tgcn(self.sgcn(x, a))
        return torch.relu(x + res)


class DataBatchNorm(nn.Module):
    """BatchNorm over the flattened ``(V * C)`` features, ``(V, C)``
    row-major: stats per (joint, channel)."""

    def __init__(self, features: int, dtype=None):
        super().__init__()
        self.BatchNorm_0 = BatchNorm(features, dtype)

    def forward(self, x):
        nm, t, v, c = x.shape
        return self.BatchNorm_0(x.reshape(nm, t, v * c)).reshape(
            nm, t, v, c
        )


def reshape_skeleton_input(x):
    """``(N, C, T, V, M)`` -> per-body channels-last ``(N*M, T, V, C)``."""
    n, c, t, v, m = x.shape
    x = x.permute(0, 4, 2, 3, 1)  # N, M, T, V, C
    return x.reshape(n * m, t, v, c), n, m


def remat_block(block: nn.Module, x, a):
    """``block(x, a)`` under ``torch.utils.checkpoint``: its activations are
    dropped after the forward and recomputed in the backward (flax
    ``nn.remat``, policy "full"). The recompute leaves the BatchNorm
    running statistics as the first run set them, as flax does."""
    first = [True]

    def run(x, a):
        with frozen_stats(block, frozen=not first[0]):
            first[0] = False
            return block(x, a)

    return checkpoint(run, x, a, use_reentrant=False)


class STGCNBackbone(nn.Module):
    """data-BN + the 10 blocks of ``BLOCK_PLAN`` + pooling/logits head.
    With ``remat``, each block is rematerialized when gradients are
    taken."""

    def __init__(
        self, num_classes: int = 60, dtype=None, fused_sgcn: bool = False,
        fused_sgcn_min_channels: int = 0, remat: bool = True,
        generator=None,
    ):
        super().__init__()
        self.remat = remat
        self.data_bn = DataBatchNorm(NUM_JOINTS * IN_CHANNELS, dtype)
        c = IN_CHANNELS
        for i, (filters, stride, residual) in enumerate(BLOCK_PLAN):
            self.add_module(f"block_{i}", STConvBlock(
                c, filters, stride=stride, residual=residual, dtype=dtype,
                fused_sgcn=fused_sgcn and filters >= fused_sgcn_min_channels,
                generator=generator,
            ))
            c = filters
        self.logits = init_layer(nn.Linear(c, num_classes), generator)

    def forward(self, x, a):
        x, n, m = reshape_skeleton_input(x)
        x = self.data_bn(x)
        remat = self.remat and torch.is_grad_enabled()
        for i in range(len(BLOCK_PLAN)):
            block = getattr(self, f"block_{i}")
            x = remat_block(block, x, a) if remat else block(x, a)
        # pool in f32: a bf16 sum over T*V ~ 7.5k terms loses mantissa
        x = x.float().mean(dim=(1, 2))
        x = x.reshape(n, m, -1).mean(dim=1)  # mean over bodies
        return self.logits(x)


class Model(nn.Module):
    """ST-GCN model: ``(N, 3, T, V, M)`` -> ``(N, num_classes)`` logits.

    ``dtype`` (None or ``torch.bfloat16``) is the compute type of the
    blocks; parameters, pooling and logits stay float32. ``fused_sgcn``
    routes the spatial conv of every block with at least
    ``fused_sgcn_min_channels`` filters through the CUDA kernels.
    ``remat`` (default on, as in the JAX model) recomputes each block in
    the backward pass. ``trainable_adjacency`` makes the spatial-partition
    stack a parameter, ``adjacency_matrix`` (the flax
    ``params['adjacency_matrix']``); the fused kernels take it as a
    constant, so the two exclude each other. Weights are drawn from
    ``generator`` on the CPU and moved to ``device``.
    """

    def __init__(
        self, num_classes: int = 60, dtype=None, fused_sgcn: bool = False,
        fused_sgcn_min_channels: int = 0, remat: bool = True,
        trainable_adjacency: bool = False, device=None, generator=None,
    ):
        super().__init__()
        if fused_sgcn and trainable_adjacency:
            raise ValueError(
                "fused_sgcn takes the adjacency as a constant; it is "
                "incompatible with trainable_adjacency"
            )
        self.backbone = STGCNBackbone(
            num_classes, dtype=dtype, fused_sgcn=fused_sgcn,
            fused_sgcn_min_channels=fused_sgcn_min_channels, remat=remat,
            generator=generator,
        )
        a = torch.from_numpy(spatial_adjacency())
        if trainable_adjacency:
            self.adjacency_matrix = nn.Parameter(a)
        else:
            # a constant: not in the state dict, as it is not among the JAX
            # model's params
            self.register_buffer("adjacency", a, persistent=False)
        self.to(device)

    def forward(self, x):
        a = getattr(self, "adjacency_matrix", None)
        return self.backbone(x, self.adjacency if a is None else a)
