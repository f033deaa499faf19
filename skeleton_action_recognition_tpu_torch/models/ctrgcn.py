"""CTR-GCN: channel-wise topology refinement graph convolution (Chen et al.,
"Channel-wise Topology Refinement Graph Convolution for Skeleton-Based
Action Recognition", ICCV 2021, arXiv:2107.12213).

The published ``model/ctrgcn.py`` (github.com/Uason-Chen/CTR-GCN), module
by module, on the port's layers; the JAX package has no counterpart. Its
parameters carry the published names (``data_bn``, ``l1`` ... ``l10``,
``fc``; ``gcn1.convs.<k>.conv1`` ... ``conv4``, ``gcn1.PA``,
``gcn1.alpha``, ``tcn1.branches.<i>...``). Activations are channels-first
``(N*M, C, T, V)``, as the published code lays them out:

* a data BatchNorm over the ``M * V * C`` features (150 at NTU's two
  bodies);
* ten :class:`Block`\\ s (64 x4, 128 x3 and 256 x3, stride 2 entering 128
  and 256), each ``relu(tcn1(gcn1(x)) + residual(x))``:
  :class:`UnitGCN` refines, for each of the K = 3 subsets of the spatial
  stack ``[I, norm(In), norm(Out)]`` (``A[dst, src]``), a topology per clip
  and channel, ``S_k = alpha * conv4(tanh(x1[u] - x2[v])) + PA_k`` from
  the frame means of two 1x1 convs of width ``R = C_in // 8`` (8 for the
  3-channel input), aggregates ``z = sum_k sum_v S_k[u, v] conv3_k(x)[v]``
  (:func:`..ops.ctrgc.channel_aggregate`: the CUDA kernels on the card),
  then ``relu(BN(z) + down(x))``; :class:`MultiScaleTemporalConv` runs
  four branches of ``C / 4`` channels (two 5-tap convs of dilation 1 and
  2, a 3-frame max-pool, a strided 1x1), concatenated;
* the mean over frames and joints, then over the bodies, and a dense head.

BatchNorm takes PyTorch's epsilon 1e-5 and momentum 0.1 (the port's
``momentum`` 0.9, Keras's convention) over the channel axis
(:class:`..layers.BatchNorm` with ``axis=1``), its batch statistics over
the global batch in a process group.

This port's departures from the published code, none of which changes
the model's function: the three subsets' ``conv3`` run as one 1x1 conv of
``3 C`` outputs, their ``conv1`` and ``conv2`` as one conv of ``6 R``
outputs and their ``conv4`` as one grouped conv (the weights concatenated
each call); ``conv1`` and ``conv2`` take the frame mean of their input
rather than the mean of their output, which is the same affine map
(computed in float32); the weights are drawn as the port's other models
draw them (fan-out truncated normal convs, zero biases, unit BatchNorm
scales, but ``gcn1.bn``'s scale of 1e-6, ``alpha`` 0 and ``PA`` the stack,
as published). With ``dtype=torch.bfloat16`` the blocks compute in
bfloat16; the parameters, the BatchNorm statistics, the refined topology
``S``, the pooling and the logits stay float32.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from skeleton_action_recognition_tpu_torch.graphs.ntu_rgb_d import (
    NUM_JOINTS,
    spatial_adjacency,
)
from skeleton_action_recognition_tpu_torch.models.layers import (
    TORCH_EPSILON,
    TORCH_MOMENTUM,
    BatchNorm,
    init_layer,
    remat_block,
)
from skeleton_action_recognition_tpu_torch.ops.ctrgc import channel_aggregate

IN_CHANNELS = 3  # x, y, z of each joint
NUM_PERSON = 2  # the bodies of an NTU clip
K_PARTS = 3  # subsets of the spatial stack
TEMPORAL_KERNEL = 5
DILATIONS = (1, 2)
BRANCHES = len(DILATIONS) + 2
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
GCN_BN_SCALE = 1e-6  # the published init of unit_gcn's BatchNorm scale


def relation_channels(in_channels: int) -> int:
    """``R``, the width of the refinement's two 1x1 convs."""
    return 8 if in_channels in (3, 9) else in_channels // 8


class Conv(nn.Conv2d):
    """``nn.Conv2d`` (kernel ``(kt, 1)``) computing in its input's dtype:
    the float32 weight and bias are cast to it."""

    def forward(self, x):
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return self._conv_forward(x, self.weight.to(x.dtype), bias)


def _conv(c_in, c_out, kernel=1, stride=1, dilation=1, generator=None):
    pad = (kernel + (kernel - 1) * (dilation - 1) - 1) // 2
    return init_layer(Conv(c_in, c_out, (kernel, 1), stride=(stride, 1),
                           padding=(pad, 0), dilation=(dilation, 1)),
                      generator)


def _bn(c, dtype, scale=1.0):
    bn = BatchNorm(c, dtype, epsilon=TORCH_EPSILON, momentum=TORCH_MOMENTUM,
                   axis=1)
    nn.init.constant_(bn.weight, scale)
    return bn


class CTRGC(nn.Module):
    """One subset's convs of the published ``CTRGC``: ``conv1`` and
    ``conv2`` (C_in -> R), ``conv3`` (C_in -> C) and ``conv4`` (R -> C).
    :class:`UnitGCN` runs the three subsets' convs merged."""

    def __init__(self, in_channels, out_channels, generator=None):
        super().__init__()
        rel = relation_channels(in_channels)
        self.conv1 = _conv(in_channels, rel, generator=generator)
        self.conv2 = _conv(in_channels, rel, generator=generator)
        self.conv3 = _conv(in_channels, out_channels, generator=generator)
        self.conv4 = _conv(rel, out_channels, generator=generator)


def _merged(convs, name):
    """The weights ``(sum out, in)`` and biases of ``convs``' ``name``
    convs, concatenated in subset order."""
    mods = [getattr(c, name) for c in convs]
    return (torch.cat([m.weight for m in mods]),
            torch.cat([m.bias for m in mods]))


class UnitGCN(nn.Module):
    """The published ``unit_gcn`` (adaptive): the K subsets' refined
    topologies, their aggregation, BatchNorm and the residual ``down``
    (a 1x1 conv and BatchNorm where the width changes, else the identity),
    then ReLU."""

    def __init__(self, in_channels, out_channels, dtype=None,
                 generator=None):
        super().__init__()
        self.dtype = dtype
        self.out_channels = out_channels
        self.convs = nn.ModuleList([
            CTRGC(in_channels, out_channels, generator)
            for _ in range(K_PARTS)])
        if in_channels != out_channels:
            self.down = nn.Sequential(
                _conv(in_channels, out_channels, generator=generator),
                _bn(out_channels, dtype))
        self.PA = nn.Parameter(torch.from_numpy(spatial_adjacency()))
        self.alpha = nn.Parameter(torch.zeros(1))
        self.bn = _bn(out_channels, dtype, GCN_BN_SCALE)

    def topology(self, x):
        """``S (N, K, C, V, V)`` float32: ``alpha * Q_k + PA_k``, ``Q_k =
        conv4_k(tanh(x1_k[u] - x2_k[v]))`` with ``x1_k``, ``x2_k`` the
        frame means of ``conv1_k(x)``, ``conv2_k(x)``."""
        n, _, _, v = x.shape
        w12, b12 = zip(_merged(self.convs, "conv1"),
                       _merged(self.convs, "conv2"))
        w12, b12 = torch.cat(w12), torch.cat(b12)
        means = x.mean(2, dtype=torch.float32)  # (N, C_in, V)
        x12 = F.conv1d(means, w12[..., 0], b12)  # (N, 2 K R, V)
        x1, x2 = x12.chunk(2, dim=1)
        m = torch.tanh(x1[..., :, None] - x2[..., None, :])
        w4, b4 = _merged(self.convs, "conv4")
        q = F.conv2d(m.to(x.dtype), w4.to(x.dtype), b4.to(x.dtype),
                     groups=K_PARTS)
        q = q.view(n, K_PARTS, self.out_channels, v, v)
        return q * self.alpha + self.PA[None, :, None]

    def forward(self, x):
        x = x.to(self.dtype or x.dtype)
        n, _, t, v = x.shape
        s = self.topology(x)
        w3, b3 = _merged(self.convs, "conv3")
        x3 = F.conv2d(x, w3.to(x.dtype), b3.to(x.dtype))
        z = channel_aggregate(
            x3.view(n, K_PARTS, self.out_channels, t, v), s)
        down = self.down(x) if hasattr(self, "down") else x
        return torch.relu(self.bn(z) + down)


class TemporalConv(nn.Module):
    """The published ``TemporalConv`` (and ``unit_tcn``): a ``(kt, 1)``
    conv, dilated, strided and padded to keep ``ceil(T / stride)`` frames,
    then BatchNorm."""

    def __init__(self, in_channels, out_channels, kernel, stride=1,
                 dilation=1, dtype=None, generator=None):
        super().__init__()
        self.conv = _conv(in_channels, out_channels, kernel, stride,
                          dilation, generator)
        self.bn = _bn(out_channels, dtype)

    def forward(self, x):
        return self.bn(self.conv(x))


class MultiScaleTemporalConv(nn.Module):
    """The published ``MultiScale_TemporalConv`` with ``residual=False``:
    four branches of ``C / 4`` channels, concatenated: for each dilation,
    1x1 -> BN -> ReLU -> :class:`TemporalConv`; 1x1 -> BN -> ReLU ->
    max-pool (3, 1) -> BN; and a strided 1x1 -> BN."""

    def __init__(self, channels, stride=1, dtype=None, generator=None):
        super().__init__()
        if channels % BRANCHES:
            raise ValueError(f"{channels} channels do not split over "
                             f"{BRANCHES} branches")
        bc = channels // BRANCHES
        branches = [
            nn.Sequential(
                _conv(channels, bc, generator=generator), _bn(bc, dtype),
                nn.ReLU(),
                TemporalConv(bc, bc, TEMPORAL_KERNEL, stride, dilation,
                             dtype, generator))
            for dilation in DILATIONS]
        branches.append(nn.Sequential(
            _conv(channels, bc, generator=generator), _bn(bc, dtype),
            nn.ReLU(), nn.MaxPool2d((3, 1), (stride, 1), (1, 0)),
            _bn(bc, dtype)))
        branches.append(nn.Sequential(
            _conv(channels, bc, stride=stride, generator=generator),
            _bn(bc, dtype)))
        self.branches = nn.ModuleList(branches)

    def forward(self, x):
        return torch.cat([branch(x) for branch in self.branches], dim=1)


class Block(nn.Module):
    """The published ``TCN_GCN_unit``: ``relu(tcn1(gcn1(x)) + res(x))``,
    ``res`` absent (``residual=False``), the identity where the width and
    stride are kept, else a strided 1x1 conv and BatchNorm
    (``residual``)."""

    def __init__(self, in_channels, out_channels, stride=1, residual=True,
                 dtype=None, generator=None):
        super().__init__()
        self.has_residual = residual
        self.gcn1 = UnitGCN(in_channels, out_channels, dtype, generator)
        self.tcn1 = MultiScaleTemporalConv(out_channels, stride, dtype,
                                           generator)
        if residual and (in_channels != out_channels or stride != 1):
            self.residual = TemporalConv(in_channels, out_channels, 1, stride,
                                         dtype=dtype, generator=generator)

    def forward(self, x):
        y = self.tcn1(self.gcn1(x))
        if not self.has_residual:
            return torch.relu(y)
        res = self.residual(x) if hasattr(self, "residual") else x
        return torch.relu(y + res)


class Model(nn.Module):
    """CTR-GCN: ``(N, 3, T, V, M)`` -> ``(N, num_classes)`` logits, ``M``
    the two bodies of NTU RGB+D.

    ``dtype`` (None or ``torch.bfloat16``) is the compute type of the
    blocks; parameters, BatchNorm statistics, the refined topologies,
    pooling and logits stay float32. ``remat`` (default on, as ST-GCN's)
    recomputes each block in the backward pass from its input.
    ``block_plan`` is the blocks' ``(filters, stride, residual)``, the
    published ten by default. Weights are drawn from ``generator`` on the
    CPU and moved to ``device``."""

    def __init__(self, num_classes: int = 60, dtype=None, remat: bool = True,
                 device=None, generator=None, block_plan=BLOCK_PLAN):
        super().__init__()
        self.dtype = dtype
        self.remat = remat
        self.num_blocks = len(block_plan)
        self.data_bn = BatchNorm(NUM_PERSON * NUM_JOINTS * IN_CHANNELS, dtype,
                                 epsilon=TORCH_EPSILON,
                                 momentum=TORCH_MOMENTUM, axis=1)
        c = IN_CHANNELS
        for i, (filters, stride, residual) in enumerate(block_plan):
            self.add_module(f"l{i + 1}", Block(
                c, filters, stride=stride, residual=residual, dtype=dtype,
                generator=generator))
            c = filters
        self.fc = nn.Linear(c, num_classes)
        with torch.no_grad():
            self.fc.weight.normal_(0.0, math.sqrt(2.0 / num_classes),
                                   generator=generator)
            self.fc.bias.zero_()
        self.to(device)

    def forward(self, x):
        n, c, t, v, m = x.shape
        x = x.permute(0, 4, 3, 1, 2).reshape(n, m * v * c, t)
        x = self.data_bn(x)
        x = x.view(n, m, v, c, t).permute(0, 1, 3, 4, 2).reshape(
            n * m, c, t, v)
        remat = self.remat and torch.is_grad_enabled()
        for i in range(self.num_blocks):
            block = getattr(self, f"l{i + 1}")
            x = remat_block(block, x) if remat else block(x)
        # pool in f32: a bf16 sum over T*V loses mantissa
        x = x.float().reshape(n, m, x.shape[1], -1).mean(3).mean(1)
        return self.fc(x)
