"""ResNet-18 for single-channel spectrograms.

Counterpart of ``skeleton_action_recognition_tpu/models/resnet18.py``: the
torchvision ResNet with a 1-channel 7x7 stem and the width set by
``num_filters``, BasicBlocks with a projection shortcut where the stride or
width changes, the mean pool and the logits in float32. Weights take the
JAX package's initializers: KAIMING (normal, scale 2 over fan-out) for the
convs, ``variance_scaling(1/3, fan_in, uniform)`` for the ``fc`` kernel,
drawn from an explicit ``torch.Generator``. BatchNorm takes torch's
defaults through flax (epsilon 1e-5, flax momentum 0.9) with flax's
running statistics (:class:`..layers.BatchNorm`).

Layout: the input is NHWC with one channel, as in JAX. The stem views it
as NCHW once (with one channel, a reshape), and every activation stays
NCHW-contiguous: each BatchNorm normalizes a channels-last view of its
input and hands back an NCHW one, so no activation is copied for it.
(Channels-last activations also trip torch 2.13's CPU backward of the
strided 1x1 projection conv, which corrupts the heap.)

Module and parameter names follow the flax tree (``conv1``, ``bn1``,
``layer{stage}_{block}.{conv1,bn1,conv2,bn2,downsample_conv,
downsample_bn}``, ``fc``), so :mod:`..interop` maps the variables one to
one.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from skeleton_action_recognition_tpu_torch.models.layers import BatchNorm

BN_EPSILON = 1e-5
BN_MOMENTUM = 0.9


def kaiming_(weight: torch.Tensor, generator=None) -> torch.Tensor:
    """``KAIMING``: flax's ``variance_scaling(2.0, "fan_out", "normal")``
    on a Conv2d ``weight (out, in, kh, kw)``: the fan-out is ``out * kh *
    kw``, as flax counts it on the HWIO kernel."""
    fan_out = weight.shape[0] * math.prod(weight.shape[2:])
    with torch.no_grad():
        return weight.normal_(0.0, math.sqrt(2.0 / fan_out),
                              generator=generator)


def _conv(c_in, c_out, kernel, stride, generator):
    conv = nn.Conv2d(c_in, c_out, kernel, stride=stride,
                     padding=kernel // 2, bias=False)
    kaiming_(conv.weight, generator)
    return conv


def _bn(features, dtype):
    return BatchNorm(features, dtype, epsilon=BN_EPSILON,
                     momentum=BN_MOMENTUM)


def norm(bn: BatchNorm, x):
    """``bn`` over the channels of an NCHW ``x``."""
    return bn(x.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)


def conv(layer: nn.Conv2d, x, dtype=None):
    """``layer`` computing in ``dtype`` (None: ``x``'s)."""
    cd = dtype or x.dtype
    return F.conv2d(x.to(cd), layer.weight.to(cd), None, layer.stride,
                    layer.padding)


class BasicBlock(nn.Module):
    """Two 3x3 convs with the identity or a strided 1x1 projection as the
    shortcut."""

    def __init__(self, c_in: int, filters: int, stride: int = 1,
                 zero_init_residual: bool = False, dtype=None,
                 generator=None):
        super().__init__()
        self.dtype = dtype
        self.conv1 = _conv(c_in, filters, 3, stride, generator)
        self.bn1 = _bn(filters, dtype)
        self.conv2 = _conv(filters, filters, 3, 1, generator)
        self.bn2 = _bn(filters, dtype)
        if zero_init_residual:
            nn.init.zeros_(self.bn2.weight)
        self.project = stride != 1 or c_in != filters
        if self.project:
            self.downsample_conv = _conv(c_in, filters, 1, stride, generator)
            self.downsample_bn = _bn(filters, dtype)

    def forward(self, x):
        out = torch.relu(norm(self.bn1, conv(self.conv1, x, self.dtype)))
        out = norm(self.bn2, conv(self.conv2, out, self.dtype))
        identity = x
        if self.project:
            identity = norm(self.downsample_bn,
                            conv(self.downsample_conv, x, self.dtype))
        return torch.relu(out + identity)


class ResNet(nn.Module):
    """Width-parameterized ResNet of BasicBlocks: ``(N, H, W, 1)`` ->
    float32 logits ``(N, num_classes)``. ``dtype`` (e.g. bfloat16) is the
    compute type of the convs and of the BatchNorm outputs; parameters,
    the normalize, the pool and the logits stay float32.
    ``model.train()`` normalizes with the batch's statistics and updates
    the running ones; ``model.eval()`` uses the running ones."""

    def __init__(self, num_classes: int = 60, num_filters: int = 64,
                 stage_sizes: Sequence[int] = (2, 2, 2, 2),
                 zero_init_residual: bool = False, dtype=None,
                 device=None, generator=None):
        super().__init__()
        self.dtype = dtype
        self.conv1 = _conv(1, num_filters, 7, 2, generator)
        self.bn1 = _bn(num_filters, dtype)
        c_in = num_filters
        self.blocks = []
        for stage, blocks in enumerate(stage_sizes):
            filters = num_filters * 2**stage
            for block in range(blocks):
                name = f"layer{stage + 1}_{block}"
                self.add_module(name, BasicBlock(
                    c_in, filters, 2 if stage > 0 and block == 0 else 1,
                    zero_init_residual, dtype, generator,
                ))
                self.blocks.append(name)
                c_in = filters
        self.fc = nn.Linear(c_in, num_classes)
        limit = math.sqrt(1.0 / c_in)
        with torch.no_grad():
            self.fc.weight.uniform_(-limit, limit, generator=generator)
            self.fc.bias.zero_()
        self.to(device)

    def forward(self, x):
        x = x.reshape(x.shape[0], 1, *x.shape[1:3])  # NHWC -> NCHW, C = 1
        x = torch.relu(norm(self.bn1, conv(self.conv1, x, self.dtype)))
        x = F.max_pool2d(x, 3, 2, 1)
        for name in self.blocks:
            x = getattr(self, name)(x)
        return self.fc(x.float().mean((2, 3)))


Model = ResNet
