"""Shared building blocks: the conv initializer and Keras-semantics BatchNorm.

Counterpart of ``skeleton_action_recognition_tpu/models/layers.py``.
Activations are channels-last ``(N, T, V, C)`` throughout the GNN stack.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn

EPSILON = 1e-3
# standard deviation of the unit normal truncated to [-2, 2]
_TRUNCATED_STD = 0.87962566103423978


def conv_init_(weight: torch.Tensor, generator=None) -> torch.Tensor:
    """``CONV_INIT``: truncated-normal variance scaling, scale 2 over
    fan_out, as flax's ``variance_scaling(2.0, "fan_out",
    "truncated_normal")``. ``weight`` is in torch's layout, ``(out, in)``
    for a Linear or ``(out, in, kh, kw)`` for a Conv2d."""
    fan_out = weight.shape[0] * math.prod(weight.shape[2:])
    std = math.sqrt(2.0 / fan_out) / _TRUNCATED_STD
    with torch.no_grad():
        return nn.init.trunc_normal_(
            weight, 0.0, std, -2.0 * std, 2.0 * std, generator=generator
        )


def init_layer(layer, generator=None):
    """``CONV_INIT`` weight and zero bias, as the JAX package's layers."""
    conv_init_(layer.weight, generator)
    nn.init.zeros_(layer.bias)
    return layer


class BatchNorm(nn.Module):
    """Eval-mode BatchNorm over the last axis with the JAX package's Keras
    epsilon of 1e-3 (``batch_norm``): ``(x - mean) * rsqrt(var + 1e-3) *
    scale + bias``. Training mode, with batch statistics and Keras
    momentum, is not ported yet, so a module in training mode raises.

    ``weight``/``bias`` are flax's ``scale``/``bias``, ``running_mean``/
    ``running_var`` its ``batch_stats`` ``mean``/``var``. The normalize runs
    in float32; the output is in ``dtype``, or float32 when ``dtype`` is
    None (flax promotes to its float32 parameters).
    """

    def __init__(self, features: int, dtype=None):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x):
        if self.training:
            raise NotImplementedError("BatchNorm runs in eval mode only")
        scale = torch.rsqrt(self.running_var + EPSILON) * self.weight
        y = (x.float() - self.running_mean) * scale + self.bias
        return y if self.dtype is None else y.to(self.dtype)
