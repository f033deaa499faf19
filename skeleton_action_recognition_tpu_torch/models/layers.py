"""Shared building blocks: the conv initializer, Keras-semantics BatchNorm
and the L2 penalty.

Counterpart of ``skeleton_action_recognition_tpu/models/layers.py``.
Activations are channels-last ``(N, T, V, C)`` throughout the GNN stack.
"""

from __future__ import annotations

import contextlib
import math

import torch
import torch.nn as nn

EPSILON = 1e-3
MOMENTUM = 0.99
L2_WEIGHT = 1e-4
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
    """BatchNorm over the last axis, as flax's ``nn.BatchNorm``, by default
    with the JAX package's Keras settings (``batch_norm``: ``epsilon``
    1e-3, ``momentum`` 0.99; the ResNet passes torch's 1e-5 and 0.9):

    * eval: ``(x - running_mean) * rsqrt(running_var + epsilon) * weight +
      bias``;
    * train: the same with the batch's statistics, taken in float32 over
      every axis but the last, ``var = max(0, E[x^2] - E[x]^2)`` (biased),
      and the running statistics updated as ``momentum * running + (1 -
      momentum) * batch``. ``torch.nn.functional.batch_norm`` differs on
      both: its momentum weighs the batch, and its running variance is
      unbiased.

    ``weight``/``bias`` are flax's ``scale``/``bias``, ``running_mean``/
    ``running_var`` its ``batch_stats`` ``mean``/``var``. The normalize runs
    in float32; the output is in ``dtype``, or float32 when ``dtype`` is
    None (flax promotes to its float32 parameters). ``update_stats = False``
    keeps the running statistics as they are in training mode (see
    :func:`frozen_stats`).
    """

    def __init__(self, features: int, dtype=None, epsilon: float = EPSILON,
                 momentum: float = MOMENTUM):
        super().__init__()
        self.dtype = dtype
        self.epsilon = epsilon
        self.momentum = momentum
        self.update_stats = True
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x):
        xf = x.float()
        if self.training:
            axes = tuple(range(x.ndim - 1))
            mean = xf.mean(axes)
            var = torch.clamp((xf * xf).mean(axes) - mean * mean, min=0.0)
            self.update_running(mean, var)
        else:
            mean, var = self.running_mean, self.running_var
        scale = torch.rsqrt(var + self.epsilon) * self.weight
        y = (xf - mean) * scale + self.bias
        return y if self.dtype is None else y.to(self.dtype)

    def update_running(self, mean, var):
        """Fold a batch's ``mean`` and ``var`` into the running statistics,
        ``momentum * running + (1 - momentum) * batch``, unless
        ``update_stats`` is off. Modules that take the batch statistics
        themselves (the fused temporal chains of ``stgcn.py``) update their
        BatchNorms through this, so that :func:`frozen_stats` holds for
        them too."""
        if not self.update_stats:
            return
        with torch.no_grad():
            m = self.momentum
            self.running_mean.copy_(m * self.running_mean + (1 - m) * mean)
            self.running_var.copy_(m * self.running_var + (1 - m) * var)

    def folded_affine(self, mean, var):
        """``(scale, shift)`` with ``x * scale + shift`` the normalize of
        ``x`` by ``mean`` and ``var``, in float32."""
        scale = torch.rsqrt(var + self.epsilon) * self.weight
        return scale, self.bias - mean * scale


@contextlib.contextmanager
def frozen_stats(module: nn.Module, frozen: bool = True):
    """Within the block, the :class:`BatchNorm` layers under ``module`` do
    not update their running statistics (when ``frozen``). Rematerialization
    re-runs a block's forward in the backward pass; flax's ``nn.remat``
    keeps the statistics of the first run, and so does the port by freezing
    them for the second. Modules that take their BatchNorms' batch
    statistics themselves update them through
    :meth:`BatchNorm.update_running`, so the freeze holds for them too."""
    norms = [m for m in module.modules() if isinstance(m, BatchNorm)]
    before = [m.update_stats for m in norms]
    for m in norms:
        m.update_stats = m.update_stats and not frozen
    try:
        yield
    finally:
        for m, flag in zip(norms, before):
            m.update_stats = flag


def l2_regularization(model: nn.Module, weight: float = L2_WEIGHT):
    """Keras-style L2 penalty ``weight * sum(w ** 2)`` (no 1/2) over the
    weights of every ``nn.Linear`` and ``nn.Conv2d`` under ``model``: the
    JAX package's ``kernel`` leaves. BatchNorm scales (also named
    ``weight`` here), biases and the adjacency carry no penalty, so the
    selection is by module type, not by parameter name."""
    total = 0.0
    for module in model.modules():
        if isinstance(module, (nn.Linear, nn.Conv2d)):
            total = total + module.weight.square().sum()
    return weight * total
