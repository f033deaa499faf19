"""Shared building blocks: the conv initializer, Keras-semantics BatchNorm,
the pointwise MLP of the GIN layers, the blocks' rematerialization and the
L2 penalty.

Counterpart of ``skeleton_action_recognition_tpu/models/layers.py``.
Activations are channels-last ``(N, T, V, C)`` throughout the GNN stack.
"""

from __future__ import annotations

import contextlib
import functools
import math
from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import (
    checkpoint,
    create_selective_checkpoint_contexts,
)

from skeleton_action_recognition_tpu_torch.parallel.distributed import (
    active,
    global_means,
)

EPSILON = 1e-3
MOMENTUM = 0.99
# torch.nn.BatchNorm's defaults, which PyTorch-native models take
TORCH_EPSILON = 1e-5
TORCH_MOMENTUM = 0.9
L2_WEIGHT = 1e-4
# what the remat policies keep of a block's forward for its backward:
# "full" its inputs alone, "dots" also the outputs of the matrix products
# that F.linear and einsum lower to (jax.checkpoint_policies.checkpoint_dots
# keeps dot_general's). Convolutions, BatchNorm, ReLU and the CUDA kernels
# (launched outside the dispatcher) are recomputed under both.
REMAT_POLICIES = ("full", "dots")
SAVED_PRODUCTS = (
    torch.ops.aten.mm.default,
    torch.ops.aten.addmm.default,
    torch.ops.aten.bmm.default,
)
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


def lecun_normal_(weight: torch.Tensor, fan_in: int,
                  generator=None) -> torch.Tensor:
    """flax's ``lecun_normal``: truncated-normal variance scaling, scale 1
    over ``fan_in`` (the default kernel init of ``nn.Dense`` and of an LSTM
    cell's input kernels)."""
    std = math.sqrt(1.0 / fan_in) / _TRUNCATED_STD
    with torch.no_grad():
        return nn.init.trunc_normal_(
            weight, 0.0, std, -2.0 * std, 2.0 * std, generator=generator
        )


def init_layer(layer, generator=None):
    """``CONV_INIT`` weight and zero bias, as the JAX package's layers."""
    conv_init_(layer.weight, generator)
    nn.init.zeros_(layer.bias)
    return layer


def moments(x, axes):
    """The means of ``x`` and of its square over ``axes``."""
    return x.mean(axes), (x * x).mean(axes)


class BatchNorm(nn.Module):
    """BatchNorm over the last axis, as flax's ``nn.BatchNorm``, by default
    with the JAX package's Keras settings (``batch_norm``: ``epsilon``
    1e-3, ``momentum`` 0.99; the ResNet passes torch's 1e-5 and 0.9):

    * eval: ``(x - running_mean) * rsqrt(running_var + epsilon) * weight +
      bias``;
    * train: the same with the batch's statistics, taken in float32 over
      every axis but the last, ``var = max(0, E[x^2] - E[x]^2)`` (biased;
      in a process group ``E`` is over every rank's rows, as XLA takes it
      over a sharded batch: :func:`..parallel.distributed.global_means`),
      and the running statistics updated as ``momentum * running + (1 -
      momentum) * batch``. ``torch.nn.functional.batch_norm`` differs on
      both: its momentum weighs the batch, and its running variance is
      unbiased.

    ``axis=1`` normalizes the channels of a channels-first ``(N, C, ...)``
    input instead (CTR-GCN's ``nn.BatchNorm2d``/``1d`` layout, with
    ``TORCH_EPSILON``); the statistics are then over every other axis.
    Outside a process group it runs ``torch.nn.functional.batch_norm``, one
    fused kernel each way, whose running variance is the batch's unbiased
    one (as the published ``nn.BatchNorm2d``'s); in a process group the
    moments of the global batch as above.

    ``weight``/``bias`` are flax's ``scale``/``bias``, ``running_mean``/
    ``running_var`` its ``batch_stats`` ``mean``/``var``. The normalize runs
    in float32; the output is in ``dtype``, or float32 when ``dtype`` is
    None (flax promotes to its float32 parameters). ``update_stats = False``
    keeps the running statistics as they are in training mode (see
    :func:`frozen_stats`).
    """

    def __init__(self, features: int, dtype=None, epsilon: float = EPSILON,
                 momentum: float = MOMENTUM, axis: int = -1):
        super().__init__()
        if axis not in (-1, 1):
            raise ValueError(f"axis must be -1 or 1, got {axis}")
        self.axis = axis
        self.dtype = dtype
        self.epsilon = epsilon
        self.momentum = momentum
        self.update_stats = True
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x):
        if self.axis == 1 and not active():
            return self._fused(x)
        xf = x.float()
        if self.training:
            axis = self.axis % x.ndim
            axes = tuple(i for i in range(x.ndim) if i != axis)
            mean, var = self.stats_from_moments(
                *moments(xf, axes), xf.numel() // xf.shape[axis])
        else:
            mean, var = self.running_mean, self.running_var
        scale = torch.rsqrt(var + self.epsilon) * self.weight
        shape = (-1,) + (1,) * (x.ndim - 2) if self.axis == 1 else (-1,)
        y = (xf - mean.view(shape)) * scale.view(shape) + self.bias.view(shape)
        return y if self.dtype is None else y.to(self.dtype)

    def _fused(self, x):
        """The channels-first normalize through torch's ``batch_norm``, in
        ``x``'s dtype (float32 for ``dtype`` None), the running statistics
        updated unless ``update_stats`` is off in training (then copies of
        them take the update: a recomputed forward saves what the first
        saved)."""
        mean, var = self.running_mean, self.running_var
        if self.training and not self.update_stats:
            mean, var = mean.clone(), var.clone()
        y = F.batch_norm(
            x if self.dtype is not None else x.float(), mean, var,
            self.weight, self.bias, self.training, 1.0 - self.momentum,
            self.epsilon)
        return y if self.dtype is None else y.to(self.dtype)

    def stats_from_moments(self, mean, sq, count: int, clamp: bool = True):
        """The batch's ``(mean, var)`` from this rank's means of ``x`` and
        ``x**2`` per channel over its ``count`` rows: averaged over every
        rank (:func:`..parallel.distributed.global_means`), ``var = E[x^2]
        - E[x]^2`` clamped at 0 unless ``clamp`` is off (the JAX fused
        chain's), and folded into the running statistics."""
        mean, sq = global_means(mean, sq, count=count)
        var = sq - mean * mean
        if clamp:
            var = torch.clamp(var, min=0.0)
        self.update_running(mean, var)
        return mean, var

    def update_running(self, mean, var):
        """Fold a batch's ``mean`` and ``var`` into the running statistics,
        ``momentum * running + (1 - momentum) * batch``, unless
        ``update_stats`` is off."""
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


class PointwiseMLP(nn.Module):
    """1x1-conv MLP over the last axis: ``[Linear -> BN -> ReLU] x (n-1)
    -> Linear [-> BN -> ReLU]``, the last BN and ReLU skipped with
    ``return_logits``; the JAX package's ``PointwiseMLP``, with its children
    ``Dense_i`` and ``BatchNorm_i``. Its output is float32 (the float32
    parameters promote a bfloat16 input, as flax's ``Dense`` does)."""

    def __init__(self, in_features: int, features: Sequence[int],
                 return_logits: bool = False, generator=None):
        super().__init__()
        self.return_logits = return_logits
        self.depth = len(features)
        norms = len(features) - (1 if return_logits else 0)
        for i, f in enumerate(features):
            self.add_module(f"Dense_{i}", init_layer(
                nn.Linear(in_features, f), generator))
            if i < norms:
                self.add_module(f"BatchNorm_{i}", BatchNorm(f))
            in_features = f

    def forward(self, x):
        x = x.to(torch.promote_types(x.dtype, self.Dense_0.weight.dtype))
        for i in range(self.depth):
            x = getattr(self, f"Dense_{i}")(x)
            if i < self.depth - 1 or not self.return_logits:
                x = torch.relu(getattr(self, f"BatchNorm_{i}")(x))
        return x


@contextlib.contextmanager
def frozen_stats(module: nn.Module, frozen: bool = True):
    """Within the block, the :class:`BatchNorm` layers under ``module`` do
    not update their running statistics (when ``frozen``). Rematerialization
    re-runs a block's forward in the backward pass; flax's ``nn.remat``
    keeps the statistics of the first run, and so does the port by freezing
    them for the second. Modules that take their BatchNorms' batch
    statistics themselves update them through
    :meth:`BatchNorm.stats_from_moments`, so the freeze holds for them
    too."""
    norms = [m for m in module.modules() if isinstance(m, BatchNorm)]
    before = [m.update_stats for m in norms]
    for m in norms:
        m.update_stats = m.update_stats and not frozen
    try:
        yield
    finally:
        for m, flag in zip(norms, before):
            m.update_stats = flag


def check_remat_policy(policy: str) -> str:
    """``policy`` if it is one of ``REMAT_POLICIES``, else ``ValueError``
    (the JAX model takes any other name as "full")."""
    if policy not in REMAT_POLICIES:
        raise ValueError(f"remat_policy must be one of {REMAT_POLICIES}, "
                         f"got {policy!r}")
    return policy


def remat_block(block: nn.Module, x, a=None, policy: str = "full"):
    """``block(x, a)`` (``block(x)`` for ``a`` None: CTR-GCN's blocks, whose
    topology is their own) under ``torch.utils.checkpoint``: its activations are
    dropped after the forward and recomputed in the backward (flax
    ``nn.remat``). ``policy`` "full" keeps the block's inputs alone; "dots"
    (``jax.checkpoint_policies.checkpoint_dots``) also keeps the outputs of
    ``SAVED_PRODUCTS``, through a selective-checkpoint context, so that the
    backward recomputes no matrix product. The recompute leaves the
    BatchNorm running statistics as the first run set them, as flax
    does."""
    first = [True]

    def run(x, a):
        with frozen_stats(block, frozen=not first[0]):
            first[0] = False
            return block(x) if a is None else block(x, a)

    options = {}
    if check_remat_policy(policy) == "dots":
        options["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts, list(SAVED_PRODUCTS))
    return checkpoint(run, x, a, use_reentrant=False, **options)


def l2_regularization(model: nn.Module, weight: float = L2_WEIGHT):
    """Keras-style L2 penalty ``weight * sum(w ** 2)`` (no 1/2) over the
    weights of every ``nn.Linear`` and ``nn.Conv2d`` and the input and
    recurrent weights of every ``nn.LSTM`` under ``model``: the JAX
    package's ``kernel`` leaves. BatchNorm scales (also named ``weight``
    here), biases and the plain parameters (the adjacency, ``epsilon``,
    the projection centers and variances, GPool's projection vector)
    carry no penalty, so the selection is by module type, not by parameter
    name."""
    weights = []
    for module in model.modules():
        if isinstance(module, (nn.Linear, nn.Conv2d)):
            weights.append(module.weight)
        elif isinstance(module, nn.LSTM):
            weights += [p for name, p in module.named_parameters()
                        if name.startswith("weight_")]
    if not weights:
        return 0.0
    # one sum over every weight's squares: a few kernels, not three a leaf
    return weight * torch.cat([w.reshape(-1) for w in weights]).square().sum()
