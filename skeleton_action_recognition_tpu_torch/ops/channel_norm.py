"""Channels-first BatchNorm in training: the CUDA kernels and their plain
version.

For ``x (N, C, ...)`` (CTR-GCN's ``(N*M, C, T, V)`` activations and its
data BatchNorm's ``(N, M*V*C, T)``), :func:`channel_norm` normalizes each
channel by its batch statistics over every other axis, ``y = (x - mean) *
rsqrt(var + eps) * weight + bias`` (``var`` biased), and folds the batch's
mean and unbiased variance into the running statistics with torch's
momentum (``momentum`` weighs the batch), as ``F.batch_norm`` does in
training; its backward gives ``dx``, ``grad_weight`` and ``grad_bias``.

CUDA tensors go through ``csrc/channel_norm.cu`` (one launch each way,
counted as ``launch.channel_norm_fwd`` and ``launch.channel_norm_bwd``;
``csrc/channel_norm.cuh`` holds the design): each channel's reductions are
split over many blocks whose partials meet in an order fixed by the shapes.
They replace no TPU kernel: the JAX package has no CTR-GCN, and torch's
native NCHW kernels, one block a channel, ran here before. CPU tensors go
through the plain version (:func:`channel_norm_reference`).
"""

from __future__ import annotations

import functools
import math

import torch
from torch.autograd.function import once_differentiable

from skeleton_action_recognition_tpu_torch.ops.build import (
    check_cuda,
    kernel_function,
    launch,
)

_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}
# blocks a launch aims for: four 256-thread blocks on each of the H100's
# 132 SMs (on an H100 at 700 W the 86 BatchNorms of a CTR-GCN step at
# B = 128 took 6.44 ms at this grid, 7.14 ms at four times as many blocks:
# fewer, larger blocks combine fewer partials)
TARGET_BLOCKS = 4 * 132
# the fewest elements a block takes: two 16-byte bf16 vectors a thread
MIN_BLOCK_ELEMENTS = 2 * 8 * 256
# the grid's second dimension holds the channels
MAX_CHANNELS = 65535
_INT_MAX = 2**31 - 1


def planes_per_block(n: int, c: int, length: int) -> int:
    """The planes of one channel a block takes, from the shapes alone: as
    many blocks as make ``TARGET_BLOCKS`` over the ``c`` channels' ``n``
    planes, but at least ``MIN_BLOCK_ELEMENTS`` elements a block."""
    chunks = min(n, max(1, -(-TARGET_BLOCKS // c)))
    ppc = -(-n // chunks)
    return min(n, max(ppc, -(-MIN_BLOCK_ELEMENTS // max(length, 1))))


def channel_norm_reference(x, weight, bias, running_mean, running_var,
                           momentum: float, eps: float, update: bool = True,
                           out_dtype=torch.float32):
    """Plain PyTorch version of the kernels: the batch's mean and biased
    variance per channel in float32 (float64 for a float64 ``x``), ``y``
    in ``out_dtype``, the running statistics updated in place unless
    ``update`` is off. Differentiable through autograd."""
    acc = torch.float64 if x.dtype == torch.float64 else torch.float32
    xf = x.to(acc)
    axes = (0,) + tuple(range(2, x.ndim))
    var, mean = torch.var_mean(xf, axes, unbiased=False)
    shape = (-1,) + (1,) * (x.ndim - 2)
    scale = torch.rsqrt(var + eps) * weight
    y = (xf - mean.view(shape)) * scale.view(shape) + bias.view(shape)
    if update:
        count = x.numel() // x.shape[1]
        with torch.no_grad():
            running_mean.mul_(1 - momentum).add_(momentum * mean.to(
                running_mean.dtype))
            running_var.mul_(1 - momentum).add_(
                momentum * (var * count / (count - 1)).to(running_var.dtype))
    return y.to(out_dtype)


def _planes(t):
    """``t`` viewed as ``(N, C, L)`` planes, and its samples' stride: ``t``
    itself where each sample's ``(C, ...)`` is contiguous (a slice of a
    concatenation's gradient is), else a contiguous copy (a permuted or an
    expanded tensor, one sample or many)."""
    sample = t.numel() // t.shape[0]
    if t.is_contiguous():
        return t, sample
    if t.stride(0) > _INT_MAX or not t[0].is_contiguous():
        return t.contiguous(), sample
    return t, t.stride(0)


def _vec(length, tensors, strides):
    """The most elements a thread's access takes, 8, 4, 2 or 1: it divides
    the plane length and the strides, and each tensor starts on a boundary
    of ``min(16, vec * its element size)`` bytes."""
    vec = math.gcd(8, length, *strides)
    for t in tensors:
        size, at = t.element_size(), t.data_ptr()
        while at % min(16, vec * size):
            vec //= 2
    return vec


@functools.lru_cache(maxsize=256)
def _plan(shape, x_dtype, y_dtype):
    """What the shapes and types fix for a launch on an ``x`` of ``shape``
    (looked up once: a launch's host time is most of a small BatchNorm's):
    ``n, c, length``, the planes a block takes, the size of the forward's
    ``stats``, and the forward's and the backward's entry points."""
    n, c, length = shape[0], shape[1], math.prod(shape[2:])
    ppc = planes_per_block(n, c, length)
    types = f"{_SUFFIX[x_dtype]}_{_SUFFIX[y_dtype]}"
    return (n, c, length, ppc, 2 * c * (1 + -(-n // ppc)),
            kernel_function("channel_norm.cu", f"channel_norm_fwd_{types}",
                            9, 7, 2),
            kernel_function("channel_norm.cu", f"channel_norm_bwd_{types}",
                            9, 7))


def _forward(x, weight, bias, running_mean, running_var, momentum, eps,
             update, out_dtype):
    """``(y, x as saved, stats)`` through the kernels: ``stats`` float32
    holds the batch's mean and invstd (C each), then the kernels'
    workspace (one allocation)."""
    x, x_stride = _planes(x)
    n, c, length, ppc, size, fwd, _ = _plan(x.shape, x.dtype, out_dtype)
    y = torch.empty_like(x, dtype=out_dtype,
                         memory_format=torch.contiguous_format)
    stats = torch.empty(size, dtype=torch.float32, device=x.device)
    vec = _vec(length, (x, y), (x_stride,))
    at = stats.data_ptr()
    launch(fwd, "channel_norm_fwd", x.device, x.data_ptr(), y.data_ptr(),
           weight.data_ptr(), bias.data_ptr(), running_mean.data_ptr(),
           running_var.data_ptr(), at, at + 4 * c, at + 8 * c, n, c,
           length, x_stride, ppc, vec, int(update), momentum, eps)
    return y, x, stats


def _backward(dy, x, weight, stats, needs_dx):
    """``(dx or None, grad_weight, grad_bias)`` through the kernels, from
    the forward's ``stats``, whose workspace they take over (autograd runs
    a backward on its forward's stream, so after the forward's kernels)."""
    dy, dy_stride = _planes(dy)
    x, x_stride = _planes(x)
    n, c, length, ppc, _, _, bwd = _plan(x.shape, x.dtype, dy.dtype)
    dx = torch.empty_like(x, memory_format=torch.contiguous_format) \
        if needs_dx else None
    grad_weight = torch.empty(c, dtype=torch.float32, device=x.device)
    grad_bias = torch.empty_like(grad_weight)
    tensors = (dy, x) if dx is None else (dy, x, dx)
    vec = _vec(length, tensors, (dy_stride, x_stride))
    at = stats.data_ptr()
    launch(bwd, "channel_norm_bwd", x.device, dy.data_ptr(), x.data_ptr(),
           weight.data_ptr(), at, at + 4 * c,
           0 if dx is None else dx.data_ptr(), grad_weight.data_ptr(),
           grad_bias.data_ptr(), at + 8 * c, n, c, length, dy_stride,
           x_stride, ppc, vec)
    return dx, grad_weight, grad_bias


class ChannelNorm(torch.autograd.Function):
    """The BatchNorm with the kernels on both passes. Saves ``x`` (as the
    kernels read it), the float32 mean and invstd, as ``F.batch_norm``
    does, and the weight. ``rest``: ``(running_mean, running_var,
    momentum, eps, update, out_dtype)``, which no gradient reaches, in one
    argument (``apply`` walks each of its arguments)."""

    @staticmethod
    def forward(ctx, x, weight, bias, rest):
        y, x, stats = _forward(x, weight, bias, *rest)
        ctx.save_for_backward(x, weight, stats)
        return y

    @staticmethod
    @once_differentiable
    def backward(ctx, dy):
        x, weight, stats = ctx.saved_tensors
        dx, grad_weight, grad_bias = _backward(
            dy, x, weight, stats, ctx.needs_input_grad[0])
        return dx, grad_weight, grad_bias, None


def _refuse(x, out_dtype, tensors):
    """Raise for what the kernels do not take, with the reason."""
    if x.dtype not in _SUFFIX or out_dtype not in _SUFFIX:
        raise TypeError("the channel_norm kernels take float32 or bfloat16 "
                        f"x and y, got {x.dtype} and {out_dtype}")
    if x.ndim < 2:
        raise ValueError(f"x must be (N, C, ...), got {tuple(x.shape)}")
    c = x.shape[1]
    for name, t in tensors.items():
        if t.dtype != torch.float32 or tuple(t.shape) != (c,):
            raise ValueError(f"{name} must be float32 ({c},), got "
                             f"{t.dtype} {tuple(t.shape)}")
    check_cuda("channel_norm", **tensors)
    if x.numel() // max(c, 1) <= 1:
        raise ValueError("Expected more than 1 value per channel when "
                         f"training, got input size {tuple(x.shape)}")
    if c > MAX_CHANNELS or x.numel() > _INT_MAX:
        raise ValueError(f"the channel_norm kernels take at most "
                         f"{MAX_CHANNELS} channels and 2**31 - 1 elements, "
                         f"got {tuple(x.shape)}")
    raise ValueError(f"x is on {x.device}, the per-channel tensors on "
                     f"{[str(t.device) for t in tensors.values()]}")


def channel_norm(x, weight, bias, running_mean, running_var, momentum: float,
                 eps: float, update: bool = True, out_dtype=torch.float32):
    """``y``: ``x (N, C, ...)`` normalized per channel by its batch
    statistics and scaled by ``weight``/``bias``, in ``out_dtype``,
    differentiable in ``x``, ``weight`` and ``bias``; the running
    statistics take ``momentum`` of the batch's mean and unbiased variance
    in place unless ``update`` is off.

    ``x`` float32 or bfloat16, the per-channel tensors ``(C,)`` float32 on
    ``x``'s device, ``out_dtype`` float32 or bfloat16. CPU tensors go to
    the plain version; CUDA tensors launch the forward kernels
    (``launch.channel_norm_fwd``) and, in the backward, the backward kernels
    (``launch.channel_norm_bwd``), or raise."""
    device = x.device
    if device.type == "cpu":
        return channel_norm_reference(x, weight, bias, running_mean,
                                      running_var, momentum, eps, update,
                                      out_dtype)
    # one test on the way the layer calls it; the reason only on refusal
    c = x.shape[1] if x.ndim >= 2 else 0
    if not (device.type == "cuda" and x.dtype in _SUFFIX
            and out_dtype in _SUFFIX and 0 < c <= MAX_CHANNELS
            and 1 < x.numel() // c and x.numel() <= _INT_MAX
            and weight.dtype == bias.dtype == running_mean.dtype
            == running_var.dtype == torch.float32
            and weight.shape == bias.shape == running_mean.shape
            == running_var.shape == (c,)
            and weight.device == bias.device == running_mean.device
            == running_var.device == device
            and weight.is_contiguous() and bias.is_contiguous()
            and running_mean.is_contiguous()
            and running_var.is_contiguous()):
        _refuse(x, out_dtype, {"weight": weight, "bias": bias,
                               "running_mean": running_mean,
                               "running_var": running_var})
    return ChannelNorm.apply(x, weight, bias, (
        running_mean, running_var, float(momentum), float(eps), bool(update),
        out_dtype))
