"""CTR-GCN's channel-wise graph aggregation: the CUDA kernels and their
plain version.

For one block of CTR-GCN (Chen et al., ICCV 2021), ``x3 (N, K, C, T, V)``
(the K subsets' 1x1 convs of the block's input, in its compute dtype) and
the refined topologies ``s (N, K, C, V, V)`` (``alpha * Q + PA``, float32),
:func:`channel_aggregate` gives

    ``z[n, c, t, u] = sum_k sum_v s[n, k, c, u, v] * x3[n, k, c, t, v]``

in x3's dtype, every product summed in float32; its backward gives
``dx3 = sum_u s * dz`` (x3's dtype) and ``ds = sum_t dz * x3`` (float32)
in one pass over ``dz``. Unlike ST-GCN's spatial conv (:mod:`.sgcn`),
whose one adjacency stack all clips and channels share, the adjacency here
differs per clip and per channel, and is made afresh every step.

CUDA tensors go through ``csrc/ctrgc_fwd.cu`` and ``csrc/ctrgc_bwd.cu``
(one launch each, counted as ``launch.ctrgc_fwd`` and
``launch.ctrgc_bwd``; ``csrc/ctrgc_tile.cuh`` holds the design). They
replace no TPU kernel: the JAX package has no CTR-GCN. CPU tensors go
through the plain version, the three ``einsum``s of the published model
and their sum (:func:`channel_aggregate_reference`), which is also what
eager PyTorch runs on the card.
"""

from __future__ import annotations

import torch

from skeleton_action_recognition_tpu_torch.ops.build import (
    MAX_SMEM_BYTES,
    check_cuda,
    kernel_function,
    launch,
)

# the largest V the kernels take; a block stages whole (n, c) planes in
# shared memory, frames padded to a multiple of 4 and joints to one of 5
MAX_JOINTS = 32
_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}


def _acc_dtype(dtype):
    return torch.float64 if dtype == torch.float64 else torch.float32


def channel_aggregate_reference(x3, s):
    """Plain PyTorch version of the forward kernel: the published model's
    ``einsum("ncuv,nctv->nctu", ...)`` for each subset, summed, in float32
    (float64 for a float64 ``x3``), and ``z`` cast to ``x3``'s dtype."""
    acc = _acc_dtype(x3.dtype)
    z = None
    for k in range(x3.shape[1]):
        zk = torch.einsum("ncuv,nctv->nctu", s[:, k].to(acc),
                          x3[:, k].to(acc))
        z = zk if z is None else z + zk
    return z.to(x3.dtype)


def channel_aggregate_backward_reference(dz, x3, s):
    """Plain PyTorch version of the backward kernel: ``(dx3, ds)`` from the
    cotangent ``dz`` of :func:`channel_aggregate_reference`, summed in
    float32 (float64), ``dx3`` in ``x3``'s dtype and ``ds`` in ``s``'s."""
    acc = _acc_dtype(x3.dtype)
    dzf, sf, xf = dz.to(acc), s.to(acc), x3.to(acc)
    dx3 = torch.einsum("nkcuv,nctu->nkctv", sf, dzf)
    ds = torch.einsum("nctu,nkctv->nkcuv", dzf, xf)
    return dx3.to(x3.dtype), ds.to(s.dtype)


def plane_bytes(k, t, v, dtype) -> int:
    """Shared memory of one (n, c) plane in the backward kernel, the larger
    of the two: its K padded topologies in float32, its K padded slices of
    x3 and its padded slice of dz."""
    tp, vp = -(-t // 4) * 4, -(-v // 5) * 5
    return 4 * k * vp * vp + dtype.itemsize * (k + 1) * tp * vp


def _forward(x3, s):
    """``z`` through the kernel on CUDA, the plain version on the CPU."""
    if x3.device.type == "cpu":
        return channel_aggregate_reference(x3, s)
    check_cuda("ctrgc", x3=x3, s=s)
    n, k, c, t, v = x3.shape
    z = torch.empty((n, c, t, v), dtype=x3.dtype, device=x3.device)
    if z.numel():
        launch(kernel_function("ctrgc_fwd.cu",
                               f"ctrgc_fwd_{_SUFFIX[x3.dtype]}", 3, 5),
               "ctrgc_fwd", x3.device, x3.data_ptr(), s.data_ptr(),
               z.data_ptr(), n, k, c, t, v)
    return z


def _backward(dz, x3, s):
    """``(dx3, ds)`` through the kernel on CUDA, the plain version on the
    CPU."""
    if x3.device.type == "cpu":
        return channel_aggregate_backward_reference(dz, x3, s)
    check_cuda("ctrgc", dz=dz, x3=x3, s=s)
    n, k, c, t, v = x3.shape
    dx3 = torch.empty_like(x3)
    ds = torch.empty_like(s)
    if dx3.numel():
        launch(kernel_function("ctrgc_bwd.cu",
                               f"ctrgc_bwd_{_SUFFIX[x3.dtype]}", 5, 5),
               "ctrgc_bwd", x3.device, dz.data_ptr(), x3.data_ptr(),
               s.data_ptr(), dx3.data_ptr(), ds.data_ptr(), n, k, c, t, v)
    return dx3, ds


class ChannelAggregate(torch.autograd.Function):
    """The aggregation with the kernels on both passes. Saves ``x3`` and
    ``s``, which the eager einsums saved too."""

    @staticmethod
    def forward(ctx, x3, s):
        ctx.save_for_backward(x3, s)
        return _forward(x3, s)

    @staticmethod
    def backward(ctx, dz):
        x3, s = ctx.saved_tensors
        return _backward(dz.contiguous(), x3, s)


def channel_aggregate(x3, s):
    """``z (N, C, T, V)``: ``sum_k sum_v s[n, k, c, u, v] x3[n, k, c, t,
    v]``, differentiable in both arguments.

    ``x3 (N, K, C, T, V)`` float32 or bfloat16; ``s (N, K, C, V, V)``
    float32 on the same device; ``V <= 32``. ``z`` is in ``x3``'s dtype.
    CPU tensors go to the plain version; CUDA tensors launch the forward
    kernel (``launch.ctrgc_fwd``) and, in the backward, the backward kernel
    (``launch.ctrgc_bwd``), or raise."""
    if x3.dtype not in _SUFFIX:
        raise TypeError(f"x3 must be float32 or bfloat16, got {x3.dtype}")
    if x3.ndim != 5:
        raise ValueError(f"x3 must be (N, K, C, T, V), got {tuple(x3.shape)}")
    n, k, c, t, v = x3.shape
    if s.dtype != torch.float32 or tuple(s.shape) != (n, k, c, v, v):
        raise ValueError(f"s must be float32 {(n, k, c, v, v)}, got "
                         f"{s.dtype} {tuple(s.shape)}")
    if v > MAX_JOINTS:
        raise ValueError(f"the kernels take V <= {MAX_JOINTS}, got {v}")
    if plane_bytes(k, t, v, x3.dtype) > MAX_SMEM_BYTES:
        raise ValueError(f"a plane of {t} frames does not fit in a block's "
                         "shared memory")
    if s.device != x3.device:
        raise ValueError(f"s is on {s.device}, x3 on {x3.device}")
    return ChannelAggregate.apply(x3.contiguous(), s.contiguous())
