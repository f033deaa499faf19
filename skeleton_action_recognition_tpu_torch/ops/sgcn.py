"""Fused ST-GCN spatial graph conv: the CUDA kernels and their plain versions.

Counterpart of ``skeleton_action_recognition_tpu/ops/pallas/sgcn.py``'s
``make_fused_graph_conv(a, v, with_stats)`` and its VJPs. The kernel in
``csrc/sgcn_fwd.cu`` replaces the TPU kernel ``_fwd_kernel``:

    ``z_k = x @ W_k^T + b_k``          (1x1 conv, one slice per partition)
    ``out[.., w, o] = sum_kv A[k,v,w] z_k[.., v, o]``

its stats entry point replaces ``_fwd_stats_kernel``, which also sums
``out`` and ``out**2`` per channel for the next BatchNorm; and
``csrc/sgcn_bwd.cu`` replaces ``_bwd_kernel``: from the output
cotangent ``g``, ``dz = A g`` per partition, ``dx = sum_k dz_k W_k``,
``dW_k = dz_k^T x`` and ``db_k = sum dz_k`` over all rows.

The unfused versions write ``z`` (forward) and ``dz`` (backward), three
times the output, to device memory and read them back; in bf16 at the
model's widths that traffic bounds them on the H100 (in f32 without TF32
both paths are bound by CUDA-core FLOPs). The kernels keep ``z`` and ``dz``
in shared memory (see the sources' notes).

:class:`FusedGraphConv` ties the two into an autograd Function. Like the
JAX VJP it saves its input ``x`` (not ``z``) and treats the adjacency as a
constant with a zero cotangent. :class:`FusedGraphConvStats` does the same
for the stats variant; its backward folds the sums' cotangents into the
output's and runs the same backward kernel.

The weight is ``nn.Linear``'s ``(K * C_out, C_in)``, partition-major rows,
the transpose of the JAX package's flax ``(C_in, K * C_out)`` kernel.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from skeleton_action_recognition_tpu_torch.ops.build import (
    check_cuda,
    kernel_function,
    launch,
)

K_PARTS = 3
NUM_JOINTS = 25
# csrc/sgcn_fwd.cu's frames per block: the stats workspace holds one
# partial per block
_FWD_FRAMES = 2
# csrc/sgcn_bwd.cu's dW tiling: frames per chunk, output and input channels
# per block. The wrapper sizes the workspace from them.
_DW_FRAMES, _DW_OT, _DW_IT = 2, 32, 64
# dW blocks to aim for: four per SM of the H100's 132, so that every SM has
# work; the split count depends on the shapes alone, which keeps the sums'
# order, and so the result, the same from launch to launch
_DW_TARGET_BLOCKS = 4 * 132


def graph_conv_reference(x, weight, bias, a):
    """Plain PyTorch spatial graph conv, the contraction of the JAX
    package's ``models/gcn.py::GraphConvTD`` stock path.

    ``x (NM, T, V, C_in)``, ``weight (K * C_out, C_in)``, ``bias
    (K * C_out,)``, ``a (K, V, V)`` -> ``(NM, T, V, C_out)`` in ``x.dtype``.
    """
    z = F.linear(x, weight.to(x.dtype), bias.to(x.dtype))
    z = z.reshape(z.shape[:-1] + (a.shape[0], -1))
    return torch.einsum("ntvko,kvw->ntwo", z, a.to(x.dtype))


def graph_conv_stats_reference(x, weight, bias, a):
    """:func:`graph_conv_reference` and the f32 per-channel sums of the
    output and of its square over every ``(NM, T, V)`` row, taken on the
    output rounded to ``x.dtype`` -> ``(out, s, ss)``."""
    out = graph_conv_reference(x, weight, bias, a)
    of = out.float()
    return out, of.sum((0, 1, 2)), (of * of).sum((0, 1, 2))


def graph_conv_backward_reference(x, weight, a, g):
    """Plain PyTorch backward of :func:`graph_conv_reference`, rounding
    where the TPU kernel rounds: ``g``, ``A`` and ``W`` in ``x``'s dtype,
    ``dz`` summed in f32 and rounded to it, ``dx``/``dW``/``db`` summed in
    f32; ``dx`` in ``x.dtype``, ``dW (K * C_out, C_in)`` and ``db`` in f32.
    """
    mm = x.dtype
    g = g.to(mm).float()
    dz = torch.einsum("kvw,ntwo->ntvko", a.to(mm).float(), g).to(mm)
    dz = dz.float().reshape(-1, weight.shape[0])
    x2 = x.float().reshape(-1, x.shape[-1])
    dx = (dz @ weight.to(mm).float()).reshape(x.shape).to(mm)
    return dx, dz.T @ x2, dz.sum(0)


def _check(x, weight, bias, a):
    """Raise on what the kernels do not take (``bias=None``: the
    backward's arguments)."""
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    if x.ndim != 4 or x.shape[2] != NUM_JOINTS:
        raise ValueError(
            f"x must be (NM, T, {NUM_JOINTS}, C_in), got {tuple(x.shape)}"
        )
    c_in = x.shape[3]
    if weight.ndim != 2 or weight.shape[1] != c_in or (
        weight.shape[0] % K_PARTS
    ):
        raise ValueError(
            f"weight must be ({K_PARTS} * C_out, {c_in}), got "
            f"{tuple(weight.shape)}"
        )
    expected = {
        "weight": (weight, tuple(weight.shape)),
        "bias": (bias, (weight.shape[0],)),
        "a": (a, (K_PARTS, NUM_JOINTS, NUM_JOINTS)),
    }
    if bias is None:
        del expected["bias"]
    for name, (t, shape) in expected.items():
        if t.dtype != torch.float32 or tuple(t.shape) != shape:
            raise ValueError(
                f"{name} must be float32 {shape}, got {t.dtype} "
                f"{tuple(t.shape)}"
            )
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")



def _kernels(source: str, n_pointers: int, n_ints: int, stem=None):
    """``{dtype: C function}`` of ``csrc/<source>``'s f32 and bf16 entry
    points (``<stem>_f32``, ``<stem>_bf16``; ``stem`` defaults to the
    source's)."""
    stem = stem or source.removesuffix(".cu")
    return {
        dtype: kernel_function(source, f"{stem}_{suffix}", n_pointers, n_ints)
        for dtype, suffix in ((torch.float32, "f32"),
                              (torch.bfloat16, "bf16"))
    }


def _forward(x, weight, bias, a):
    """``out`` through the kernel on CUDA, the plain version on the CPU."""
    if x.device.type == "cpu":
        return graph_conv_reference(x, weight, bias, a)
    check_cuda("sgcn", x=x, weight=weight, bias=bias, a=a)
    nm, t, v, c_in = x.shape
    c_out = weight.shape[0] // K_PARTS
    out = torch.empty((nm, t, v, c_out), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    launch(
        _kernels("sgcn_fwd.cu", 5, 3)[x.dtype], "sgcn_fwd", x.device,
        x.data_ptr(), weight.data_ptr(), bias.data_ptr(), a.data_ptr(),
        out.data_ptr(), nm * t, c_in, c_out,
    )
    fused_graph_conv.launches += 1
    return out


def _forward_stats(x, weight, bias, a):
    """``(out, s, ss)`` through the kernel's stats entry point on CUDA,
    the plain version on the CPU."""
    if x.device.type == "cpu":
        return graph_conv_stats_reference(x, weight, bias, a)
    check_cuda("sgcn", x=x, weight=weight, bias=bias, a=a)
    nm, t, v, c_in = x.shape
    c_out = weight.shape[0] // K_PARTS
    out = torch.empty((nm, t, v, c_out), dtype=x.dtype, device=x.device)
    sums = torch.zeros(2 * c_out, dtype=torch.float32, device=x.device)
    if out.numel() == 0:
        return out, sums[:c_out], sums[c_out:]
    blocks = -(-(nm * t) // _FWD_FRAMES)
    ws = torch.empty(blocks * 2 * c_out, dtype=torch.float32,
                     device=x.device)
    launch(
        _kernels("sgcn_fwd.cu", 7, 3, "sgcn_fwd_stats")[x.dtype],
        "sgcn_fwd_stats", x.device,
        x.data_ptr(), weight.data_ptr(), bias.data_ptr(), a.data_ptr(),
        out.data_ptr(), ws.data_ptr(), sums.data_ptr(), nm * t, c_in, c_out,
    )
    fused_graph_conv_stats.launches += 1
    return out, sums[:c_out], sums[c_out:]


def backward_splits(frames: int, c_in: int, c_out: int) -> int:
    """How many row splits ``csrc/sgcn_bwd.cu`` sums ``dW``/``db`` over:
    enough blocks to fill the card, at least one chunk of frames each. The
    workspace holds one ``(K * C_out, C_in + 1)`` f32 partial per split,
    at most ~13 MB at the model's shapes."""
    tiles = -(-c_out // _DW_OT) * -(-c_in // _DW_IT)
    return max(1, min(-(-_DW_TARGET_BLOCKS // tiles),
                      -(-frames // _DW_FRAMES)))


def fused_graph_conv_backward(x, weight, a, g):
    """Backward of the spatial graph conv through the CUDA kernel.

    ``x (NM, T, V, C_in)`` and ``weight``, ``a`` as for
    :func:`fused_graph_conv`; ``g (NM, T, V, C_out)``, the output's
    cotangent, is cast to ``x.dtype``. Returns ``(dx, dweight, dbias)`` as
    :func:`graph_conv_backward_reference` does. A CPU tensor goes to that
    plain version; a CUDA tensor launches the kernel (counted in
    ``fused_graph_conv_backward.launches``) or raises.
    """
    _check(x, weight, None, a)
    c_out = weight.shape[0] // K_PARTS
    if tuple(g.shape) != tuple(x.shape[:3]) + (c_out,):
        raise ValueError(
            f"g must be {tuple(x.shape[:3]) + (c_out,)}, got {tuple(g.shape)}"
        )
    if g.device != x.device:
        raise ValueError(f"g is on {g.device}, x on {x.device}")
    if x.device.type == "cpu":
        return graph_conv_backward_reference(x, weight, a, g)
    check_cuda("sgcn", x=x, g=g, weight=weight, a=a)
    g = g.to(x.dtype)
    nm, t, v, c_in = x.shape
    frames = nm * t
    dx = torch.empty_like(x)
    dw = torch.empty(weight.shape, dtype=torch.float32, device=x.device)
    db = torch.empty(weight.shape[0], dtype=torch.float32, device=x.device)
    if frames == 0:
        return dx, dw.zero_(), db.zero_()
    splits = backward_splits(frames, c_in, c_out)
    ws = torch.empty(
        splits * weight.shape[0] * (c_in + 1), dtype=torch.float32,
        device=x.device,
    )
    launch(
        _kernels("sgcn_bwd.cu", 8, 4)[x.dtype], "sgcn_bwd", x.device,
        x.data_ptr(), g.data_ptr(), weight.data_ptr(), a.data_ptr(),
        dx.data_ptr(), dw.data_ptr(), db.data_ptr(), ws.data_ptr(),
        frames, c_in, c_out, splits,
    )
    fused_graph_conv_backward.launches += 1
    return dx, dw, db


class FusedGraphConv(torch.autograd.Function):
    """The spatial graph conv with the kernels on both passes. Saves ``x``
    and ``weight``; the adjacency gets no gradient (it is a constant, as
    in the JAX VJP)."""

    @staticmethod
    def forward(ctx, x, weight, bias, a):
        ctx.save_for_backward(x, weight, a)
        return _forward(x, weight, bias, a)

    @staticmethod
    def backward(ctx, g):
        x, weight, a = ctx.saved_tensors
        dx, dw, db = fused_graph_conv_backward(x, weight, a, g.contiguous())
        return dx, dw, db, None


class FusedGraphConvStats(torch.autograd.Function):
    """The spatial graph conv with the BatchNorm-statistics epilogue:
    ``(out, s, ss)``. Saves ``x``, ``weight`` and ``out``; the backward
    folds the sums' cotangents into the output's, ``g_out + g_s + 2 out
    g_ss`` in f32 (``ops/pallas/sgcn.py:315-323``), and runs the backward
    kernel of :func:`fused_graph_conv_backward`."""

    @staticmethod
    def forward(ctx, x, weight, bias, a):
        out, s, ss = _forward_stats(x, weight, bias, a)
        ctx.save_for_backward(x, weight, a, out)
        return out, s, ss

    @staticmethod
    def backward(ctx, g_out, g_s, g_ss):
        x, weight, a, out = ctx.saved_tensors
        gg = g_out.float() + g_s + 2.0 * out.float() * g_ss
        dx, dw, db = fused_graph_conv_backward(x, weight, a, gg.contiguous())
        return dx, dw, db, None


def fused_graph_conv(x, weight, bias, a):
    """Spatial graph conv through the CUDA kernels, differentiable in
    ``x``, ``weight`` and ``bias``.

    Same arguments and result as :func:`graph_conv_reference`, with
    ``weight``, ``bias`` and ``a`` in float32 on ``x``'s device. CPU tensors
    go to the plain versions; CUDA tensors launch the forward kernel
    (counted in ``fused_graph_conv.launches``) and, in the backward, the
    backward kernel, or raise.
    """
    _check(x, weight, bias, a)
    return FusedGraphConv.apply(x, weight, bias, a)


def fused_graph_conv_stats(x, weight, bias, a):
    """:func:`fused_graph_conv` that also returns the f32 per-channel sums
    of the output and of its square over all ``(NM, T, V)`` rows, taken on
    the output rounded to ``x.dtype``: ``(out, s, ss)``, differentiable in
    ``x``, ``weight`` and ``bias`` through all three. CPU tensors go to the
    plain versions; CUDA tensors launch the stats kernel (counted in
    ``fused_graph_conv_stats.launches``) and, in the backward, the backward
    kernel, or raise."""
    _check(x, weight, bias, a)
    return FusedGraphConvStats.apply(x, weight, bias, a)


fused_graph_conv.launches = 0
fused_graph_conv_stats.launches = 0
fused_graph_conv_backward.launches = 0
