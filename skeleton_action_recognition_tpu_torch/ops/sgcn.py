"""Fused ST-GCN spatial graph conv: the CUDA kernel and its plain version.

Counterpart of ``skeleton_action_recognition_tpu/ops/pallas/sgcn.py``'s
``make_fused_graph_conv(a, v)`` (``with_stats=False``, forward only). The
kernel in ``csrc/sgcn_fwd.cu`` replaces the TPU kernel ``_fwd_kernel``:

    ``z_k = x @ W_k^T + b_k``          (1x1 conv, one slice per partition)
    ``out[.., w, o] = sum_kv A[k,v,w] z_k[.., v, o]``

The unfused version writes ``z``, three times the output, to device memory
and reads it back; in bf16 at the model's widths that traffic bounds it on
the H100 (in f32 without TF32 both paths are bound by CUDA-core FLOPs).
The kernel keeps ``z`` in shared memory (see the source's note).

The weight is ``nn.Linear``'s ``(K * C_out, C_in)``, partition-major rows,
the transpose of the JAX package's flax ``(C_in, K * C_out)`` kernel.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from skeleton_action_recognition_tpu_torch.ops.build import load_library

K_PARTS = 3
NUM_JOINTS = 25


def graph_conv_reference(x, weight, bias, a):
    """Plain PyTorch spatial graph conv, the contraction of the JAX
    package's ``models/gcn.py::GraphConvTD`` stock path.

    ``x (NM, T, V, C_in)``, ``weight (K * C_out, C_in)``, ``bias
    (K * C_out,)``, ``a (K, V, V)`` -> ``(NM, T, V, C_out)`` in ``x.dtype``.
    """
    z = F.linear(x, weight.to(x.dtype), bias.to(x.dtype))
    z = z.reshape(z.shape[:-1] + (a.shape[0], -1))
    return torch.einsum("ntvko,kvw->ntwo", z, a.to(x.dtype))


def _check(x, weight, bias, a):
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
    for name, (t, shape) in expected.items():
        if t.dtype != torch.float32 or tuple(t.shape) != shape:
            raise ValueError(
                f"{name} must be float32 {shape}, got {t.dtype} "
                f"{tuple(t.shape)}"
            )
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")


@functools.cache
def _library():
    lib = load_library("sgcn_fwd.cu")
    for fn in (lib.sgcn_fwd_f32, lib.sgcn_fwd_bf16):
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [
            ctypes.c_void_p
        ]
        fn.restype = ctypes.c_int
    return lib


def fused_graph_conv(x, weight, bias, a):
    """Spatial graph conv through the CUDA kernel.

    Same arguments and result as :func:`graph_conv_reference`, with
    ``weight``, ``bias`` and ``a`` in float32 on ``x``'s device. A CPU
    tensor goes to :func:`graph_conv_reference`; a CUDA tensor launches the
    kernel (counted in ``fused_graph_conv.launches``) or raises.
    """
    _check(x, weight, bias, a)
    if x.device.type == "cpu":
        return graph_conv_reference(x, weight, bias, a)
    if x.device.type != "cuda":
        raise ValueError(f"no sgcn kernel for device {x.device}")
    for name, t in (("x", x), ("weight", weight), ("bias", bias), ("a", a)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    nm, t, v, c_in = x.shape
    c_out = weight.shape[0] // K_PARTS
    out = torch.empty((nm, t, v, c_out), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    lib = _library()
    fn = lib.sgcn_fwd_f32 if x.dtype == torch.float32 else lib.sgcn_fwd_bf16
    with torch.cuda.device(x.device):
        err = fn(
            x.data_ptr(), weight.data_ptr(), bias.data_ptr(), a.data_ptr(),
            out.data_ptr(), nm * t, c_in, c_out,
            torch.cuda.current_stream().cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"sgcn_fwd launch failed: cudaError_t {err}")
    fused_graph_conv.launches += 1
    return out


fused_graph_conv.launches = 0
