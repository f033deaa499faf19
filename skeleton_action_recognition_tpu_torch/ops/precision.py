"""Float32 contractions in full float32, whatever the caller's TF32 switch.

The JAX package pins the radar's and the STFT's contractions at
``Precision.HIGHEST``. PyTorch's switch for TF32 matrix products
(``torch.backends.cuda.matmul.allow_tf32``, or
``torch.set_float32_matmul_precision``) is global, and ``main_gnn``'s
default ``--precision`` turns it on for the whole process. A ``with`` block
that turns it off around a forward does not cover the gradient: autograd
runs the transposed products later, under whatever the switch then says.
:func:`einsum_f32` holds TF32 off in its forward and in its backward and
gives the caller's setting back after each.
"""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def full_f32_matmul():
    """Float32 matrix products in full float32 inside the block; the
    caller's setting is restored on exit, through the API that made it
    (recent torch refuses to read a switch set through a mix of its
    legacy and per-backend APIs)."""
    matmul = torch.backends.cuda.matmul
    try:
        allowed = matmul.allow_tf32
    except RuntimeError:  # set through the per-backend API alone
        before = matmul.fp32_precision
        matmul.fp32_precision = "ieee"
        try:
            yield
        finally:
            matmul.fp32_precision = before
        return
    if not allowed:
        yield
        return
    try:
        precision = torch.get_float32_matmul_precision()
    except RuntimeError:
        precision = None
    matmul.allow_tf32 = False
    try:
        yield
    finally:
        matmul.allow_tf32 = True
        if precision == "medium":  # allow_tf32 = True alone reads "high"
            torch.set_float32_matmul_precision(precision)


def _subscripts(equation: str):
    inputs, out = equation.replace(" ", "").split("->")
    a, b = inputs.split(",")
    for sub in (a, b, out):
        if len(set(sub)) != len(sub) or not sub.isalpha():
            raise ValueError(f"einsum_f32 takes distinct letters: {equation}")
    for sub, other in ((a, b), (b, a)):
        if set(sub) - set(other) - set(out):
            raise ValueError(
                f"einsum_f32: an index of {sub} is summed in that operand "
                f"alone: {equation}"
            )
    return a, b, out


class _Einsum(torch.autograd.Function):
    """``torch.einsum(equation, a, b)`` with both passes in full float32.
    Each operand's gradient is the contraction of the output's cotangent
    with the other operand."""

    @staticmethod
    def forward(ctx, equation, a, b):
        ctx.subscripts = _subscripts(equation)
        ctx.save_for_backward(a, b)
        with full_f32_matmul():
            return torch.einsum(equation, a, b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        sa, sb, out = ctx.subscripts
        da = db = None
        with full_f32_matmul():
            if ctx.needs_input_grad[1]:
                da = torch.einsum(f"{out},{sb}->{sa}", g, b)
            if ctx.needs_input_grad[2]:
                db = torch.einsum(f"{sa},{out}->{sb}", a, g)
        return None, da, db


def einsum_f32(equation: str, a, b):
    """Two-operand ``torch.einsum`` (explicit output, no ellipsis, no index
    summed within one operand) computed in full float32 forward and
    backward, as ``jnp.einsum(..., precision=HIGHEST)`` is."""
    return _Einsum.apply(equation, a, b)
