"""The comparisons that decide ``correct``, and the lower precisions of
the controls.

Training: the first step's loss, the first gradient's norm and the norm
of the parameters' change after the compared steps, each leaf's norm
against the reference's, over the larger of that leaf's reference norm
and the median leaf's. Beside the gaps of norms, the norm of the first
gradient's difference from the reference's, over the same: a gradient
taken over part of the batch keeps its norm within a few percent and
its direction only as far as the rows agree. Leaves whose reference
gradient is under a thousandth of the median leaf's (a bias under a
BatchNorm) are left out of the gradient and of the change: their
gradient is the rounding of a sum that cancels, and an optimizer moves
them by it alone.
"""

from __future__ import annotations

import contextlib
import math
import statistics

import torch

NEGLIGIBLE_GRADIENT = 1e-3


def leaf_gaps(program: dict, reference: dict, leaves=None) -> dict:
    """Each leaf's ``|program norm - reference norm|`` over the larger of
    its reference norm and the median leaf's (over every leaf of
    ``reference``); a leaf the program did not report reads infinite."""
    leaves = list(reference) if leaves is None else list(leaves)
    median = statistics.median(reference[k] for k in reference)
    return {k: abs(program.get(k, math.inf) - reference[k])
            / max(reference[k], median, 1e-30) for k in leaves}


def leaf_gap(program: dict, reference: dict, leaves=None) -> float:
    """The worst leaf's :func:`leaf_gaps`."""
    worst = max(leaf_gaps(program, reference, leaves).values(), default=0.0)
    return worst if math.isfinite(worst) else math.inf


def leaf_diffs(program: dict, reference: dict, norms: dict,
               leaves) -> dict:
    """Each leaf's ``|program - reference|`` (its gradient tensors) over
    the larger of its reference norm ``norms`` and the median leaf's; a
    leaf the program did not report reads infinite."""
    median = statistics.median(norms.values())
    return {k: (program[k].double() - reference[k].double()).norm().item()
            / max(norms[k], median, 1e-30) if k in program else math.inf
            for k in leaves}


def moved_leaves(reference_grads: dict) -> list:
    """The leaves whose reference gradient norm is at least
    ``NEGLIGIBLE_GRADIENT`` times the median leaf's."""
    median = statistics.median(reference_grads.values())
    return [k for k, v in reference_grads.items()
            if v >= NEGLIGIBLE_GRADIENT * median]


def loss_gap(program, reference) -> float:
    """The worst step's ``|program loss - reference loss| / |reference|``."""
    if len(program) != len(reference):
        return math.inf
    worst = max(abs(p - r) / max(abs(r), 1e-30)
                for p, r in zip(program, reference))
    return worst if math.isfinite(worst) else math.inf


def training_numbers(program: dict, reference: dict) -> dict:
    """The compared numbers of two sets of readings, each ``{"losses":
    [...], "grads": {leaf: norm}, "grad_tensors": {leaf: tensor},
    "deltas": {leaf: norm}}``: the first step's loss gap, and the median
    leaf's gap of the first gradient, of its difference and of the change
    (the worst leaf's and the later steps' losses swing from seed to seed
    with the rounding of a few cancelling sums: ``training_details`` gives
    them)."""
    moved = moved_leaves(reference["grads"])
    changed = [k for k in moved if k in reference["deltas"]]
    return {
        "loss_gap": loss_gap(program["losses"][:1], reference["losses"][:1]),
        "grad_gap": median_gap(program["grads"], reference["grads"], moved),
        "grad_diff": median_of(leaf_diffs(
            program["grad_tensors"], reference["grad_tensors"],
            reference["grads"], moved)),
        "update_gap": median_gap(program["deltas"], reference["deltas"],
                                 changed),
    }


def median_of(gaps: dict) -> float:
    value = statistics.median(gaps.values()) if gaps else 0.0
    return value if math.isfinite(value) else math.inf


def median_gap(program: dict, reference: dict, leaves) -> float:
    """The median over ``leaves`` of :func:`leaf_gaps`."""
    return median_of(leaf_gaps(program, reference, leaves))


def training_details(program: dict, reference: dict, top: int = 3) -> dict:
    """What lies behind :func:`training_numbers`: each step's losses, the
    worst leaf's gaps, the changes of the leaves the reference names
    ``apart`` (the radar's wavelength and location), and the worst leaves
    of the gradient and the change with their norms."""
    moved = moved_leaves(reference["grads"])

    def worst(key, leaves):
        gaps = leaf_gaps(program[key], reference[key], leaves)
        return [[k, gaps[k], program[key].get(k), reference[key][k]]
                for k in sorted(gaps, key=gaps.get, reverse=True)[:top]]

    changed = [k for k in moved if k in reference["deltas"]]
    apart = reference.get("apart", [])
    return {"losses": [program["losses"], reference["losses"]],
            "loss_gap_all_steps": loss_gap(program["losses"],
                                           reference["losses"]),
            "grad_gap_worst_leaf": leaf_gap(program["grads"],
                                            reference["grads"], moved),
            "update_gap_worst_leaf": leaf_gap(program["deltas"],
                                              reference["deltas"], changed),
            "apart": {k: [program["deltas"].get(k), reference["deltas"][k]]
                      for k in apart},
            "left_out": sorted(set(reference["grads"]) - set(moved)),
            "grads": worst("grads", moved),
            "deltas": worst("deltas", changed),
            "grad_gaps": leaf_gaps(program["grads"], reference["grads"],
                                   moved),
            "grad_diffs": leaf_diffs(program["grad_tensors"],
                                     reference["grad_tensors"],
                                     reference["grads"], moved)}


def scaled_round(x, dtype):
    """``x`` rounded to ``dtype`` and back: directly for a 16-bit type,
    through a per-tensor scale (the largest entry to the type's largest
    number) for an 8-bit float, as 8-bit float training scales tensors."""
    if dtype in (torch.bfloat16, torch.float16):
        return x.to(dtype).to(x.dtype)
    scale = torch.finfo(dtype).max / x.detach().abs().amax().clamp_min(1e-30)
    return (x * scale).to(dtype).to(x.dtype) / scale


def tf32_round(x):
    """``x`` float32 rounded to TF32's 10-bit mantissa (to nearest), as a
    TF32 tensor core takes its operands."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


ROUNDINGS = {
    "tf32": (tf32_round, tf32_round),
    "bfloat16": (lambda x: scaled_round(x, torch.bfloat16),) * 2,
    "fp8": (lambda x: scaled_round(x, torch.float8_e4m3fn),
            lambda x: scaled_round(x, torch.float8_e5m2)),
}


class _Rounded(torch.autograd.Function):
    """``forward(x)`` on the way forward, ``backward(g)`` on the way
    back."""

    @staticmethod
    def forward(ctx, x, forward, backward):
        ctx.backward_round = backward
        return forward(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.backward_round(g), None, None


def rounding(name: str | None):
    """A function rounding a float32 tensor, and its gradient, to the named
    lower precision (``ROUNDINGS``: ``tf32``; ``bfloat16``; ``fp8``, e4m3
    forward and e5m2 gradients), or the identity for None."""
    if name is None:
        return lambda x: x
    forward, backward = ROUNDINGS[name]
    return lambda x: _Rounded.apply(x, forward, backward)


@contextlib.contextmanager
def full_f32():
    """TF32 off in cuBLAS and cuDNN inside the block, restored after."""
    matmul = torch.backends.cuda.matmul.allow_tf32
    cudnn = torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = matmul
        torch.backends.cudnn.allow_tf32 = cudnn
