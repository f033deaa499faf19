"""Work of the fused temporal chain's kernels (#4 forward, #5 backward) at
one launch's shape, as ``chip_smoke.py``'s bounds count it: the 9-tap
conv over ``rows`` (clip, frame, joint) rows (the backward: its input and
weight gradients) and 8 operations a row and channel for the affine,
ReLU, bias and statistics; bytes of the activations and cotangents in the
compute type and of the per-channel vectors and the weight in float32,
each read or written once."""

TAPS = 9
SIZE = {"float32": 4, "bfloat16": 2}


def operations(rows, c, backward=False):
    conv = rows * 2 * TAPS * c * c
    return (2 * conv if backward else conv) + rows * c * 8


def fwd(rows, c, dtype):
    s = SIZE[dtype]
    vectors = 4 * (TAPS * c * c + 5 * c)  # weight, scale, shift, bias, sums
    return operations(rows, c), rows * c * 2 * s + vectors


def bwd(rows, c, dtype):
    s = SIZE[dtype]
    vectors = 4 * (2 * TAPS * c * c + 5 * c)  # weight, dW; the vectors
    return operations(rows, c, True), rows * c * 3 * s + vectors
