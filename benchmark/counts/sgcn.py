"""Work of the spatial graph conv's kernels (#1 forward, #3 backward) at one
launch's shape, counted as ``chip_smoke.py``'s bounds count it: the 1x1
conv into ``3 C_out`` channels (the backward: its input and weight
gradients) and, for each of the adjacency stack's 73 nonzeros, a
multiply-add a channel; bytes of the operands read and the results written
once (``x``, the output and the cotangents in the compute type; the
weight, bias, adjacency and the weight gradients in float32)."""

K_PARTS, JOINTS = 3, 25
ADJACENCY_NONZEROS = 73  # of the NTU RGB+D (3, 25, 25) spatial stack
SIZE = {"float32": 4, "bfloat16": 2}


def operations(rows, c_in, c_out, backward=False):
    conv = rows * 2 * c_in * K_PARTS * c_out
    adjacency = (rows // JOINTS) * 2 * ADJACENCY_NONZEROS * c_out
    return (2 * conv if backward else conv) + adjacency


def nbytes(rows, c_in, c_out, dtype, backward=False):
    s = SIZE[dtype]
    weights = 4 * (K_PARTS * c_out * c_in + K_PARTS * c_out
                   + K_PARTS * JOINTS * JOINTS)
    if backward:  # x, g in; dx, dW, db out
        return rows * (2 * c_in + c_out) * s + 2 * weights
    return rows * (c_in + c_out) * s + weights


def fwd(rows, c_in, c_out, dtype):
    return operations(rows, c_in, c_out), nbytes(rows, c_in, c_out, dtype)


def bwd(rows, c_in, c_out, dtype):
    return (operations(rows, c_in, c_out, True),
            nbytes(rows, c_in, c_out, dtype, True))
