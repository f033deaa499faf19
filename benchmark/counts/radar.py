"""Work of the spline radar kernels (#6 forward, #7 backward) for ``pairs``
(sample, edge-body) pairs, as ``chip_smoke.py`` counts it from
``csrc/radar_math.cuh`` and the spline evaluation (one operation an add,
multiply, division, square root, sine or cosine): the forward's six
endpoint cubics (48) and scatter math and sum (56); the backward recomputes
those and adds the cotangent chain (94) and the contraction with the
tile's monomials (52). #7's loc/lambda instance, the one a model whose
joints are data runs, leaves out the contraction (52) and the chain's
cotangents of the bone, the endpoints and ``c`` (36).

Bytes: the endpoints' spline coefficients (4 a segment, 3 coordinates,
source and destination) in, the complex return out (the backward: its
cotangent in, ``loc`` and ``lambda``'s gradients out), float32."""

FWD_OPS, BWD_OPS = 104, 244
BWD_LOC_LAM_OPS = BWD_OPS - 52 - 36


def coefficient_bytes(n, t_in, pairs_per_sample):
    return 4 * n * (t_in - 1) * 4 * 3 * pairs_per_sample * 2


def fwd(n, t_in, t_out, pairs_per_sample):
    pairs = n * t_out * pairs_per_sample
    return (FWD_OPS * pairs,
            coefficient_bytes(n, t_in, pairs_per_sample) + 8 * n * t_out)


def bwd(n, t_in, t_out, pairs_per_sample, loc_lam_only=True):
    pairs = n * t_out * pairs_per_sample
    ops = BWD_LOC_LAM_OPS if loc_lam_only else BWD_OPS
    return (ops * pairs,
            coefficient_bytes(n, t_in, pairs_per_sample) + 8 * n * t_out)
