"""Work of CTR-GCN's channel-wise aggregation kernels (``ctrgc_fwd``
forward, ``ctrgc_bwd`` backward, ``ops/ctrgc.py``) at one launch's shape:
``n`` clips-and-bodies, ``k`` subsets, ``c`` channels, ``t`` frames and
``v`` joints. A multiply-add for each ``(n, k, c, t, u, v)``, twice that
backward (``dx3`` and ``ds``); bytes of the operands read and the results
written once: ``x3``, ``z``, ``dz`` and ``dx3`` in the activations' type
``act``, the topologies ``s`` and their gradient ``ds`` in float32. The
kernels compute in float32 on the CUDA cores whatever ``act``: the
records' ``dtype``, the peak the roofline takes, is float32."""

SIZE = {"float32": 4, "bfloat16": 2}


def operations(n, k, c, t, v, backward=False):
    ops = 2 * k * n * c * t * v * v
    return 2 * ops if backward else ops


def fwd(n, k, c, t, v, act, dtype="float32"):
    s = SIZE[act]
    x3, topo, z = n * k * c * t * v, n * k * c * v * v, n * c * t * v
    return operations(n, k, c, t, v), (x3 + z) * s + topo * 4


def bwd(n, k, c, t, v, act, dtype="float32"):
    s = SIZE[act]
    x3, topo, z = n * k * c * t * v, n * k * c * v * v, n * c * t * v
    # dz, x3 in and dx3 out; s in and ds out
    return (operations(n, k, c, t, v, True),
            (z + 2 * x3) * s + 2 * topo * 4)
