"""The card's peaks, the denominators of every roofline and ``mfu``:
NVIDIA H100 SXM5 80GB (HBM3), dense (no sparsity), at its 700 W rating.

Operations a second by the type the operands are computed in: float32 on
the CUDA cores, TF32 and bfloat16 on the tensor cores; bytes a second of
HBM3. A card held below 700 W runs below these, which its share of the
peak then shows.
"""

FLOPS = {"float32": 67e12, "tf32": 494.7e12, "bfloat16": 989.4e12}
HBM_BYTES = 3.35e12


def least_seconds(ops: float, nbytes: float, kind: str) -> float:
    """The least time the card could take for ``ops`` operations of
    ``kind`` moving ``nbytes`` bytes: the larger of the two bounds."""
    return max(ops / FLOPS[kind], nbytes / HBM_BYTES)
