"""CTR-GCN's channel-wise aggregation backward kernel's share of its
roofline (``ops/ctrgc.py``, ``csrc/ctrgc_bwd.cu``: ``dx3`` and ``ds`` in
one pass), at the float32 CUDA-core peak it computes at."""

from harness import roofline

KERNELS = (r"ctrgc::aggregate_bwd",)


def read(run):
    return roofline.share(run, "ctrgc", "bwd", KERNELS)
