"""CTR-GCN's channel-wise aggregation forward kernel's share of its
roofline (``ops/ctrgc.py``, ``csrc/ctrgc_fwd.cu``), at the float32 CUDA-core
peak it computes at."""

from harness import roofline

KERNELS = (r"ctrgc::aggregate_fwd",)


def read(run):
    return roofline.share(run, "ctrgc", "fwd", KERNELS)
