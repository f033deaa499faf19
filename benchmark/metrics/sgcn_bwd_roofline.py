"""Kernel #3's share of its roofline (``ops/sgcn.py``, ``csrc/sgcn_bwd.cu``):
the spatial graph conv's dx and dW kernels and the channel sums launched
right after them."""

from harness import roofline

KERNELS = (r"mma_dx_kernel", r"mma_dw_kernel", r"sgcn_f32::dx_kernel",
           r"sgcn_f32::dw_kernel")
FOLLOWERS = (r"channel_sums::",)


def read(run):
    return roofline.share(run, "sgcn", "bwd", KERNELS, FOLLOWERS)
