"""Kernel #1's share of its roofline (``ops/sgcn.py``, ``csrc/sgcn_fwd.cu``):
the spatial graph conv's forward kernels, f32 and bf16, and the channel
sums launched right after them."""

from harness import roofline

KERNELS = (r"mma_fwd_kernel", r"sgcn_f32::fwd_kernel")
FOLLOWERS = (r"channel_sums::",)


def read(run):
    return roofline.share(run, "sgcn", "fwd", KERNELS, FOLLOWERS)
