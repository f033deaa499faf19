"""Kernel #4's share of its roofline (``ops/tconv.py``, ``csrc/tconv_fwd.cu``):
the fused temporal chain's forward tile kernel (mode 0) and the channel
sums launched right after it."""

from harness import roofline

KERNELS = (r"mma_tile_kernel<0>", r"tconv::tile_kernel<0>")
FOLLOWERS = (r"channel_sums::",)


def read(run):
    return roofline.share(run, "tconv", "fwd", KERNELS, FOLLOWERS)
