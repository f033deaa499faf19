"""Kernel #5's share of its roofline (``ops/tconv.py``, ``csrc/tconv_bwd.cu``):
the fused temporal chain's input-gradient tile kernel (mode 1), its
weight-gradient kernel and the channel sums launched right after them."""

from harness import roofline

KERNELS = (r"mma_tile_kernel<1>", r"tconv::tile_kernel<1>",
           r"wgrad_kernel")
FOLLOWERS = (r"channel_sums::",)


def read(run):
    return roofline.share(run, "tconv", "bwd", KERNELS, FOLLOWERS)
