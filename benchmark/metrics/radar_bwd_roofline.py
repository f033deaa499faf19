"""Kernel #7's share of its roofline (``ops/radar.py``, ``csrc/radar_bwd.cu``):
the spline radar's backward kernel (the loc/lambda instance, which a model
whose joints are data runs) and its reduction, launched right after it."""

from harness import roofline

KERNELS = (r"radar_spline::bwd_kernel",)
FOLLOWERS = (r"radar_spline::reduce_kernel",)


def read(run):
    return roofline.share(run, "radar", "bwd", KERNELS, FOLLOWERS)
