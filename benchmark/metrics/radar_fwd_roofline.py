"""Kernel #6's share of its roofline (``ops/radar.py``, ``csrc/radar_fwd.cu``):
the spline radar's forward kernel."""

from harness import roofline

KERNELS = (r"radar_spline::fwd_kernel",)


def read(run):
    return roofline.share(run, "radar", "fwd", KERNELS)
