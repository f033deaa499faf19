"""Kernel #10's share of its roofline (``ops/stft_logmag.py``,
``csrc/stft_fwd.cu``): the in-block FFT log-magnitude kernel."""

from harness import roofline

KERNELS = (r"stft_fft::fwd_kernel",)


def read(run):
    return roofline.share(run, "stft", "fwd", KERNELS)
