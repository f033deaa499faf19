"""Kernel #11's share of its roofline (``ops/stft_logmag.py``,
``csrc/stft_bwd.cu``): the adjoint FFT kernel and the overlap-add fold
launched right after it."""

from harness import roofline

KERNELS = (r"stft_fft::bwd_kernel",)
FOLLOWERS = (r"stft_fft::fold_kernel",)


def read(run):
    return roofline.share(run, "stft", "bwd", KERNELS, FOLLOWERS)
