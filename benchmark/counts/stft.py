"""Work of the STFT log-magnitude kernels (#10 forward, #11 backward) over
``n`` signals of ``frames`` frames of ``n_fft`` samples, as
``chip_smoke.py`` counts it: 5 N log2 N a complex FFT; the forward's
window, magnitude, square root and log, 8 a bin; the backward's two FFTs,
the recomputed forward's 8 and the cotangent chain, window and
overlap-add's 12 a bin. Bytes: the complex signal in and the
``(n, n_fft, frames)`` float32 spectrogram out once (the backward: the
signal and the spectrogram's cotangent in, the signal's cotangent out),
with the window and the twiddle table."""

import math


def operations(n, frames, n_fft, backward=False):
    fft = 5 * n_fft * int(math.log2(n_fft))
    per_frame = 2 * fft + 20 * n_fft if backward else fft + 8 * n_fft
    return n * frames * per_frame


def fwd(n, t, hop, n_fft):
    frames = t // hop + 1
    table = 3 * 4 * n_fft
    return (operations(n, frames, n_fft),
            8 * n * t + 4 * n * n_fft * frames + table)


def bwd(n, t, hop, n_fft):
    frames = t // hop + 1
    table = 3 * 4 * n_fft
    return (operations(n, frames, n_fft, True),
            16 * n * t + 4 * n * n_fft * frames + table)
