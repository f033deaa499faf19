#!/usr/bin/env python3
"""How far f32 evaluations of the STFT log-magnitude lie from float64 at
the spectrogram trainer's shape: the plain version of kernel #10
(``ops/stft_logmag.py::stft_logmag_reference``) in f32, and an f32 FFT
(``scipy.fft`` on complex64 frames), each against the plain version in
float64, and against each other.

    PYTHONPATH=. python scripts/torch_stft_oracle.py [cpu|cuda] [N] [T]

Seeded normal signals (numpy; N = 16 signals of T = 75,000 samples if not
given), n_fft 256, hop 16, ``stft_basis``'s Hann bases, centered and
fftshifted as the model takes them. Prints one JSON line: the largest
|log|S| difference of each pair, with |S| (float64) at the bin where the
f32 plain version is farthest from float64. The FFT runs on the host.
"""

from __future__ import annotations

import json
import sys

import numpy as np
import scipy.fft
import torch

from skeleton_action_recognition_tpu_torch.ops import stft, stft_logmag

N_FFT, HOP, EPS = 256, 16, 1e-6


def fft_logmag(re, im, window):
    """log(|S| + eps) by an f32 FFT of the reflect-padded, windowed
    frames, fftshifted and in the (N, F, frames) layout."""
    pad = N_FFT // 2
    z = np.pad(re + 1j * im, ((0, 0), (pad, pad)), mode="reflect")
    frames = np.lib.stride_tricks.sliding_window_view(z, N_FFT, -1)[:, ::HOP]
    spec = scipy.fft.fft((frames * window).astype(np.complex64), axis=-1)
    out = np.log(np.abs(spec) + np.float32(EPS)).astype(np.float32)
    return np.roll(out, N_FFT // 2, -1).transpose(0, 2, 1)


def main(args):
    device = torch.device(args[0] if args else "cpu")
    n = int(args[1]) if len(args) > 1 else 16
    t = int(args[2]) if len(args) > 2 else 75000
    rng = np.random.default_rng(0)
    re, im = (rng.normal(size=(n, t)).astype(np.float32) for _ in range(2))
    cos, sin = (torch.from_numpy(b).to(device) for b in stft.stft_basis(N_FFT))
    cos64, sin64 = (torch.from_numpy(b).to(device)
                    for b in stft.stft_basis(N_FFT, dtype=np.float64))
    tre, tim = torch.from_numpy(re).to(device), torch.from_numpy(im).to(device)
    f64 = stft_logmag.stft_logmag_reference(
        tre.double(), tim.double(), HOP, cos64, sin64).cpu().numpy()
    plain = stft_logmag.stft_logmag_reference(
        tre, tim, HOP, cos, sin).cpu().numpy()
    fft = fft_logmag(re, im, cos[0].cpu().numpy())
    worst = np.unravel_index(np.argmax(np.abs(plain - f64)), f64.shape)
    print(json.dumps({
        "device": str(device), "n": n, "t": t, "frames": f64.shape[2],
        "f32_plain_vs_f64": float(np.abs(plain - f64).max()),
        "f32_fft_vs_f64": float(np.abs(fft - f64).max()),
        "f32_fft_vs_f32_plain": float(np.abs(fft - plain).max()),
        "magnitude_at_plain_worst": float(np.exp(f64[worst]) - EPS),
        "largest_magnitude": float(np.exp(f64.max()) - EPS),
    }))


if __name__ == "__main__":
    main(sys.argv[1:])
