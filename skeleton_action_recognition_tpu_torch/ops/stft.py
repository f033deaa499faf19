"""Short-time Fourier transform as windowed-basis matmuls, in plain torch.

Counterpart of ``skeleton_action_recognition_tpu/ops/stft.py``: nnAudio's
centered STFT (reflect padding, Hann window) as one framing and one
contraction with the windowed Fourier bases, and the complex STFT of a
signal given as two real channels (:func:`stft_complex`). These are the spectrogram model's route without the fused kernel
(``use_pallas_stft=False``) and the plain version of the kernels in
:mod:`.stft_logmag`. :func:`stft_basis` is a copy of the JAX package's
host builder.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from skeleton_action_recognition_tpu_torch.ops.precision import einsum_f32


@functools.lru_cache(maxsize=16)
def stft_basis(
    n_fft: int,
    freq_bins: int | None = None,
    window: str = "hann",
    dtype=np.float32,
):
    """Windowed Fourier bases ``(cos, sin)``, each ``(freq_bins, n_fft)``
    numpy arrays: bin ``k`` is ``k / n_fft`` cycles a sample, the window
    ``scipy.signal.get_window(window, n_fft, fftbins=True)`` (periodic
    Hann by default). Returned cached: do not write to them."""
    from scipy.signal import get_window

    if freq_bins is None:
        freq_bins = n_fft
    win = get_window(window, n_fft, fftbins=True)
    k = np.arange(freq_bins)[:, None]
    n = np.arange(n_fft)[None, :]
    arg = 2.0 * np.pi * k * n / n_fft
    cos = (np.cos(arg) * win).astype(dtype)
    sin = (np.sin(arg) * win).astype(dtype)
    return cos, sin


@functools.lru_cache(maxsize=16)
def reflect_index(t: int, pad: int, device=None) -> torch.Tensor:
    """``numpy.pad(arange(t), pad, mode="reflect")`` on ``device``, kept
    per shape (a constant: a copy from the host on every call would wait
    for the device; a normal tensor even under ``torch.inference_mode``,
    so that a training step can save it)."""
    with torch.inference_mode(False):
        return torch.from_numpy(
            np.pad(np.arange(t), pad, mode="reflect")).to(device)


def reflect_pad(x: torch.Tensor, pad: int) -> torch.Tensor:
    """Reflect-pad the last axis by ``pad`` on both sides, as
    ``numpy.pad(mode="reflect")`` and ``jnp.pad`` do at any length: where
    ``pad`` reaches the signal's length the reflection repeats
    (``torch.nn.functional.pad`` refuses that case)."""
    return x.index_select(-1, reflect_index(x.shape[-1], pad, x.device))


def _frame_matmul(x, basis, hop: int, center: bool):
    """Contract ``basis (F, n_fft)`` against the frames of ``x (..., T)``
    taken every ``hop`` samples (after reflect-padding ``n_fft // 2`` on
    both sides when ``center``): ``(..., F, frames)``, in full float32 on
    both passes (the JAX package pins it at HIGHEST)."""
    n_fft = basis.shape[-1]
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    if center:
        x2 = reflect_pad(x2, n_fft // 2)
    frames = x2.unfold(-1, n_fft, hop)  # (B, frames, n_fft), a view
    out = einsum_f32("bsn,fn->bfs", frames, basis)  # (B, F, frames)
    return out.reshape(lead + out.shape[1:])


def stft_real(x, hop: int, cos, sin, center: bool = True):
    """STFT of a real signal -> ``(real, imag)``, each ``(..., F, frames)``."""
    return _frame_matmul(x, cos, hop, center), -_frame_matmul(
        x, sin, hop, center
    )


def stft_complex(re, im, hop: int, cos, sin, center: bool = True):
    """STFT of a complex signal given as two real channels:
    ``Re_out = re*cos + im*sin``, ``Im_out = -re*sin + im*cos`` (each term
    a basis contraction over the frames). ``re``/``im`` stack on the batch
    axis and ``cos``/``sin`` on the basis axis, so that one framing and one
    matmul compute all four, as in the JAX package."""
    f = cos.shape[0]
    lead = re.shape[:-1]
    r2 = re.reshape(-1, re.shape[-1])
    i2 = im.reshape(-1, im.shape[-1])
    b = r2.shape[0]
    out = _frame_matmul(
        torch.cat([r2, i2]), torch.cat([cos, sin]), hop, center
    )  # (2B, 2F, frames)
    rc, rs = out[:b, :f], out[:b, f:]
    ic, is_ = out[b:, :f], out[b:, f:]
    tail = rc.shape[1:]
    return (rc + is_).reshape(lead + tail), (ic - rs).reshape(lead + tail)


def log_magnitude(re, im, eps: float = 1e-6, fftshift: bool = True):
    """``log(|S| + eps)``, rolled by ``F // 2`` along the frequency axis
    (``-2``) when ``fftshift``, so that zero Doppler is centered."""
    out = torch.log(torch.sqrt(re * re + im * im) + eps)
    if fftshift:
        out = torch.roll(out, out.shape[-2] // 2, dims=-2)
    return out
