"""Fused STFT log-magnitude: the CUDA kernels and their plain versions.

Counterpart of ``skeleton_action_recognition_tpu/ops/pallas/stft.py``
(``stft_logmag``). For a complex signal given as two real channels ``re``,
``im (N, T)`` and windowed Fourier bases ``cos``, ``sin (F, n_fft)``
(:func:`.stft.stft_basis`):

    ``out = log(|STFT(re + i im)| + eps)``,  ``(N, F, frames)``,

centered (reflect padding of ``n_fft // 2``) and rolled by ``F // 2`` along
the bins (fftshift) by default, equal to ``log_magnitude(*stft_complex(...))``
of :mod:`.stft`. ``csrc/stft_fwd.cu`` (kernel #10, replacing
``_fwd_kernel``) computes it as one FFT a frame in the block, without
storing the frames or the complex spectrum; ``csrc/stft_bwd.cu`` (kernel
#11, replacing ``_bwd_kernel`` and ``_overlap_add``) is its VJP with
respect to ``re`` and ``im``, the adjoint FFT and the overlap-add in the
block. :class:`StftLogmag` ties them into an autograd Function which, like
the JAX VJP, gives the bases a zero cotangent (models that train the bases
take the route of :mod:`.stft`).

The kernels take the bases the op's contract names, windowed Fourier
bases, and read only their window: :func:`fourier_window` holds the bases
to that contract and raises on any others. The module is named apart from
:mod:`.stft` as the JAX package's two ``stft`` modules are.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from skeleton_action_recognition_tpu_torch.ops.build import (
    check_cuda,
    kernel_function,
    launch,
)
from skeleton_action_recognition_tpu_torch.ops.stft import (
    reflect_index,
    log_magnitude,
    reflect_pad,
    stft_complex,
)

# the n_fft the kernels take (csrc/stft_fft.cuh: 16 values a thread, a
# block of 256 threads); every hop in [1, n_fft] fits in shared memory
N_FFTS = (64, 128, 256, 512, 1024)
# how far a basis entry may lie from cos / sin(2 pi k m / n_fft) w[m],
# rebuilt in float64 from the window w = cos[0, :]: stft_basis rounds the
# float64 product once (half an f32 ulp) and the window's rounding moves
# it by as much again, so 4 ulps of |w[m]|
BASIS_ULPS = 4

def stft_logmag_reference(re, im, hop: int, cos, sin, eps: float = 1e-6,
                          fftshift: bool = True, center: bool = True):
    """Plain PyTorch kernel #10: ``log_magnitude(*stft_complex(...))``."""
    s_re, s_im = stft_complex(re, im, hop, cos, sin, center=center)
    return log_magnitude(s_re, s_im, eps=eps, fftshift=fftshift)


def _rolled(cos, sin, fftshift):
    if fftshift:
        f = cos.shape[0]
        return torch.roll(cos, f // 2, 0), torch.roll(sin, f // 2, 0)
    return cos, sin


def stft_logmag_backward_reference(re, im, hop: int, cos, sin, g,
                                   eps: float = 1e-6, fftshift: bool = True,
                                   center: bool = True):
    """Plain PyTorch kernel #11: ``(dre, dim)`` from the cotangent ``g
    (N, F, frames)``, a transcription of the JAX kernel's ``_bwd_kernel``:
    the recomputed ``(Re, Im)``, ``g (Re, Im) / (mag (mag + eps))`` (zero
    where the magnitude is), the transposed bases, then the overlap-add of
    the frame cotangents (``fold``) and the reflect padding folded back
    (``index_add_``), both in a fixed order."""
    n, t = re.shape
    n_fft = cos.shape[1]
    c_r, s_r = _rolled(cos, sin, fftshift)
    pad = n_fft // 2 if center else 0
    re_p = reflect_pad(re, pad) if center else re
    im_p = reflect_pad(im, pad) if center else im
    fr_re = re_p.unfold(-1, n_fft, hop)  # (N, frames, n_fft)
    fr_im = im_p.unfold(-1, n_fft, hop)
    s_re = fr_re @ c_r.T + fr_im @ s_r.T  # (N, frames, F)
    s_im = fr_im @ c_r.T - fr_re @ s_r.T
    mag2 = s_re * s_re + s_im * s_im
    mag = torch.sqrt(mag2)
    inv = torch.where(mag2 > 0, 1.0 / (mag * (mag + eps) + 1e-30), 0.0)
    gg = g.transpose(1, 2) * inv
    g_re, g_im = gg * s_re, gg * s_im
    d_fr = (g_re @ c_r - g_im @ s_r, g_re @ s_r + g_im @ c_r)
    tp = re_p.shape[1]
    out = []
    for d in d_fr:
        dp = torch.nn.functional.fold(
            d.transpose(1, 2), (1, tp), (1, n_fft), stride=(1, hop)
        ).reshape(n, tp)
        if center:
            dp = torch.zeros_like(re).index_add_(
                1, reflect_index(t, pad, re.device), dp)
        out.append(dp)
    return tuple(out)


def _check(re, im, cos, sin, hop):
    if re.ndim != 2 or re.shape != im.shape:
        raise ValueError(f"re and im must be (N, T), got {tuple(re.shape)} "
                         f"and {tuple(im.shape)}")
    if cos.ndim != 2 or cos.shape != sin.shape:
        raise ValueError(f"cos and sin must be (F, n_fft), got "
                         f"{tuple(cos.shape)} and {tuple(sin.shape)}")
    for name, t in (("re", re), ("im", im), ("cos", cos), ("sin", sin)):
        if t.dtype != torch.float32:
            raise ValueError(f"{name} must be float32, got {t.dtype}")
        if t.device != re.device:
            raise ValueError(f"{name} is on {t.device}, re on {re.device}")
    if not 0 < hop <= cos.shape[1]:
        raise ValueError(f"hop {hop} must be in [1, n_fft]")


def _check_sizes(f, n_fft):
    if n_fft not in N_FFTS:
        raise ValueError(f"the STFT kernels take a power-of-two n_fft from "
                         f"64 to 1024, got n_fft={n_fft}")
    if not 1 <= f <= n_fft:
        raise ValueError(f"the STFT kernels take 1 <= F <= n_fft bins, got "
                         f"F={f}, n_fft={n_fft}")


# fourier_window's bases, each with its window: (device, data pointers,
# versions, shape) -> (cos, sin, window). Holding the tensors keeps their
# memory from being handed to other tensors while they are keys.
_WINDOWS: dict = {}


def fourier_window(cos, sin):
    """The window ``w = cos[0, :]`` (``cos(0) = 1``) of windowed Fourier
    bases ``cos``, ``sin (F, n_fft)``, the contract of the kernels (the JAX
    op's: :func:`.stft.stft_basis`), after holding every entry to
    ``cos(2 pi k m / n_fft) w[m]`` and ``sin(2 pi k m / n_fft) w[m]``
    rebuilt in float64, within ``BASIS_ULPS * 2^-24 |w[m]|``. Raises
    ``ValueError`` on other bases, or on sizes the kernels do not take.

    The check runs once for each bases tensor (a comparison on its device
    and one sync), and is kept by device, data pointer, version and shape,
    so that a train step repeats none of it."""
    f, n_fft = cos.shape
    _check_sizes(f, n_fft)
    key = (cos.device, cos.data_ptr(), cos._version, sin.data_ptr(),
           sin._version, tuple(cos.shape), tuple(sin.shape))
    if key in _WINDOWS:
        return _WINDOWS[key][2]
    cos, sin = cos.detach(), sin.detach()
    w = cos[0].double()
    k = torch.arange(f, device=cos.device)[:, None]
    m = torch.arange(n_fft, device=cos.device)[None, :]
    arg = (k * m % n_fft).double() * (2 * np.pi / n_fft)
    tol = BASIS_ULPS * 2.0**-24 * w.abs()
    fits = all(
        bool(((b.double() - fn(arg) * w).abs() <= tol).all())
        for b, fn in ((cos, torch.cos), (sin, torch.sin)))
    if not fits:
        raise ValueError(
            "the STFT kernels take windowed Fourier bases "
            "(ops/stft.py::stft_basis): cos / sin(2 pi k m / n_fft) w[m]; "
            "other bases take the route of ops/stft.py (stft_complex and "
            "log_magnitude, use_pallas_stft=False)")
    window = cos[0].contiguous()
    _WINDOWS[key] = (cos, sin, window)
    if len(_WINDOWS) > 8:
        _WINDOWS.pop(next(iter(_WINDOWS)))
    return window


@functools.lru_cache(maxsize=16)
def twiddles(n_fft: int, device) -> torch.Tensor:
    """``(n_fft, 2)``: ``cos``, ``sin`` of ``2 pi e / n_fft``, computed in
    float64 and rounded once; the kernels' inter-pass twiddles."""
    e = np.arange(n_fft) * (2 * np.pi / n_fft)
    table = np.stack([np.cos(e), np.sin(e)], 1).astype(np.float32)
    with torch.inference_mode(False):  # a constant kept across modes
        return torch.from_numpy(table).to(device)


def _plan(re, cos, hop, center):
    """``(t, n_fft, f, frames, pad)`` of the kernel path, or raise on what
    the kernels do not take."""
    t = re.shape[1]
    f, n_fft = cos.shape
    _check_sizes(f, n_fft)
    pad = n_fft // 2 if center else 0
    if center and t <= pad + 1:
        # the reflect fold of the backward holds for one reflection only
        raise ValueError(f"the STFT kernels need T > n_fft / 2 + 1 = "
                         f"{pad + 1} when centered, got T={t}")
    tp = t + 2 * pad
    if tp < n_fft:
        raise ValueError(f"signal of {tp} samples holds no {n_fft}-frame")
    return t, n_fft, f, (tp - n_fft) // hop + 1, pad


def _forward(re, im, hop, cos, sin, eps, fftshift, center):
    """The log-magnitude through kernel #10 on CUDA, the plain version on
    the CPU."""
    if re.device.type == "cpu":
        return stft_logmag_reference(re, im, hop, cos, sin, eps, fftshift,
                                     center)
    check_cuda("STFT", re=re, im=im, cos=cos, sin=sin)
    t, n_fft, f, frames, pad = _plan(re, cos, hop, center)
    window = fourier_window(cos, sin)
    n = re.shape[0]
    out = torch.empty((n, f, frames), dtype=torch.float32, device=re.device)
    launch(
        kernel_function("stft_fwd.cu", "stft_fwd_f32", 5, 8, 1),
        "stft_fwd", re.device,
        re.data_ptr(), im.data_ptr(), window.data_ptr(),
        twiddles(n_fft, re.device).data_ptr(), out.data_ptr(),
        n, t, n_fft, hop, f, frames, pad, int(fftshift), eps,
    )
    stft_logmag.launches += 1
    return out


def stft_logmag_backward(re, im, hop: int, cos, sin, g, eps: float = 1e-6,
                         fftshift: bool = True, center: bool = True):
    """Backward of :func:`stft_logmag` through kernel #11: ``(dre, dim)``
    as :func:`stft_logmag_backward_reference` returns them. A CPU tensor
    goes to that plain version; a CUDA tensor launches the kernel (counted
    in ``stft_logmag_backward.launches``) or raises. The result is the same
    bit for bit from launch to launch."""
    _check(re, im, cos, sin, hop)
    if re.device.type == "cpu":
        return stft_logmag_backward_reference(re, im, hop, cos, sin, g, eps,
                                              fftshift, center)
    check_cuda("STFT", re=re, im=im, cos=cos, sin=sin, g=g)
    t, n_fft, f, frames, pad = _plan(re, cos, hop, center)
    n = re.shape[0]
    if g.dtype != torch.float32 or tuple(g.shape) != (n, f, frames):
        raise ValueError(f"g must be float32 {(n, f, frames)}, got "
                         f"{g.dtype} {tuple(g.shape)}")
    window = fourier_window(cos, sin)
    dre = torch.empty_like(re)
    dim = torch.empty_like(im)
    # the reflect padding's sums, (re, im) x (left, right) x pad a signal
    edges = torch.empty((n, 4 * pad), dtype=torch.float32, device=re.device)
    launch(
        kernel_function("stft_bwd.cu", "stft_bwd_f32", 8, 8, 1),
        "stft_bwd", re.device,
        re.data_ptr(), im.data_ptr(), window.data_ptr(),
        twiddles(n_fft, re.device).data_ptr(), g.data_ptr(),
        dre.data_ptr(), dim.data_ptr(), edges.data_ptr(),
        n, t, n_fft, hop, f, frames, pad, int(fftshift), eps,
    )
    stft_logmag_backward.launches += 1
    return dre, dim


class StftLogmag(torch.autograd.Function):
    """Kernel #10 forward, kernel #11 backward; zero cotangents for the
    bases (constants by contract, as in the JAX VJP)."""

    @staticmethod
    def forward(ctx, re, im, cos, sin, hop, eps, fftshift, center):
        ctx.save_for_backward(re, im, cos, sin)
        ctx.args = (hop, eps, fftshift, center)
        return _forward(re, im, hop, cos, sin, eps, fftshift, center)

    @staticmethod
    def backward(ctx, g):
        re, im, cos, sin = ctx.saved_tensors
        hop, eps, fftshift, center = ctx.args
        dre, dim = stft_logmag_backward(re, im, hop, cos, sin, g.contiguous(),
                                        eps, fftshift, center)
        d_cos = torch.zeros_like(cos) if ctx.needs_input_grad[2] else None
        d_sin = torch.zeros_like(sin) if ctx.needs_input_grad[3] else None
        return dre, dim, d_cos, d_sin, None, None, None, None


def stft_logmag(re, im, hop: int, cos, sin, *, eps: float = 1e-6,
                fftshift: bool = True, center: bool = True):
    """``log(|STFT(re + i im)| + eps)``, ``(N, F, T // hop + 1)`` when
    centered, differentiable in ``re`` and ``im``.

    CPU tensors go to the plain versions; CUDA tensors launch kernel #10
    (counted in ``stft_logmag.launches``) and, in the backward, kernel #11,
    or raise. The kernels take windowed Fourier bases
    (:func:`fourier_window`) of a power-of-two ``n_fft`` from 64 to 1024,
    ``F <= n_fft`` bins and, centered, ``T > n_fft / 2 + 1``.
    """
    _check(re, im, cos, sin, hop)
    return StftLogmag.apply(re, im, cos, sin, int(hop), float(eps),
                            bool(fftshift), bool(center))


stft_logmag.launches = 0
stft_logmag_backward.launches = 0
