"""Fused STFT log-magnitude: the CUDA kernels and their plain versions.

Counterpart of ``skeleton_action_recognition_tpu/ops/pallas/stft.py``
(``stft_logmag``). For a complex signal given as two real channels ``re``,
``im (N, T)`` and windowed bases ``cos``, ``sin (F, n_fft)``:

    ``out = log(|STFT(re + i im)| + eps)``,  ``(N, F, frames)``,

centered (reflect padding of ``n_fft // 2``) and rolled by ``F // 2`` along
the bins (fftshift) by default, equal to ``log_magnitude(*stft_complex(...))``
of :mod:`.stft`. ``csrc/stft_fwd.cu`` (kernel #10, replacing
``_fwd_kernel``) computes it without storing the frames or the complex
spectrum; ``csrc/stft_bwd.cu`` (kernel #11, replacing ``_bwd_kernel`` and
``_overlap_add``) is its VJP with respect to ``re`` and ``im``.
:class:`StftLogmag` ties them into an autograd Function which, like the
JAX VJP, gives the bases a zero cotangent (models that train the bases
take the route of :mod:`.stft`).

The module is named apart from :mod:`.stft` as the JAX package's two
``stft`` modules are. The reflect padding and the packing of the bases
(the fftshift folded into them) are plain torch in the wrapper.
"""

from __future__ import annotations

import torch

from skeleton_action_recognition_tpu_torch.ops.build import (
    MAX_SMEM_BYTES,
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

# csrc/stft_tile.cuh: frames and bins per block, samples per basis chunk
_TF, _TB, _KC = 64, 64, 64


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


def _plan(re, cos, hop, center):
    """``(t, tp, n_fft, f, frames, pad)`` of the kernel path, or raise on
    what the kernels do not take."""
    t = re.shape[1]
    f, n_fft = cos.shape
    pad = n_fft // 2 if center else 0
    if n_fft % _KC or f % _TB:
        raise ValueError(f"the STFT kernels take n_fft % {_KC} == 0 and "
                         f"F % {_TB} == 0, got n_fft={n_fft}, F={f}")
    if center and t <= pad + 1:
        # the reflect fold of the backward holds for one reflection only
        raise ValueError(f"the STFT kernels need T > n_fft / 2 + 1 = "
                         f"{pad + 1} when centered, got T={t}")
    tp = t + 2 * pad
    if tp < n_fft:
        raise ValueError(f"signal of {tp} samples holds no {n_fft}-frame")
    span = (_TF - 1) * hop + n_fft
    smem = 4 * (2 * span + max(2 * _KC * _TB, 2 * _TB * (_TF + 1)))
    if smem > MAX_SMEM_BYTES:
        raise ValueError(f"hop {hop} needs {smem} bytes of shared memory "
                         "a block, more than Hopper has")
    return t, tp, n_fft, f, (tp - n_fft) // hop + 1, pad



def _padded(re, im, pad):
    if not pad:
        return re.contiguous(), im.contiguous()
    return reflect_pad(re, pad), reflect_pad(im, pad)


def _forward(re, im, hop, cos, sin, eps, fftshift, center):
    """The log-magnitude through kernel #10 on CUDA, the plain version on
    the CPU."""
    if re.device.type == "cpu":
        return stft_logmag_reference(re, im, hop, cos, sin, eps, fftshift,
                                     center)
    check_cuda("STFT", re=re, im=im, cos=cos, sin=sin)
    t, tp, n_fft, f, frames, pad = _plan(re, cos, hop, center)
    n = re.shape[0]
    re_p, im_p = _padded(re, im, pad)
    c_r, s_r = _rolled(cos, sin, fftshift)
    cs, ss = c_r.T.contiguous(), s_r.T.contiguous()  # (n_fft, F)
    out = torch.empty((n, f, frames), dtype=torch.float32, device=re.device)
    launch(
        kernel_function("stft_fwd.cu", "stft_fwd_f32", 5, 6, 1),
        "stft_fwd", re.device,
        re_p.data_ptr(), im_p.data_ptr(), cs.data_ptr(), ss.data_ptr(),
        out.data_ptr(), n, tp, n_fft, hop, f, frames, eps,
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
    t, tp, n_fft, f, frames, pad = _plan(re, cos, hop, center)
    n = re.shape[0]
    if g.dtype != torch.float32 or tuple(g.shape) != (n, f, frames):
        raise ValueError(f"g must be float32 {(n, f, frames)}, got "
                         f"{g.dtype} {tuple(g.shape)}")
    re_p, im_p = _padded(re, im, pad)
    c_r, s_r = _rolled(cos, sin, fftshift)
    cs, ss = c_r.T.contiguous(), s_r.T.contiguous()
    kb = torch.cat([torch.cat([c_r, s_r], 1), torch.cat([-s_r, c_r], 1)])
    gbuf = torch.empty((n, frames, 2 * f), dtype=torch.float32,
                       device=re.device)
    dfr = torch.empty((n, frames, 2 * n_fft), dtype=torch.float32,
                      device=re.device)
    dre = torch.empty_like(re)
    dim = torch.empty_like(im)
    launch(
        kernel_function("stft_bwd.cu", "stft_bwd_f32", 10, 8, 1),
        "stft_bwd", re.device,
        re_p.data_ptr(), im_p.data_ptr(), cs.data_ptr(), ss.data_ptr(),
        kb.data_ptr(), g.data_ptr(), gbuf.data_ptr(), dfr.data_ptr(),
        dre.data_ptr(), dim.data_ptr(),
        n, tp, t, n_fft, hop, f, frames, pad, eps,
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
    or raise. The kernels take ``n_fft`` and ``F`` in multiples of 64 and,
    centered, ``T > n_fft / 2 + 1``.
    """
    _check(re, im, cos, sin, hop)
    return StftLogmag.apply(re, im, cos, sin, int(hop), float(eps),
                            bool(fftshift), bool(center))


stft_logmag.launches = 0
stft_logmag_backward.launches = 0
