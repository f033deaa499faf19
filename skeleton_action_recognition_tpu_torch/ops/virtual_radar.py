"""VirtualRadar: the radar return of a skeleton, in plain torch.

Counterpart of ``skeleton_action_recognition_tpu/ops/virtual_radar.py``
(``radar_return``, ``radar_return_upsampled``,
``virtual_radar_spectrogram``). Each bone (edge) is an ellipsoid
scatterer: its radar-cross-section amplitude and round-trip phase ``4 pi d
/ lambda`` are computed per time step, and the complex returns of all
edges and bodies are summed into one signal. These are the spectrogram
model's routes without the fused kernel: ``num_pad_frames <= 1``
(:func:`radar_return`) and ``use_pallas=False``
(:func:`radar_return_upsampled`); :func:`virtual_radar_spectrogram` is the
whole layer on raw frames as one function. Autograd differentiates them;
the norms have a zero gradient at zero, because all-zero second bodies are
routine in NTU clips.
"""

from __future__ import annotations

import functools
import math
from typing import Sequence, Tuple

import torch

from skeleton_action_recognition_tpu_torch.graphs.ntu_rgb_d import (
    RADAR_EDGES,
)
from skeleton_action_recognition_tpu_torch.ops import stft
from skeleton_action_recognition_tpu_torch.ops.precision import einsum_f32


@functools.lru_cache(maxsize=8)
def _edge_index(edges: Tuple[Tuple[int, int], ...], device):
    with torch.inference_mode(False):  # a constant a training step saves
        return tuple(torch.tensor([e[i] for e in edges], device=device)
                     for i in (0, 1))


def gather_edges(x, edges):
    """The endpoints ``(src, dst)``, each ``(N, 3, T, E, M)``, of
    ``edges`` in joints ``x (N, 3, T, V, M)``. The index tensors are kept
    on ``x``'s device per edge list (a copy from the host on every call
    would wait for the device)."""
    src_idx, dst_idx = _edge_index(tuple(map(tuple, edges)), x.device)
    return x[:, :, :, src_idx], x[:, :, :, dst_idx]


def safe_norm(x, dim):
    """L2 norm over ``dim`` whose gradient at the origin is zero (not
    NaN); the values equal the plain norm's."""
    s = (x * x).sum(dim)
    zero = s == 0
    return torch.where(zero, 0.0, torch.sqrt(torch.where(zero, 1.0, s)))


def radar_return(
    x,
    radar_location,
    wavelength,
    edges: Sequence[Tuple[int, int]] = tuple(RADAR_EDGES),
):
    """Complex radar signal ``(re, im)``, each ``(N, T)``, of joint
    trajectories ``x (N, 3, T, V, M)`` seen from ``radar_location (3,)`` at
    ``wavelength`` (a scalar tensor), summed over ``edges`` and bodies."""
    src, dst = gather_edges(x, edges)  # (N, 3, T, E, M)
    mean_len = safe_norm(dst - src, 1).mean(1, keepdim=True)  # (N,1,E,M)
    return _edge_returns(src, dst, radar_location, wavelength, mean_len)


def _edge_returns(src, dst, radar_location, wavelength, mean_len):
    """Per-step returns of gathered endpoints ``src``/``dst (N, 3, T, E,
    M)`` with the time-mean bone length ``mean_len (N, 1, E, M)``, summed
    over edges and bodies: ``(re, im)``, each ``(N, T)``. The amplitude
    uses ``mean_len`` directly (``sqrt(c)`` would have an infinite
    derivative at zero-length bones)."""
    loc_b = radar_location[None, :, None, None, None]
    rev = src - loc_b
    distances = safe_norm(rev, 1)
    a_vec = loc_b - (src + dst) / 2.0
    b_vec = dst - src
    cos_theta = (a_vec * b_vec).sum(1) / (
        safe_norm(a_vec, 1) * safe_norm(b_vec, 1) + 1e-6
    )
    # the clip keeps d(arccos) finite at the degenerate |ct| = 1 corner
    theta = torch.arccos(torch.clamp(cos_theta, -1.0 + 1e-7, 1.0 - 1e-7))
    sin_phi = (radar_location[1] - src[:, 1]) / (
        safe_norm(rev[:, :2], 1) + 1e-6
    )
    phi = torch.arcsin(torch.clamp(sin_phi, -1.0 + 1e-7, 1.0 - 1e-7))
    c = mean_len * mean_len
    sin_t2 = torch.sin(theta) ** 2
    denom = torch.abs(
        sin_t2 * torch.cos(phi) ** 2
        + sin_t2 * torch.sin(phi) ** 2
        + c * torch.cos(theta) ** 2
    )
    amp = math.sqrt(math.pi) * mean_len / denom
    phase = 4.0 * math.pi * distances / wavelength
    re = (amp * torch.cos(phase)).sum((2, 3))
    im = (amp * torch.sin(phase)).sum((2, 3))
    return re, im


def pick_tile(t_out: int, target: int = 1536) -> int:
    """Largest divisor of ``t_out`` not exceeding ``target``."""
    return max(d for d in range(1, min(target, t_out) + 1) if t_out % d == 0)


def radar_return_upsampled(
    x_raw,
    pad_operator,
    radar_location,
    wavelength,
    edges: Sequence[Tuple[int, int]] = tuple(RADAR_EDGES),
    tile: int | None = None,
):
    """Radar return of ``x_raw (N, 3, T_in, V, M)`` upsampled by the
    ``(T_out, T_in)`` smoothing-and-interpolation ``pad_operator``
    (:func:`..resample.pad_frames_operator`), without materializing the
    ``(N, 3, T_out, V, M)`` padded joints: each ``tile`` of output rows
    (a divisor of ``T_out``, picked when None) is interpolated from the
    gathered edge endpoints and reduced to the signal at once. Two passes,
    because the amplitude uses the bone length's mean over the padded
    time axis. Returns ``(re, im)``, each ``(N, T_out)``."""
    t_out = pad_operator.shape[0]
    if tile is None:
        tile = pick_tile(t_out)
    if t_out % tile:
        raise ValueError(f"tile {tile} must divide T_out {t_out}")
    src_raw, dst_raw = gather_edges(x_raw, edges)  # (N, 3, T_in, E, M)
    w_tiles = pad_operator.split(tile)

    def interp(w_tile, raw):
        return einsum_f32("ot,nctem->ncoem", w_tile, raw)

    bone_raw = dst_raw - src_raw
    len_sum = sum(
        safe_norm(interp(w, bone_raw), 1).sum(1) for w in w_tiles
    )
    mean_len = (len_sum / t_out)[:, None]  # (N, 1, E, M)
    parts = [
        _edge_returns(
            interp(w, src_raw), interp(w, dst_raw), radar_location,
            wavelength, mean_len,
        )
        for w in w_tiles
    ]
    return (torch.cat([p[0] for p in parts], 1),
            torch.cat([p[1] for p in parts], 1))


def virtual_radar_spectrogram(
    x,
    radar_location,
    wavelength,
    cos_basis=None,
    sin_basis=None,
    edges: Sequence[Tuple[int, int]] = tuple(RADAR_EDGES),
    n_fft: int = 256,
    hop_length: int = 16,
):
    """The VirtualRadar forward on raw frames: joints ``x (N, 3, T, V, M)``
    -> the log-magnitude spectrogram ``(N, n_fft, T // hop_length + 1)``,
    zero Doppler centered (the JAX package's ``virtual_radar_spectrogram``).
    :func:`radar_return`, then :func:`..stft.stft_complex` with the
    windowed Fourier bases ``cos_basis``/``sin_basis`` (Hann,
    :func:`..stft.stft_basis`, where not given), then
    :func:`..stft.log_magnitude`."""
    if cos_basis is None or sin_basis is None:
        cos_np, sin_np = stft.stft_basis(n_fft)
        if cos_basis is None:
            cos_basis = torch.tensor(cos_np, device=x.device)
        if sin_basis is None:
            sin_basis = torch.tensor(sin_np, device=x.device)
    re, im = radar_return(x, radar_location, wavelength, edges)
    s_re, s_im = stft.stft_complex(re, im, hop_length, cos_basis, sin_basis)
    return stft.log_magnitude(s_re, s_im)
