"""VirtualRadar: the radar return of a skeleton, in plain torch, and its
sequence-parallel form.

Counterpart of ``skeleton_action_recognition_tpu/ops/virtual_radar.py``
(``radar_return``, ``radar_return_upsampled``,
``virtual_radar_spectrogram``, ``radar_return_sharded``,
``radar_spectrogram_sharded``). Each bone (edge) is an ellipsoid
scatterer: its radar-cross-section amplitude and round-trip phase ``4 pi d
/ lambda`` are computed per time step, and the complex returns of all
edges and bodies are summed into one signal. These are the spectrogram
model's routes without the fused kernel: ``num_pad_frames <= 1``
(:func:`radar_return`) and ``use_pallas=False``
(:func:`radar_return_upsampled`); :func:`virtual_radar_spectrogram` is the
whole layer on raw frames as one function. Autograd differentiates them;
the norms have a zero gradient at zero, because all-zero second bodies are
routine in NTU clips.

The sequence-parallel ops split the upsampled time axis over the ranks of
a ``torch.distributed`` process group (the JAX package's mesh axis): each
rank computes its block of the resampling operator's rows through the
dense radar kernels (``ops/radar.py::dense_radar``, #8 and #9), the mean
bone length is summed over the ranks, and the spectrogram's frames come
from each rank's own samples and its neighbours' halos through the STFT
kernels (``ops/stft_logmag.py``, #10 and #11). The collectives are
``parallel/distributed.py``'s.
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
from skeleton_action_recognition_tpu_torch.ops.stft_logmag import stft_logmag
from skeleton_action_recognition_tpu_torch.parallel import distributed


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


def _rank_signal(x_raw, pad_operator, radar_location, wavelength, group,
                 edges, rows_per_rank):
    """This rank's block of ``rows_per_rank`` rows of ``pad_operator``
    (padded with zero rows to that many a rank) through the dense radar
    kernels: ``(re, im)``, each ``(N, rows_per_rank)``. The bone lengths'
    sum is this rank's rows' sum, summed over the ranks; the joints, the
    location, the wavelength and ``c`` are replicated inputs, so that their
    gradients are summed over the ranks."""
    from skeleton_action_recognition_tpu_torch.ops import radar

    rank, world = distributed.rank(group), distributed.world_size(group)
    device = x_raw.device
    w = torch.as_tensor(pad_operator, dtype=torch.float32, device=device)
    t_out = w.shape[0]
    w = torch.nn.functional.pad(w, (0, 0, 0, rows_per_rank * world - t_out))
    rows = w[rank * rows_per_rank:(rank + 1) * rows_per_rank]
    x = distributed.replicated_input(x_raw, group)
    loc, lam = (distributed.replicated_input(torch.as_tensor(
        v, dtype=torch.float32, device=device), group)
        for v in (radar_location, wavelength))
    total = distributed.sum_partials(radar.bone_length_sum(x, rows, edges),
                                     group)
    # every rank uses c for its own rows alone: its cotangent is summed
    c = distributed.replicated_input((total / t_out) ** 2, group)
    return radar.radar_return_rows(x, rows, c, loc, lam, edges)


def radar_return_sharded(
    x_raw,
    pad_operator,
    radar_location,
    wavelength,
    group=None,
    edges: Sequence[Tuple[int, int]] = tuple(RADAR_EDGES),
):
    """Sequence-parallel radar return: the rows of the ``(T_out, T_in)``
    resampling operator ``pad_operator`` split over the ranks of ``group``
    (None: the default process group), as the JAX package shards them over
    a mesh axis. The operator's rows are padded with zero rows to a
    multiple of the world size, and each rank computes its block through
    kernel #8 (#9 in the backward); the time-mean bone length is summed
    over the ranks, and the signal's blocks are gathered.

    Returns ``(re, im)``, each ``(N, T_out)``, the same on every rank;
    differentiable in ``x_raw``, the location and the wavelength, every
    rank getting the gradient of one process. Without a process group the
    result is ``ops/radar.py::radar_return_fused``'s."""
    world = distributed.world_size(group)
    t_out = pad_operator.shape[0]
    rows_per_rank = -(-t_out // world)
    re, im = _rank_signal(x_raw, pad_operator, radar_location, wavelength,
                          group, edges, rows_per_rank)
    return (distributed.gather_slices(re, 1, group)[:, :t_out],
            distributed.gather_slices(im, 1, group)[:, :t_out])


def radar_spectrogram_sharded(
    x_raw,
    pad_operator,
    radar_location,
    wavelength,
    group=None,
    edges: Sequence[Tuple[int, int]] = tuple(RADAR_EDGES),
    n_fft: int = 256,
    hop_length: int = 16,
):
    """Sequence-parallel radar -> log-magnitude spectrogram: the signal and
    the STFT frames split over the ranks of ``group`` (None: the default
    process group); the signal is never gathered. Each rank computes its
    ``T_out / world`` samples as :func:`radar_return_sharded` does, takes
    the ``n_fft / 2`` samples on each side from its neighbours (the first
    and last ranks reflect their own edge, as the centered STFT pads), and
    computes its ``T_loc / hop_length`` frames through kernel #10 (#11 in
    the backward) with ``center=False``; the last rank's segment holds the
    final (``T_out / hop_length + 1``-th) frame as well. The frames are
    gathered.

    ``T_out`` must split into hop-aligned blocks, one a rank, each at least
    ``n_fft / 2`` long (``ValueError`` otherwise, as in JAX). Returns ``(N,
    n_fft, T_out / hop_length + 1)``, zero Doppler centered, the same on
    every rank; differentiable in ``x_raw``, the location and the
    wavelength, every rank getting the gradient of one process."""
    rank, world = distributed.rank(group), distributed.world_size(group)
    t_out = pad_operator.shape[0]
    if t_out % world or (t_out // world) % hop_length:
        raise ValueError(
            f"T_out={t_out} must split evenly into {world} hop-aligned "
            "shards"
        )
    t_loc = t_out // world
    pad = n_fft // 2
    if pad > t_loc:
        raise ValueError("halo exceeds local shard length")
    sig = torch.stack(_rank_signal(x_raw, pad_operator, radar_location,
                                   wavelength, group, edges, t_loc))
    left, right = distributed.halo_exchange(sig[..., :pad], sig[..., -pad:],
                                            group)
    if rank == 0:  # the centered STFT's reflect padding of the first sample
        left = sig[..., 1:pad + 1].flip(-1)
    if rank == world - 1:
        right = sig[..., -pad - 1:-1].flip(-1)
    re, im = torch.cat([left, sig, right], -1)  # each (N, T_loc + n_fft)
    cos_np, sin_np = stft.stft_basis(n_fft)
    cos = torch.tensor(cos_np, device=sig.device)
    sin = torch.tensor(sin_np, device=sig.device)
    # T_loc / hop + 1 frames; the last one is the next rank's first, and on
    # the last rank the spectrogram's final frame
    frames = stft_logmag(re, im, hop_length, cos, sin, center=False)
    f_loc = t_loc // hop_length
    last = frames[..., f_loc:]
    if rank != world - 1:
        last = torch.zeros_like(last)
    return torch.cat([
        distributed.gather_slices(frames[..., :f_loc], 2, group),
        distributed.sum_partials(last, group),
    ], -1)
