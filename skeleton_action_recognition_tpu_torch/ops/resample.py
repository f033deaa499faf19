"""Gaussian smoothing + cubic time-upsampling as linear operators.

Counterpart of ``skeleton_action_recognition_tpu/ops/resample.py``. The
operators are built on the host with numpy and scipy, by pushing the
identity matrix through ``gaussian_filter1d`` and the not-a-knot cubic
spline, so the boundary handling is scipy's own; they are copies of the
JAX package's builders (that module imports jax at the top, so the port
cannot import it). :func:`pad_frames` applies them to a tensor.

The spline factorization (:func:`spline_coefficient_operator`,
:func:`spline_tile_plan`) is what the radar kernels read: every padded
output row evaluates one cubic segment of the same spline, so the dense
``(T_out, T_in)`` operator reduces to per-segment coefficients and per-row
monomials.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


@functools.lru_cache(maxsize=32)
def gaussian_smooth_matrix(n: int, sigma: float) -> np.ndarray:
    """``(n, n)`` operator of ``scipy.ndimage.gaussian_filter1d`` (reflect)."""
    from scipy.ndimage import gaussian_filter1d

    return gaussian_filter1d(np.eye(n), sigma, axis=0)


@functools.lru_cache(maxsize=32)
def cubic_interp_matrix(t_in: int, t_out: int) -> np.ndarray:
    """``(t_out, t_in)`` operator of ``interp1d(linspace(0,1,t_in), ·,
    'cubic')`` evaluated at ``linspace(0,1,t_out)`` (not-a-knot spline)."""
    from scipy.interpolate import interp1d

    f = interp1d(
        np.linspace(0.0, 1.0, t_in), np.eye(t_in), "cubic", axis=0
    )
    return f(np.linspace(0.0, 1.0, t_out))


@functools.lru_cache(maxsize=32)
def pad_frames_operator(
    t_in: int,
    num_pad_frames: int,
    sigma: float = 3.0,
    dtype=np.float32,
) -> np.ndarray:
    """Smooth-then-upsample operator ``(t_in * num_pad_frames, t_in)``:
    Gaussian smoothing over time, then cubic upsampling by
    ``num_pad_frames``x."""
    w = cubic_interp_matrix(t_in, num_pad_frames * t_in) @ (
        gaussian_smooth_matrix(t_in, sigma)
    )
    return w.astype(dtype)


def pad_frames(
    data: torch.Tensor,
    num_pad_frames: int = 1,
    sigma: float = 3.0,
    smooth_axis: str = "joints",
) -> torch.Tensor:
    """Smooth and cubic-upsample the time axis of ``(T, V, C)`` joint data.

    ``smooth_axis='joints'`` smooths over the joint axis first (the
    reference's module-level helper, the demo notebook's behaviour);
    ``'time'`` smooths over time (the reference dataset's, the training
    pipeline's). Both are float32 contractions of ``data`` with the
    float32 operators.
    """
    if data.ndim != 3:
        raise ValueError(
            f"pad_frames expects (T, V, C) joint data, got shape "
            f"{tuple(data.shape)}"
        )
    t, v, _ = data.shape

    def op(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(data.device)

    if smooth_axis == "joints":
        p = op(cubic_interp_matrix(t, num_pad_frames * t).astype(np.float32))
        g = op(gaussian_smooth_matrix(v, sigma).astype(np.float32))
        smoothed = torch.einsum("vu,tuc->tvc", g, data)
        return torch.einsum("ot,tvc->ovc", p, smoothed)
    if smooth_axis == "time":
        w = op(pad_frames_operator(t, num_pad_frames, sigma))
        return torch.einsum("ot,tvc->ovc", w, data)
    raise ValueError(f"unknown smooth_axis: {smooth_axis!r}")


@functools.lru_cache(maxsize=32)
def spline_coefficient_operator(t_in: int, sigma: float = 3.0):
    """Piecewise-cubic factorization of :func:`pad_frames_operator`.

    Returns the ``(nseg * 4, t_in)`` map from input samples to smoothed
    per-segment polynomial coefficients (ordered ``[seg, k]`` with
    ``f(t) = sum_k c[seg, k] * (t - x_seg)^(3-k)``), and the knot vector
    ``xs (t_in,)``, in float64.
    """
    from scipy.interpolate import CubicSpline

    xs = np.linspace(0.0, 1.0, t_in)
    g = gaussian_smooth_matrix(t_in, sigma)
    cs = CubicSpline(xs, g, axis=0, bc_type="not-a-knot")
    # cs.c: (4, nseg, t_in) with c[0] the cubic term
    cc = np.transpose(cs.c, (1, 0, 2)).reshape((t_in - 1) * 4, t_in)
    return cc, xs


@functools.lru_cache(maxsize=32)
def spline_tile_plan(
    t_in: int, num_pad_frames: int, tile: int, sigma: float = 3.0
):
    """Tiled evaluation plan of the spline-factorized resampler, for a
    ``tile``-row blocking of the padded time axis:

    * ``coeffs_op`` ``(nseg*4, t_in)`` f32: input samples to smoothed
      per-segment cubic coefficients (``[seg, k]`` ordering);
    * ``tile_seg`` ``(num_tiles, ns)`` int32: the spline segments each
      output tile touches (``ns``, the most under any tile, is 4 at the
      production 250x upsample with ``tile=512``);
    * ``eval_mat`` ``(num_tiles, tile, ns*4)`` f32: per-row monomials
      ``u^(3-k)`` one-hot-placed in the ``(slot, k)`` column of the row's
      segment. Rows past ``t_in * num_pad_frames`` are all-zero.

    ``eval_mat[j] @ gathered_coeffs[j]`` reproduces the dense operator's
    tile in float64. The arrays are returned cached: do not write to them.
    """
    t_out = t_in * num_pad_frames
    num_tiles = -(-t_out // tile)
    t_pad = num_tiles * tile
    nseg = t_in - 1
    cc, xs = spline_coefficient_operator(t_in, sigma)

    t = np.linspace(0.0, 1.0, t_out)
    seg = np.minimum(np.searchsorted(xs, t, side="right") - 1, nseg - 1)
    u = t - xs[seg]
    seg = np.concatenate([seg, np.full(t_pad - t_out, seg[-1], np.int64)])
    u = np.concatenate([u, np.zeros(t_pad - t_out)])
    valid = (np.arange(t_pad) < t_out).astype(np.float64)

    seg_t = seg.reshape(num_tiles, tile)
    u_t = u.reshape(num_tiles, tile)
    valid_t = valid.reshape(num_tiles, tile)
    first = seg_t[:, 0]
    ns = int((seg_t[:, -1] - first).max()) + 1
    tile_seg = np.minimum(
        first[:, None] + np.arange(ns)[None, :], nseg - 1
    ).astype(np.int32)

    slot = seg_t - first[:, None]  # (num_tiles, tile) in [0, ns)
    eval_mat = np.zeros((num_tiles, tile, ns, 4))
    jj, rr = np.meshgrid(
        np.arange(num_tiles), np.arange(tile), indexing="ij"
    )
    for k in range(4):
        eval_mat[jj, rr, slot, k] = (u_t ** (3 - k)) * valid_t
    return (
        cc.astype(np.float32),
        tile_seg,
        eval_mat.reshape(num_tiles, tile, ns * 4).astype(np.float32),
    )
