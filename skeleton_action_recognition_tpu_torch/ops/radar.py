"""The fused radar return: the CUDA kernels and their plain versions.

Counterpart of ``skeleton_action_recognition_tpu/ops/pallas/radar.py``, in
two halves.

The dense route (``radar_return_fused`` and its ``_kernel_op``): the
joints are upsampled by a dense ``(T_out, T_in)`` resampling operator
``w`` (:func:`..resample.pad_frames_operator`), whose rows are contracted
with every edge endpoint's gathered features ``src``/``dst (N, T_in, 3
EM)``. ``csrc/radar_dense_fwd.cu`` (kernel #8, replacing ``_radar_kernel``)
computes the positions of a block of rows as a matrix product in f32 over
the operator's band (:func:`dense_band`: the columns that hold more than
f32 rounding of a row) and sums every edge-body pair's return;
``csrc/radar_dense_bwd.cu`` (kernel #9, replacing ``_radar_bwd_kernel``) is
its VJP with respect to ``src``, ``dst``, ``c``, ``loc`` and ``lambda``,
the operator being a constant. :class:`DenseRadar` ties them into an
autograd Function;
:func:`radar_return_fused` is the op, with the gather and the bone lengths
(:func:`bone_length_mean_sq`) in plain torch around it
(:func:`radar_return_rows` its kernel stage on any block of rows, which the
sequence-parallel ops of :mod:`.virtual_radar` run on each rank's).

The spline route (``radar_return_spline`` and its ``_spline_kernel_op``),
the spectrogram model's. The skeleton's joints are smoothed and upsampled
``num_pad_frames``x by one not-a-knot spline
(:func:`..resample.spline_tile_plan`), so every padded time row of a
``tile``-row block evaluates one cubic segment: the kernel's inputs are
the per-tile segment coefficients of every edge endpoint ``src``/``dst
(N, num_tiles, 3 * EM, 4 * NS)`` and the per-row one-hot monomials ``e
(num_tiles, 4 * NS, tile)``. ``csrc/radar_fwd.cu`` (kernel #6, replacing
``_radar_spline_kernel``) evaluates the endpoints and sums every
edge-body pair's ellipsoid-RCS return ``amp * exp(i 4 pi d / lambda)``;
``csrc/radar_bwd.cu`` (kernel #7, replacing ``_radar_spline_bwd_kernel``)
is its VJP with respect to ``src``, ``dst``, ``c``, ``loc`` and
``lambda``, the monomials being a constant, in two instances: all five
cotangents, or only ``loc``'s and ``lambda``'s where nothing else needs
one (the spectrogram trainer's case). Both kernels' device code is
``csrc/radar_spline.cuh``. :class:`SplineRadar` ties them into an
autograd Function.

The coefficient contraction, the segment gather and the bone lengths
(:func:`bone_length_mean_sq_spline`) are plain torch here, as they are
plain autodiff in JAX.

Everything is float32. ``loc`` and ``lambda`` stay on the device (the
kernels read them there, so a step never waits for the host).
"""

from __future__ import annotations

import functools
import math
from typing import Sequence, Tuple

import numpy as np
import torch

from skeleton_action_recognition_tpu_torch.graphs.ntu_rgb_d import (
    RADAR_EDGES,
)
from skeleton_action_recognition_tpu_torch.ops.build import (
    MAX_SMEM_BYTES,
    check_cuda,
    kernel_function,
    launch,
)
from skeleton_action_recognition_tpu_torch.ops.precision import einsum_f32
from skeleton_action_recognition_tpu_torch.ops.resample import (
    spline_tile_plan,
)
from skeleton_action_recognition_tpu_torch.ops.virtual_radar import (
    gather_edges,
    safe_norm,
)

TILE = 512
_FOUR_PI = 4.0 * math.pi
# the backward kernel's block size (csrc/radar_spline.cuh, kBwdThreads),
# with which the wrapper sizes its shared memory before launching
_BWD_THREADS = 192
# tiles a plain version evaluates at once: bounds its temporaries to a few
# hundred MB at the production shape (N = 16, 147 tiles of 512 rows)
_PLAIN_TILES = 16


def _scatter_fwd(lam, loc, s, d, c):
    """The JAX kernel's ``_scatter_fwd_core``: endpoint coordinates ``s``,
    ``d`` (tuples of x, y, z tensors), ``c`` broadcast against them ->
    ``(amp, phase)``."""
    lx, ly, lz = loc[0], loc[1], loc[2]
    sx, sy, sz = s
    dx, dy, dz = d
    rx, ry, rz = sx - lx, sy - ly, sz - lz
    dist = torch.sqrt(rx * rx + ry * ry + rz * rz)
    ax, ay, az = lx - (sx + dx) * 0.5, ly - (sy + dy) * 0.5, lz - (sz + dz) * 0.5
    bx, by, bz = dx - sx, dy - sy, dz - sz
    dot = ax * bx + ay * by + az * bz
    na = torch.sqrt(ax * ax + ay * ay + az * az)
    nb = torch.sqrt(bx * bx + by * by + bz * bz)
    ct = dot / (na * nb + 1e-6)
    ct2 = ct * ct
    denom = torch.abs((1.0 - ct2) + c * ct2)
    amp = torch.sqrt(math.pi * c) / denom
    phase = (_FOUR_PI / lam) * dist
    return amp, phase


def _inv(v):
    return torch.where(v > 0, 1.0 / torch.where(v > 0, v, 1.0), 0.0)


def _scatter_bwd(lam, loc, s, d, c, gre, gim, coef=True):
    """The JAX kernel's ``_scatter_bwd_core``: the cotangents
    ``(g_s, g_d, g_c, g_l, g_lam)`` of one batch of pairs from the output
    cotangent ``(gre, gim)``, with its guards (``sign(u)``, ``amp / 2c`` only
    where ``c > 0``, zero inverses of zero norms). With ``coef=False`` only
    ``g_l`` and ``g_lam`` (the same values), and ``None`` for the others."""
    lx, ly, lz = loc[0], loc[1], loc[2]
    sx, sy, sz = s
    dx, dy, dz = d
    k = _FOUR_PI / lam
    rx, ry, rz = sx - lx, sy - ly, sz - lz
    dist = torch.sqrt(rx * rx + ry * ry + rz * rz)
    ax, ay, az = lx - (sx + dx) * 0.5, ly - (sy + dy) * 0.5, lz - (sz + dz) * 0.5
    bx, by, bz = dx - sx, dy - sy, dz - sz
    dot = ax * bx + ay * by + az * bz
    na = torch.sqrt(ax * ax + ay * ay + az * az)
    nb = torch.sqrt(bx * bx + by * by + bz * bz)
    den = na * nb + 1e-6
    ct = dot / den
    ct2 = ct * ct
    u = (1.0 - ct2) + c * ct2
    au = torch.abs(u)
    amp = torch.sqrt(math.pi * c) / au
    phase = k * dist
    cosp, sinp = torch.cos(phase), torch.sin(phase)

    g_amp = gre * cosp + gim * sinp
    g_phase = amp * (gim * cosp - gre * sinp)
    g_dist = g_phase * k
    g_au = -(amp / au) * g_amp
    g_u = torch.sign(u) * g_au
    g_ct = g_u * (2.0 * ct * (c - 1.0))
    g_dot = g_ct / den
    g_den = g_ct * (-ct / den)
    inv_na, inv_nb, inv_d = _inv(na), _inv(nb), _inv(dist)
    g_ax = g_dot * bx + g_den * nb * ax * inv_na
    g_ay = g_dot * by + g_den * nb * ay * inv_na
    g_az = g_dot * bz + g_den * nb * az * inv_na
    g_rx, g_ry, g_rz = g_dist * rx * inv_d, g_dist * ry * inv_d, g_dist * rz * inv_d
    g_l = (-g_rx + g_ax, -g_ry + g_ay, -g_rz + g_az)
    g_lam = (-k / lam) * (g_phase * dist)
    if not coef:
        return None, None, None, g_l, g_lam
    g_c = g_u * ct2 + g_amp * torch.where(c > 0, amp / (2.0 * c), 0.0)
    g_bx = g_dot * ax + g_den * na * bx * inv_nb
    g_by = g_dot * ay + g_den * na * by * inv_nb
    g_bz = g_dot * az + g_den * na * bz * inv_nb
    g_s = (g_rx - 0.5 * g_ax - g_bx, g_ry - 0.5 * g_ay - g_by,
           g_rz - 0.5 * g_az - g_bz)
    g_d = (-0.5 * g_ax + g_bx, -0.5 * g_ay + g_by, -0.5 * g_az + g_bz)
    return g_s, g_d, g_c, g_l, g_lam


def _positions(coef, e):
    """``coef (N, J, 3 EM, ns4)`` at the rows of ``e (J, ns4, tile)``: the
    x, y, z coordinates, each ``(N, J, EM, tile)``."""
    pos = einsum_f32("njfq,jqr->njfr", coef, e)
    return pos.unflatten(2, (3, -1)).unbind(2)


def spline_radar_reference(e, src, dst, c, loc, lam, t_out: int):
    """Plain PyTorch kernel #6: ``(re, im)``, each ``(N, t_out)``, of the
    tiles' coefficients ``src``/``dst (N, num_tiles, 3 EM, ns4)`` at the
    monomials ``e (num_tiles, ns4, tile)``, with ``c (N, EM)``, ``loc
    (3,)`` and the scalar ``lam``. The direct formulas, a chunk of tiles at
    a time; the padded rows are computed and cut, as in JAX."""
    n, num_tiles = src.shape[:2]
    cb = c[:, None, :, None]
    re, im = [], []
    for j0 in range(0, num_tiles, _PLAIN_TILES):
        j1 = min(num_tiles, j0 + _PLAIN_TILES)
        ej = e[j0:j1]
        amp, phase = _scatter_fwd(
            lam, loc, _positions(src[:, j0:j1], ej),
            _positions(dst[:, j0:j1], ej), cb,
        )
        re.append((amp * torch.cos(phase)).sum(2))
        im.append((amp * torch.sin(phase)).sum(2))
    return (torch.cat(re, 1).reshape(n, -1)[:, :t_out],
            torch.cat(im, 1).reshape(n, -1)[:, :t_out])


def spline_radar_backward_reference(e, src, dst, c, loc, lam, gre, gim,
                                    t_out: int, coef_grads: bool = True):
    """Plain PyTorch kernel #7: the cotangents ``(dsrc, ddst, dc, dloc,
    dlam)`` of :func:`spline_radar_reference` from ``(gre, gim) (N,
    t_out)``: a transcription of the JAX kernel's ``_scatter_bwd_core`` and
    the contraction of the per-row cotangents with the monomials. (Autograd
    through the plain forward gives NaN where ``c = 0``.) With
    ``coef_grads=False`` it computes only ``dloc`` and ``dlam``, the same
    values, and returns ``(None, None, None, dloc, dlam)``."""
    n, num_tiles, f3, ns4 = src.shape
    tile = e.shape[2]
    pad = num_tiles * tile - t_out
    gre = torch.nn.functional.pad(gre, (0, pad)).reshape(n, num_tiles, tile)
    gim = torch.nn.functional.pad(gim, (0, pad)).reshape(n, num_tiles, tile)
    cb = c[:, None, :, None]
    dsrc, ddst = [], []
    dc = torch.zeros_like(c)
    dloc = torch.zeros_like(loc)
    dlam = torch.zeros_like(lam)
    for j0 in range(0, num_tiles, _PLAIN_TILES):
        j1 = min(num_tiles, j0 + _PLAIN_TILES)
        ej = e[j0:j1]
        g_s, g_d, g_c, g_l, g_lam = _scatter_bwd(
            lam, loc, _positions(src[:, j0:j1], ej),
            _positions(dst[:, j0:j1], ej), cb,
            gre[:, j0:j1, None], gim[:, j0:j1, None], coef_grads,
        )
        dloc = dloc + torch.stack([g.sum() for g in g_l])
        dlam = dlam + g_lam.sum()
        if not coef_grads:
            continue
        for grads, out in ((g_s, dsrc), (g_d, ddst)):
            rows = torch.stack(grads, 2).flatten(2, 3)  # (N, J, 3 EM, tile)
            out.append(torch.einsum("njfr,jqr->njfq", rows, ej))
        dc = dc + g_c.sum((1, 3))
    if not coef_grads:
        return None, None, None, dloc, dlam
    return torch.cat(dsrc, 1), torch.cat(ddst, 1), dc, dloc, dlam


def _check_tensors(device, **expected):
    """Raise unless each ``name=(tensor, shape)`` is float32 of that shape
    on ``device``."""
    for name, (t, shape) in expected.items():
        if t.dtype != torch.float32 or tuple(t.shape) != shape:
            raise ValueError(f"{name} must be float32 {shape}, got "
                             f"{t.dtype} {tuple(t.shape)}")
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, src on {device}")


def _check(e, src, dst, c, loc, lam, t_out):
    if e.ndim != 3 or src.ndim != 4 or e.shape[1] != src.shape[3] or (
        e.shape[1] % 4
    ):
        raise ValueError(
            f"e must be (num_tiles, 4 NS, tile) and src (N, num_tiles, 3 EM, "
            f"4 NS), got {tuple(e.shape)} and {tuple(src.shape)}"
        )
    n, num_tiles, f3, ns4 = src.shape
    if e.shape[0] != num_tiles or f3 % 3:
        raise ValueError(f"src {tuple(src.shape)} does not fit e "
                         f"{tuple(e.shape)}")
    _check_tensors(
        src.device, e=(e, tuple(e.shape)), src=(src, tuple(src.shape)),
        dst=(dst, tuple(src.shape)), c=(c, (n, f3 // 3)), loc=(loc, (3,)),
        lam=(lam, ()),
    )
    if not 0 < t_out <= num_tiles * e.shape[2]:
        raise ValueError(f"t_out {t_out} outside the {num_tiles} tiles")


# the monomials check_monomials has passed, by (device, data pointer,
# version, shape), each held so that its memory is not handed to another
# tensor while it is a key
_MONOMIALS: dict = {}


def check_monomials(e):
    """Raise ``ValueError`` unless the monomials ``e (num_tiles, 4 NS,
    tile)`` are what the kernels take (those of
    :func:`..resample.spline_tile_plan`): in each row at most one slot's
    four terms nonzero, that slot's constant term among them, and the
    slots of a tile's rows nondecreasing. (Kernel #7's full instance gives
    NaN on other monomials, and the forward a wrong sum.)

    The check runs once for each tensor (a few passes on its device and
    one sync) and is kept by device, data pointer, version and shape, so
    that a train step repeats none of it."""
    key = (e.device, e.data_ptr(), e._version, tuple(e.shape))
    if key in _MONOMIALS:
        return
    terms = e.detach().unflatten(1, (-1, 4)) != 0  # (J, NS, 4, tile)
    used = terms.any(2)  # (J, NS, tile): the slots a row has terms in
    held = terms[:, :, 3]  # the slots whose constant term a row holds
    slot = torch.where(held.any(1), held.int().argmax(1), -1)  # (J, tile)
    rising = (slot < 0) | (slot == torch.cummax(slot, 1).values)
    fits = bool(((used.sum(1) <= 1) & (used == held).all(1) & rising).all())
    if not fits:
        raise ValueError(
            "the spline radar kernels take the monomials of "
            "spline_tile_plan: a row's terms in one slot, with its constant "
            "term, and a tile's slots nondecreasing row by row")
    _MONOMIALS[key] = e
    if len(_MONOMIALS) > 8:
        _MONOMIALS.pop(next(iter(_MONOMIALS)))



def _forward_smem(ns4, em):
    return 4 * (2 * 3 * em * ns4 + 2 * em)


def _backward_smem(ns4, tile, em, coef_grads):
    """Bytes of csrc/radar_spline.cuh's BwdLayout: the staged
    coefficients and rows, the threads' dloc/dlambda, and with
    ``coef_grads`` the runs' coefficient sums (``nruns + NS - 1`` entries
    of 24 EM), their dc sums and slot ranges."""
    nruns = max(1, _BWD_THREADS // em)
    floats = 2 * 3 * em * ns4 + 7 * tile + 4 * _BWD_THREADS
    if coef_grads:
        floats += (nruns + ns4 // 4 - 1) * 24 * em + nruns * em + 3 * nruns
    return 4 * floats


def _check_smem(nbytes):
    if nbytes > MAX_SMEM_BYTES:
        raise ValueError(
            f"the radar kernel would need {nbytes} bytes of shared memory "
            f"a block, more than the {MAX_SMEM_BYTES} a Hopper block has"
        )


def _forward(e, src, dst, c, loc, lam, t_out):
    """``(re, im)`` through kernel #6 on CUDA, the plain version on the
    CPU."""
    if src.device.type == "cpu":
        return spline_radar_reference(e, src, dst, c, loc, lam, t_out)
    check_cuda("radar", e=e, src=src, dst=dst, c=c, loc=loc, lam=lam)
    check_monomials(e)
    n, num_tiles, f3, ns4 = src.shape
    _check_smem(_forward_smem(ns4, f3 // 3))
    re = torch.empty((n, t_out), dtype=torch.float32, device=src.device)
    im = torch.empty_like(re)
    launch(
        kernel_function("radar_fwd.cu", "radar_fwd_f32", 8, 6),
        "radar_fwd", src.device,
        e.data_ptr(), src.data_ptr(), dst.data_ptr(), c.data_ptr(),
        loc.data_ptr(), lam.data_ptr(), re.data_ptr(), im.data_ptr(),
        n, num_tiles, ns4, e.shape[2], f3 // 3, t_out,
    )
    spline_radar.launches += 1
    return re, im


def spline_radar_backward(e, src, dst, c, loc, lam, gre, gim, t_out: int,
                          coef_grads: bool = True):
    """Backward of :func:`spline_radar` through kernel #7: ``(dsrc, ddst,
    dc, dloc, dlam)`` as :func:`spline_radar_backward_reference` returns
    them; with ``coef_grads=False`` only ``dloc`` and ``dlam`` (the same
    bits) and ``None`` for the others. A CPU tensor goes to that plain
    version; a CUDA tensor launches the kernel's full instance (counted in
    ``spline_radar_backward.launches``) or its loc/lambda instance
    (``spline_radar_loc_lam_backward.launches``), or raises, also on
    monomials ``e`` other than :func:`..resample.spline_tile_plan`'s
    (:func:`check_monomials`). The result is the same bit for bit from
    launch to launch."""
    _check(e, src, dst, c, loc, lam, t_out)
    out_shape = (src.shape[0], t_out)
    _check_tensors(src.device, gre=(gre, out_shape), gim=(gim, out_shape))
    if src.device.type == "cpu":
        return spline_radar_backward_reference(
            e, src, dst, c, loc, lam, gre, gim, t_out, coef_grads
        )
    check_cuda("radar", e=e, src=src, dst=dst, c=c, loc=loc, lam=lam, gre=gre,
                gim=gim)
    check_monomials(e)
    n, num_tiles, f3, ns4 = src.shape
    em, tile = f3 // 3, e.shape[2]
    _check_smem(_backward_smem(ns4, tile, em, coef_grads))
    dloc = torch.empty_like(loc)
    dlam = torch.empty_like(lam)
    ws_s = torch.empty(n * num_tiles * 4, dtype=torch.float32,
                       device=src.device)
    inputs = (e.data_ptr(), src.data_ptr(), dst.data_ptr(), c.data_ptr(),
              loc.data_ptr(), lam.data_ptr(), gre.data_ptr(), gim.data_ptr())
    shape = (n, num_tiles, ns4, tile, em, t_out)
    if not coef_grads:
        launch(
            kernel_function("radar_bwd.cu", "radar_bwd_loc_lam_f32", 11, 6),
            "radar_bwd_loc_lam", src.device, *inputs, dloc.data_ptr(),
            dlam.data_ptr(), ws_s.data_ptr(), *shape,
        )
        spline_radar_loc_lam_backward.launches += 1
        return None, None, None, dloc, dlam
    dsrc = torch.empty_like(src)
    ddst = torch.empty_like(dst)
    dc = torch.empty_like(c)
    ws_dc = torch.empty(n * num_tiles * em, dtype=torch.float32,
                        device=src.device)
    launch(
        kernel_function("radar_bwd.cu", "radar_bwd_f32", 15, 6),
        "radar_bwd", src.device, *inputs,
        dsrc.data_ptr(), ddst.data_ptr(), dc.data_ptr(), dloc.data_ptr(),
        dlam.data_ptr(), ws_dc.data_ptr(), ws_s.data_ptr(), *shape,
    )
    spline_radar_backward.launches += 1
    return dsrc, ddst, dc, dloc, dlam


def spline_radar_loc_lam_backward(e, src, dst, c, loc, lam, gre, gim,
                                  t_out: int):
    """``(dloc, dlam)``: :func:`spline_radar_backward` with
    ``coef_grads=False``, whose launches of kernel #7's loc/lambda instance
    are counted in ``spline_radar_loc_lam_backward.launches``."""
    return spline_radar_backward(e, src, dst, c, loc, lam, gre, gim, t_out,
                                 coef_grads=False)[3:]


class SplineRadar(torch.autograd.Function):
    """Kernel #6 forward, kernel #7 backward; the monomials ``e`` get no
    gradient (a constant, as in the JAX VJP). Where none of ``src``,
    ``dst`` and ``c`` needs a gradient, the backward takes kernel #7's
    loc/lambda instance and gives them none."""

    @staticmethod
    def forward(ctx, e, src, dst, c, loc, lam, t_out):
        ctx.save_for_backward(e, src, dst, c, loc, lam)
        ctx.t_out = t_out
        return _forward(e, src, dst, c, loc, lam, t_out)

    @staticmethod
    def backward(ctx, gre, gim):
        e, src, dst, c, loc, lam = ctx.saved_tensors
        grads = spline_radar_backward(
            e, src, dst, c, loc, lam, gre.contiguous(), gim.contiguous(),
            ctx.t_out, any(ctx.needs_input_grad[1:4]),
        )
        return (None, *grads, None)


def spline_radar(e, src, dst, c, loc, lam, t_out: int):
    """The radar return ``(re, im)``, each ``(N, t_out)``, through the CUDA
    kernels, differentiable in ``src``, ``dst``, ``c``, ``loc`` and
    ``lam``.

    Same arguments and result as :func:`spline_radar_reference`. ``e``
    must be the one-hot monomials of :func:`..resample.spline_tile_plan`
    (the kernels find each row's segment from them; others raise). CPU
    tensors go to the plain versions; CUDA tensors launch kernel #6
    (counted in ``spline_radar.launches``) and, in the backward, kernel #7
    (its loc/lambda instance where only ``loc`` and ``lam`` need a
    gradient), or raise.
    """
    _check(e, src, dst, c, loc, lam, t_out)
    return SplineRadar.apply(e, src, dst, c, loc, lam, t_out)


spline_radar.launches = 0
spline_radar_backward.launches = 0
spline_radar_loc_lam_backward.launches = 0


def bone_length_mean_sq_spline(bcoef, e, t_out: int):
    """``c = (mean_t |bone|)^2 (N, EM)`` over the padded time axis from the
    tiles' bone coefficients ``bcoef = ddst - dsrc (N, num_tiles, 3 EM,
    ns4)``, a chunk of tiles at a time (the padded rows of ``e`` are zero,
    so they add zero-length bones)."""
    n, num_tiles = bcoef.shape[:2]
    total = 0.0
    for j0 in range(0, num_tiles, _PLAIN_TILES):
        j1 = min(num_tiles, j0 + _PLAIN_TILES)
        bx, by, bz = _positions(bcoef[:, j0:j1], e[j0:j1])
        s = bx * bx + by * by + bz * bz
        zero = s == 0
        length = torch.where(zero, 0.0,
                             torch.sqrt(torch.where(zero, 1.0, s)))
        total = total + length.sum((1, 3))
    return (total / t_out) ** 2


@functools.lru_cache(maxsize=8)
def _plan(t_in: int, num_pad_frames: int, tile: int, sigma: float,
          device: torch.device):
    """The spline plan's ``(coefficient operator, tile segments,
    monomials (num_tiles, ns4, tile))`` as tensors on ``device``, kept per
    shape (constants: never written to; normal tensors even when first
    asked for under ``torch.inference_mode``, so that a training step can
    save them)."""
    cc, tile_seg, ev = spline_tile_plan(t_in, num_pad_frames, tile, sigma)
    with torch.inference_mode(False):
        return (
            torch.from_numpy(cc).to(device),
            torch.from_numpy(tile_seg.astype(np.int64)).to(device),
            torch.from_numpy(np.ascontiguousarray(ev.swapaxes(1, 2))).to(
                device),
        )


def gather_features(x, edges):
    """``(N, 3, T, V, M)`` -> the edges' endpoints ``src``, ``dst``, each
    ``(N, T, 3 * E * M)`` laid out as [x | y | z] blocks of E * M."""
    n, _, t = x.shape[:3]
    return tuple(a.permute(0, 2, 1, 3, 4).reshape(n, t, -1)
                 for a in gather_edges(x, edges))


def spline_inputs(x, num_pad_frames: int,
                  edges: Sequence[Tuple[int, int]] = tuple(RADAR_EDGES),
                  tile: int = TILE, sigma: float = 3.0):
    """The kernels' inputs for joints ``x (N, 3, T_in, V, M)`` smoothed and
    upsampled ``num_pad_frames``x: ``(e, src, dst, c, t_out)``, the
    monomials, the edges' endpoint coefficients per tile, the squared mean
    bone lengths ``(N, EM)`` and ``t_out = T_in * num_pad_frames``.
    Differentiable in ``x``: the coefficient contraction, the segment
    gather and the bone lengths are plain torch, as they are plain
    autodiff in JAX."""
    t_in = x.shape[2]
    t_out = t_in * int(num_pad_frames)
    cc, tile_seg, e = _plan(t_in, int(num_pad_frames), int(tile),
                            float(sigma), x.device)
    num_tiles, ns4, _ = e.shape
    src, dst = gather_features(x, edges)  # (N, T_in, 3 EM)
    n, _, f = src.shape

    def tiled(feat):
        coef = einsum_f32("qt,ntf->nqf", cc, feat)  # (N, nseg * 4, 3 EM)
        coef = coef.reshape(n, t_in - 1, 4, f)[:, tile_seg]
        return coef.reshape(n, num_tiles, ns4, f).transpose(2, 3).contiguous()

    tiled_s, tiled_d = tiled(src), tiled(dst)
    c = bone_length_mean_sq_spline(tiled_d - tiled_s, e, t_out)
    return e, tiled_s, tiled_d, c.contiguous(), t_out


def radar_return_spline(
    x,
    num_pad_frames: int,
    radar_location,
    wavelength,
    edges: Sequence[Tuple[int, int]] = tuple(RADAR_EDGES),
    tile: int = TILE,
    sigma: float = 3.0,
):
    """Radar return ``(re, im)``, each ``(N, T_in * num_pad_frames)``, of
    joints ``x (N, 3, T_in, V, M)`` smoothed and upsampled
    ``num_pad_frames``x by the spline, seen from ``radar_location (3,)`` at
    the scalar ``wavelength``: the JAX package's ``radar_return_spline``.
    Differentiable in ``x``, the location and the wavelength; the kernel
    stage is :func:`spline_radar`."""
    e, src, dst, c, t_out = spline_inputs(x, num_pad_frames, edges, tile,
                                          sigma)
    return spline_radar(e, src, dst, c, radar_location, wavelength, t_out)


# ---------------------------------------------------------------------------
# The dense route: kernels #8 and #9.

# the dense kernels' row block, split of the transposed products, largest
# number of edge-body pairs and staging (csrc/radar_dense_tile.cuh,
# radar_dense_bwd.cu), with which the wrappers size their workspaces and
# shared memory
_DENSE_ROWS = 64
_DENSE_SPLIT_ROWS = 4096
_DENSE_MAX_PAIRS = 64
_DENSE_DEPTH, _DENSE_STRIDE_A = 16, 68
# operator rows a plain version evaluates at once (the spline versions'
# chunk of tiles)
_PLAIN_ROWS = _PLAIN_TILES * TILE
# The kernels contract each row block only over its band (dense_band): the
# operator's mass left out on each side of a row is at most this share of
# the row's L1 norm, 2^-30 in all. A position is a sum of the row's terms
# rounded in f32 to ~2^-24 of that norm times the features' scale, so what
# the band drops is 64x below the rounding of the dense f32 sum. On
# resample.pad_frames_operator(300, 250) the band of a 64-row block is ~39
# of the 300 columns: the smoothing and the spline's decay make the rest
# underflow or fall below it.
_BAND_MASS = 2.0 ** -31


def dense_band(w, t_out: int):
    """The columns the dense kernels contract for the first ``t_out`` rows
    of the operator ``w (T_w, T_in)``: ``(tiles, splits)``, int32 ``(.., 2)``
    tensors on ``w``'s device holding ``[k_lo, k_hi)`` for each 64-row
    block and each 4,096-row split of the transposed products.

    A row's range drops columns from each end while their mass ``sum |w|``
    stays at most ``_BAND_MASS`` of the row's L1 norm; a block or split
    takes the union of its rows' ranges. An all-zero row gives an empty
    range, a block of them ``[T_in, T_in)``. The sums are f64 (within a
    relative ``T_in 2^-53`` of exact for these nonnegative terms), and the
    limit is cut by that much, so rounding never drops more mass."""
    t_in = w.shape[1]
    prefix = w[:t_out].abs().cumsum(1, dtype=torch.float64)  # sum_{j <= k}
    l1 = prefix[:, -1:]
    limit = l1 * (_BAND_MASS - (2 * t_in + 2) * 2.0 ** -53)
    # the rows' prefix sums are sorted, so a binary search a row finds the
    # columns k < k_lo (prefix[k] <= limit) and k >= k_hi (l1 - prefix[k -
    # 1] <= limit; k = 0 only for an all-zero row)
    k_lo = torch.searchsorted(prefix, limit, right=True)[:, 0]
    k_hi = (1 + torch.searchsorted(prefix, l1 - limit)[:, 0]
            - (l1[:, 0] == 0).long())

    def union(lo, hi, rows):
        pad = -len(lo) % rows  # past t_out: an empty range
        lo = torch.nn.functional.pad(lo, (0, pad), value=t_in)
        hi = torch.nn.functional.pad(hi, (0, pad), value=0)
        return lo.view(-1, rows).amin(1), hi.view(-1, rows).amax(1)

    tile_lo, tile_hi = union(k_lo, k_hi, _DENSE_ROWS)
    per_split = _DENSE_SPLIT_ROWS // _DENSE_ROWS
    split_lo, split_hi = union(tile_lo, tile_hi, per_split)
    return tuple(
        torch.stack([lo, torch.maximum(lo, hi)], 1).int().contiguous()
        for lo, hi in ((tile_lo, tile_hi), (split_lo, split_hi))
    )


def bone_length_sum(x_raw, rows,
                    edges: Sequence[Tuple[int, int]] = tuple(RADAR_EDGES),
                    tile: int = TILE):
    """``sum_t |bone| (N, E * M)`` over the operator ``rows (R, T_in)`` (the
    whole ``(T_out, T_in)`` resampling operator, or one rank's block of its
    rows; all-zero rows add nothing) of the edges' bones in joints ``x_raw
    (N, 3, T_in, V, M)``, ``tile`` rows at a time, so that the upsampled
    bones never exist in full. The norm's gradient at zero is zero
    (all-zero bodies are routine in NTU clips)."""
    src, dst = gather_edges(x_raw, edges)
    bone = dst - src  # (N, 3, T_in, E, M)
    total = 0.0
    for w_tile in rows.split(tile):
        b = torch.einsum("ot,nctem->ncoem", w_tile, bone)
        total = total + safe_norm(b, 1).sum(1)
    return total.flatten(1)


def bone_length_mean_sq(x_raw, pad_operator,
                        edges: Sequence[Tuple[int, int]] = tuple(RADAR_EDGES),
                        tile: int = TILE):
    """``c = (mean_t |bone|)^2 (N, E * M)`` of the edges' bones in joints
    ``x_raw (N, 3, T_in, V, M)`` upsampled by ``pad_operator (T_out,
    T_in)``, the mean over the ``T_out`` rows: the JAX package's
    ``_bone_length_mean_sq``, as :func:`bone_length_sum` over every row
    and its finish ``(sum / T_out)^2``."""
    total = bone_length_sum(x_raw, pad_operator, edges, tile)
    return (total / pad_operator.shape[0]) ** 2


def _dense_positions(w_rows, feat):
    """The rows ``w_rows (R, T_in)`` of the operator at the features
    ``feat (N, T_in, 3 EM)``: the x, y, z coordinates, each ``(N, R,
    EM)``."""
    return torch.matmul(w_rows, feat).unflatten(2, (3, -1)).unbind(2)


def dense_radar_reference(w, src, dst, c, loc, lam, t_out: int):
    """Plain PyTorch kernel #8: ``(re, im)``, each ``(N, t_out)``, of the
    features ``src``/``dst (N, T_in, 3 EM)`` upsampled by the first
    ``t_out`` rows of ``w (T_w, T_in)``, with ``c (N, EM)``, ``loc (3,)``
    and the scalar ``lam``. The JAX kernel's formulas, a chunk of rows at a
    time; the rows past ``t_out`` are never computed."""
    cb = c[:, None, :]
    re, im = [], []
    for r0 in range(0, t_out, _PLAIN_ROWS):
        rows = w[r0:min(t_out, r0 + _PLAIN_ROWS)]
        amp, phase = _scatter_fwd(lam, loc, _dense_positions(rows, src),
                                  _dense_positions(rows, dst), cb)
        re.append((amp * torch.cos(phase)).sum(2))
        im.append((amp * torch.sin(phase)).sum(2))
    return torch.cat(re, 1), torch.cat(im, 1)


def dense_radar_backward_reference(w, src, dst, c, loc, lam, gre, gim,
                                   t_out: int):
    """Plain PyTorch kernel #9: the cotangents ``(dsrc, ddst, dc, dloc,
    dlam)`` of :func:`dense_radar_reference` from ``(gre, gim) (N,
    t_out)``: the JAX kernel's ``_scatter_bwd_core`` per row and pair, and
    the per-row cotangents contracted with the operator's rows. (Autograd
    through the plain forward gives NaN where ``c = 0``.)"""
    cb = c[:, None, :]
    dsrc, ddst = torch.zeros_like(src), torch.zeros_like(dst)
    dc = torch.zeros_like(c)
    dloc = torch.zeros_like(loc)
    dlam = torch.zeros_like(lam)
    for r0 in range(0, t_out, _PLAIN_ROWS):
        r1 = min(t_out, r0 + _PLAIN_ROWS)
        rows = w[r0:r1]
        g_s, g_d, g_c, g_l, g_lam = _scatter_bwd(
            lam, loc, _dense_positions(rows, src),
            _dense_positions(rows, dst), cb, gre[:, r0:r1, None],
            gim[:, r0:r1, None],
        )
        dsrc = dsrc + torch.matmul(rows.T, torch.cat(g_s, 2))
        ddst = ddst + torch.matmul(rows.T, torch.cat(g_d, 2))
        dc = dc + g_c.sum(1)
        dloc = dloc + torch.stack([g.sum() for g in g_l])
        dlam = dlam + g_lam.sum()
    return dsrc, ddst, dc, dloc, dlam


def _check_dense(w, src, dst, c, loc, lam, t_out):
    if w.ndim != 2 or src.ndim != 3 or w.shape[1] != src.shape[1] or (
        src.shape[2] % 3
    ):
        raise ValueError(
            f"w must be (T, T_in) and src (N, T_in, 3 EM), got "
            f"{tuple(w.shape)} and {tuple(src.shape)}"
        )
    n, _, f3 = src.shape
    _check_tensors(
        src.device, w=(w, tuple(w.shape)), src=(src, tuple(src.shape)),
        dst=(dst, tuple(src.shape)), c=(c, (n, f3 // 3)), loc=(loc, (3,)),
        lam=(lam, ()),
    )
    if not 0 < t_out <= w.shape[0]:
        raise ValueError(f"t_out {t_out} outside the operator's "
                         f"{w.shape[0]} rows")


def _padded_pairs(em):
    """EM rounded up to the kernels' pair groups of 4."""
    return -(-em // 4) * 4


def _dense_launch_checks(name, em, **tensors):
    """What the dense kernels take beyond :func:`_check_dense`: contiguous
    CUDA tensors, at most ``_DENSE_MAX_PAIRS`` pairs, a block's shared
    memory."""
    check_cuda(name, **tensors)
    if em > _DENSE_MAX_PAIRS:
        raise ValueError(f"the dense radar kernels take at most "
                         f"{_DENSE_MAX_PAIRS} edge-body pairs, got {em}")
    emp = _padded_pairs(em)
    threads = 4 * emp
    staged = 2 * _DENSE_DEPTH * (_DENSE_STRIDE_A + 6 * emp)  # two steps
    # after the contraction the backward keeps the positions (6, 64, emp +
    # 1) and its sums there
    positions = 6 * _DENSE_ROWS * (emp + 1) + 4 * emp + 4 * threads
    _check_smem(4 * max(staged, positions))


def _band_for(w, src, t_out):
    """:func:`dense_band` of ``w`` for the kernels, ``None`` where the
    tensors lie on the CPU (the plain versions contract every column)."""
    return None if src.device.type == "cpu" else dense_band(w, t_out)


def _dense_forward(w, band, src, dst, c, loc, lam, t_out):
    """``(re, im)`` through kernel #8 over ``band`` (:func:`dense_band`) on
    CUDA, the plain version on the CPU."""
    if src.device.type == "cpu":
        return dense_radar_reference(w, src, dst, c, loc, lam, t_out)
    n, t_in, f3 = src.shape
    _dense_launch_checks("dense radar", f3 // 3, w=w, band=band[0], src=src,
                         dst=dst, c=c, loc=loc, lam=lam)
    re = torch.empty((n, t_out), dtype=torch.float32, device=src.device)
    im = torch.empty_like(re)
    launch(
        kernel_function("radar_dense_fwd.cu", "radar_dense_fwd_f32", 9, 4),
        "radar_dense_fwd", src.device,
        w.data_ptr(), band[0].data_ptr(), src.data_ptr(), dst.data_ptr(),
        c.data_ptr(), loc.data_ptr(), lam.data_ptr(), re.data_ptr(),
        im.data_ptr(), n, t_in, f3 // 3, t_out,
    )
    dense_radar.launches += 1
    return re, im


def dense_radar_backward(w, src, dst, c, loc, lam, gre, gim, t_out: int):
    """Backward of :func:`dense_radar` through kernel #9: ``(dsrc, ddst,
    dc, dloc, dlam)`` as :func:`dense_radar_backward_reference` returns
    them. A CPU tensor goes to that plain version; a CUDA tensor launches
    the kernel over the operator's band (:func:`dense_band`, computed here;
    counted in ``dense_radar_backward.launches``) or raises. The result is
    the same bit for bit from launch to launch. At the trainer's shape the
    kernel takes a 1.5 GB workspace: the rows' cotangents ``(N, t_out, 6
    EM)`` and the split products ``(19, N, T_in, 6 EM)``."""
    _check_dense(w, src, dst, c, loc, lam, t_out)
    out_shape = (src.shape[0], t_out)
    _check_tensors(src.device, gre=(gre, out_shape), gim=(gim, out_shape))
    return _dense_backward(w, _band_for(w, src, t_out), src, dst, c, loc,
                           lam, gre, gim, t_out)


def _dense_backward(w, band, src, dst, c, loc, lam, gre, gim, t_out):
    """:func:`dense_radar_backward` past its checks, over ``band``."""
    if src.device.type == "cpu":
        return dense_radar_backward_reference(w, src, dst, c, loc, lam, gre,
                                              gim, t_out)
    n, t_in, f3 = src.shape
    em = f3 // 3
    _dense_launch_checks("dense radar", em, w=w, band=band[0],
                         split_band=band[1], src=src, dst=dst, c=c, loc=loc,
                         lam=lam, gre=gre, gim=gim)
    cols = 6 * _padded_pairs(em)
    tiles = -(-t_out // _DENSE_ROWS)
    splits = -(-t_out // _DENSE_SPLIT_ROWS)
    dsrc, ddst = torch.empty_like(src), torch.empty_like(dst)
    dc = torch.empty_like(c)
    dloc, dlam = torch.empty_like(loc), torch.empty_like(lam)

    def workspace(*shape):
        return torch.empty(shape, dtype=torch.float32, device=src.device)

    g = workspace(n, t_out, cols)
    ws_part = workspace(splits, n, t_in, cols)
    ws_dc = workspace(n, tiles, em)
    ws_s = workspace(n, tiles, 4)
    launch(
        kernel_function("radar_dense_bwd.cu", "radar_dense_bwd_f32", 19, 4),
        "radar_dense_bwd", src.device,
        w.data_ptr(), band[0].data_ptr(), band[1].data_ptr(),
        src.data_ptr(), dst.data_ptr(), c.data_ptr(),
        loc.data_ptr(), lam.data_ptr(), gre.data_ptr(), gim.data_ptr(),
        dsrc.data_ptr(), ddst.data_ptr(), dc.data_ptr(), dloc.data_ptr(),
        dlam.data_ptr(), g.data_ptr(), ws_part.data_ptr(), ws_dc.data_ptr(),
        ws_s.data_ptr(), n, t_in, em, t_out,
    )
    dense_radar_backward.launches += 1
    return dsrc, ddst, dc, dloc, dlam


class DenseRadar(torch.autograd.Function):
    """Kernel #8 forward, kernel #9 backward, both over the operator's
    band, found once a call and kept for the backward; the operator ``w``
    gets no gradient (a constant, as in the JAX VJP)."""

    @staticmethod
    def forward(ctx, w, src, dst, c, loc, lam, t_out):
        ctx.band = _band_for(w, src, t_out)
        ctx.save_for_backward(w, src, dst, c, loc, lam)
        ctx.t_out = t_out
        return _dense_forward(w, ctx.band, src, dst, c, loc, lam, t_out)

    @staticmethod
    def backward(ctx, gre, gim):
        w, src, dst, c, loc, lam = ctx.saved_tensors
        grads = _dense_backward(w, ctx.band, src, dst, c, loc, lam,
                                gre.contiguous(), gim.contiguous(), ctx.t_out)
        return (None, *grads, None)


def dense_radar(w, src, dst, c, loc, lam, t_out: int):
    """The radar return ``(re, im)``, each ``(N, t_out)``, through the
    dense CUDA kernels, differentiable in ``src``, ``dst``, ``c``, ``loc``
    and ``lam``.

    Same arguments and result as :func:`dense_radar_reference`. CPU
    tensors go to the plain versions; CUDA tensors launch kernel #8
    (counted in ``dense_radar.launches``) and, in the backward, kernel #9,
    or raise. The kernels contract each block of rows over its band of
    the operator (:func:`dense_band`): what they leave out is below f32
    rounding of the positions."""
    _check_dense(w, src, dst, c, loc, lam, t_out)
    return DenseRadar.apply(w, src, dst, c, loc, lam, t_out)


dense_radar.launches = 0
dense_radar_backward.launches = 0


def radar_return_rows(x_raw, rows, c, radar_location, wavelength,
                      edges: Sequence[Tuple[int, int]] = tuple(RADAR_EDGES),
                      tile: int = TILE):
    """The kernel stage of :func:`radar_return_fused` on the operator's
    rows ``rows (R, T_in)`` (all of them, or one rank's block) with the
    squared mean bone lengths ``c (N, E * M)``: ``(re, im)``, each ``(N,
    R)``. The rows are padded to a multiple of ``tile`` (which sets only
    that padding) and :func:`dense_radar` computes the first ``R``."""
    t = rows.shape[0]
    src, dst = gather_features(x_raw, edges)
    rows = torch.nn.functional.pad(rows.detach(), (0, 0, 0, -t % tile))
    return dense_radar(rows, src.contiguous(), dst.contiguous(),
                       c.contiguous(), radar_location, wavelength, t)


def radar_return_fused(
    x_raw,
    pad_operator,
    radar_location,
    wavelength,
    edges: Sequence[Tuple[int, int]] = tuple(RADAR_EDGES),
    tile: int = TILE,
):
    """Radar return ``(re, im)``, each ``(N, T_out)``, of joints ``x_raw
    (N, 3, T_in, V, M)`` upsampled by the dense ``pad_operator (T_out,
    T_in)`` (:func:`..resample.pad_frames_operator`), seen from
    ``radar_location (3,)`` at the scalar ``wavelength``: the JAX package's
    ``radar_return_fused``, with its signature and result.

    The kernel stage is :func:`radar_return_rows`. Differentiable in
    ``x_raw``, the location and the wavelength, through the gather and the
    bone lengths :func:`bone_length_mean_sq` (plain torch, as they are
    plain autodiff in JAX); the operator is a constant."""
    device = x_raw.device
    w = torch.as_tensor(pad_operator, dtype=torch.float32, device=device)
    loc = torch.as_tensor(radar_location, dtype=torch.float32, device=device)
    lam = torch.as_tensor(wavelength, dtype=torch.float32, device=device)
    return radar_return_rows(x_raw, w, bone_length_mean_sq(x_raw, w, edges,
                                                           tile),
                             loc, lam, edges, tile)
