"""The port's radar return (the spline path behind kernels #6/#7 and the
plain routes) and its host operators against the JAX package, on seeded
skeleton-like inputs. The JAX Pallas kernels run in interpret mode, as the
JAX package's own tests run them on the CPU; the port's wrappers run the
kernels' plain versions, because the tensors lie on the CPU."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skeleton_action_recognition_tpu.graphs import ntu_rgb_d as jax_graph
from skeleton_action_recognition_tpu.ops import resample as jax_resample
from skeleton_action_recognition_tpu.ops import virtual_radar as jax_vr
from skeleton_action_recognition_tpu.ops.pallas import radar as jax_radar
from skeleton_action_recognition_tpu_torch.graphs.ntu_rgb_d import (
    RADAR_EDGES,
)
from skeleton_action_recognition_tpu_torch.ops import radar, resample
from skeleton_action_recognition_tpu_torch.ops import virtual_radar
from test_torch_spectrogram import skeletons

T_IN, UP = 30, 20  # 600 radar samples
LOC = np.array([0.1, -0.2, 0.3], np.float32)
# lambda = 5e-4 (the model's): the phase 4 pi d / lambda is ~1e4 rad, and
# f32 rounding of the interpolated positions, taken in other orders, moves
# it by ~1e-3 rad. Forward to 2e-3 and gradients to 1e-2 of their scale,
# the JAX package's own Pallas-vs-XLA tolerances (tests/test_pallas.py).
# lambda = 10 damps the phase (radar.py's note): both sides then agree to
# f32 rounding, 1e-4 of the scale.
TOL = {5e-4: (2e-3, 1e-2), 10.0: (1e-4, 1e-4)}


def test_radar_edges_are_the_jax_list():
    assert RADAR_EDGES == list(jax_graph.RADAR_EDGES)
    assert len(RADAR_EDGES) == 24


@pytest.mark.parametrize("name,args", [
    ("gaussian_smooth_matrix", (30, 3.0)),
    ("cubic_interp_matrix", (30, 600)),
    ("pad_frames_operator", (30, 20)),
    ("spline_tile_plan", (300, 250, 512)),
    ("spline_tile_plan", (30, 20, 256)),
])
def test_host_operators_equal_jax(name, args):
    """The copied numpy/scipy builders give the JAX ones bit for bit: the
    production plan too (147 tiles of 512 rows, 4 segments a tile)."""
    got = getattr(resample, name)(*args)
    want = getattr(jax_resample, name)(*args)
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    if args == (300, 250, 512):
        assert got[2].shape == (147, 512, 16)


def test_spline_coefficient_operator_equals_jax():
    cc, xs = resample.spline_coefficient_operator(30)
    want_cc, want_xs = jax_resample.spline_coefficient_operator(30)
    np.testing.assert_array_equal(cc, want_cc)
    np.testing.assert_array_equal(xs, want_xs)


@pytest.mark.parametrize("axis", ["joints", "time"])
def test_pad_frames_equals_jax(axis):
    x = np.random.default_rng(4).normal(size=(30, 25, 3)).astype(np.float32)
    got = resample.pad_frames(torch.from_numpy(x), 4, smooth_axis=axis)
    want = jax_resample.pad_frames(jnp.asarray(x), 4, smooth_axis=axis)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)


def _jax_loss(fn):
    def loss(x, loc, lam):
        re, im = fn(x, loc, lam)
        return jnp.sum(re * re + im * im), (re, im)
    return jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True)


def _port(fn, x, loc, lam):
    tx = torch.tensor(x, requires_grad=True)
    tl = torch.tensor(loc, requires_grad=True)
    tlam = torch.tensor(np.float32(lam), requires_grad=True)
    re, im = fn(tx, tl, tlam)
    (re * re + im * im).sum().backward()
    return (re.detach().numpy(), im.detach().numpy()), (
        tx.grad.numpy(), tl.grad.numpy(), tlam.grad.numpy())


def _compare(port, want, lam):
    (re, im), grads = port
    (_, (w_re, w_im)), w_grads = want
    fwd_tol, grad_tol = TOL[lam]
    scale = np.abs(np.asarray(w_re)).max()
    np.testing.assert_allclose(re, np.asarray(w_re), atol=fwd_tol * scale)
    np.testing.assert_allclose(im, np.asarray(w_im), atol=fwd_tol * scale)
    for name, g, w in zip(("x", "loc", "lambda"), grads, w_grads):
        w = np.asarray(w)
        assert np.isfinite(g).all(), name
        np.testing.assert_allclose(
            g, w, atol=grad_tol * (np.abs(w).max() or 1.0), err_msg=name)


@pytest.mark.parametrize("lam", [5e-4, 10.0])
@pytest.mark.parametrize("tile", [128, 256])
def test_spline_radar_matches_jax_kernel(tile, lam):
    """Kernel #6's and #7's plain versions (with the coefficient einsum,
    gather and bone lengths around them) against the JAX Pallas spline
    path: the return and d/dx, d/dloc, d/dlambda of ``sum |return|^2``,
    with an all-zero second body in one clip. tile 256 leaves 168 pad
    rows."""
    x = skeletons(t=T_IN)
    want = _jax_loss(lambda x, loc, lam: jax_radar.radar_return_spline(
        x, UP, loc, lam, tile=tile))(jnp.asarray(x), jnp.asarray(LOC),
                                     jnp.asarray(np.float32(lam)))
    got = _port(lambda x, loc, lam: radar.radar_return_spline(
        x, UP, loc, lam, tile=tile), x, LOC, lam)
    _compare(got, want, lam)


@pytest.mark.parametrize("lam", [5e-4, 10.0])
def test_radar_return_upsampled_matches_jax(lam):
    """The ``use_pallas=False`` route: the dense operator, autograd."""
    x = skeletons(t=T_IN)
    w = resample.pad_frames_operator(T_IN, UP)
    want = _jax_loss(lambda x, loc, lam: jax_vr.radar_return_upsampled(
        x, jnp.asarray(w), loc, lam))(jnp.asarray(x), jnp.asarray(LOC),
                                      jnp.asarray(np.float32(lam)))
    got = _port(lambda x, loc, lam: virtual_radar.radar_return_upsampled(
        x, torch.from_numpy(w), loc, lam), x, LOC, lam)
    _compare(got, want, lam)


@pytest.mark.parametrize("lam", [5e-4, 10.0])
def test_radar_return_matches_jax(lam):
    """The ``num_pad_frames <= 1`` route on raw frames."""
    x = skeletons(t=200)
    want = _jax_loss(jax_vr.radar_return)(
        jnp.asarray(x), jnp.asarray(LOC), jnp.asarray(np.float32(lam)))
    got = _port(virtual_radar.radar_return, x, LOC, lam)
    _compare(got, want, lam)


def test_gradients_finite_with_empty_bodies():
    """Every second body all zero, the first of one clip too: zero-length
    bones (c = 0) and zero norms take the backward's guards, and no NaN
    reaches x, loc or lambda."""
    x = skeletons(t=T_IN)
    x[..., 1] = 0.0
    x[0, ..., 0] = 0.0
    _, grads = _port(lambda x, loc, lam: radar.radar_return_spline(
        x, UP, loc, lam, tile=128), x, LOC, 5e-4)
    for g in grads:
        assert np.isfinite(g).all()


def test_plain_backward_equals_autograd_where_c_is_positive():
    """Kernel #7's plain version against autograd through kernel #6's
    plain version, at the damped lambda: agreement to f32 rounding. Where
    autograd has no NaN, that is: no empty body, and a tile of 200 rows
    that leaves no pad rows (their positions are all zero)."""
    x = torch.from_numpy(skeletons(t=T_IN, empty_second_body=False))
    e, ts, td, c, _ = radar.spline_inputs(x, UP, tile=200)
    ts, td, c = (a.detach().requires_grad_() for a in (ts, td, c))
    loc = torch.tensor(LOC, requires_grad=True)
    lam = torch.tensor(10.0, requires_grad=True)
    re, im = radar.spline_radar_reference(e, ts, td, c, loc, lam, T_IN * UP)
    g = torch.randn(2, 2, T_IN * UP, generator=torch.Generator().manual_seed(0))
    (re * g[0] + im * g[1]).sum().backward()
    got = radar.spline_radar_backward_reference(
        e, ts.detach(), td.detach(), c.detach(), loc.detach(), lam.detach(),
        g[0], g[1], T_IN * UP)
    for name, p, q in zip(("dsrc", "ddst", "dc", "dloc", "dlam"), got,
                          (ts.grad, td.grad, c.grad, loc.grad, lam.grad)):
        torch.testing.assert_close(p, q, rtol=1e-4,
                                   atol=1e-5 * q.abs().max().item(),
                                   msg=name)


def test_cpu_wrappers_take_the_plain_versions_and_count_nothing():
    """On CPU tensors the autograd Function runs the plain versions; the
    launch counters count only kernel launches."""
    fwd, bwd = radar.spline_radar.launches, radar.spline_radar_backward.launches
    x = torch.from_numpy(skeletons(t=T_IN)).requires_grad_()
    re, im = radar.radar_return_spline(x, UP, torch.zeros(3),
                                       torch.tensor(5e-4), tile=128)
    (re.sum() + im.sum()).backward()
    assert x.grad is not None
    assert radar.spline_radar.launches == fwd
    assert radar.spline_radar_backward.launches == bwd


def test_wrapper_checks_shapes_and_types():
    e = torch.zeros(2, 8, 128)
    src = torch.zeros(1, 2, 144, 8)
    ok = dict(e=e, src=src, dst=src, c=torch.zeros(1, 48),
              loc=torch.zeros(3), lam=torch.tensor(1.0), t_out=200)
    radar.spline_radar(**ok)
    for key, bad in (("c", torch.zeros(1, 47)), ("lam", torch.zeros(1)),
                     ("loc", torch.zeros(3, dtype=torch.float64)),
                     ("t_out", 300)):
        with pytest.raises(ValueError):
            radar.spline_radar(**{**ok, key: bad})
