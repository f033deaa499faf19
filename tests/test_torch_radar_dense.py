"""The port's dense-operator radar return (the op behind kernels #8/#9) and
``virtual_radar_spectrogram`` against the JAX package, on seeded
skeleton-like inputs. The JAX Pallas kernels run in interpret mode, as the
JAX package's own tests run them on the CPU; the port's wrappers run the
kernels' plain versions, because the tensors lie on the CPU."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skeleton_action_recognition_tpu.graphs import ntu_rgb_d as jax_graph
from skeleton_action_recognition_tpu.ops import virtual_radar as jax_vr
from skeleton_action_recognition_tpu.ops.pallas import radar as jax_radar
from skeleton_action_recognition_tpu_torch.ops import radar, resample
from skeleton_action_recognition_tpu_torch.ops import virtual_radar
from test_torch_radar import LOC, T_IN, TOL, UP, _compare, _jax_loss, _port
from test_torch_spectrogram import skeletons

T_OUT = T_IN * UP  # 600


@pytest.fixture(scope="module")
def operator():
    return resample.pad_frames_operator(T_IN, UP)  # (600, 30)


@pytest.mark.parametrize("lam", [5e-4, 10.0])
@pytest.mark.parametrize("tile", [128, 256])
def test_radar_return_fused_matches_jax_kernel(operator, tile, lam):
    """Kernels #8's and #9's plain versions (with the gather and bone
    lengths around them) against the JAX Pallas op: the return and d/dx,
    d/dloc, d/dlambda of ``sum |return|^2``, with an all-zero second body
    in one clip. tile 256 leaves 168 pad rows that the JAX kernel computes
    and cuts and the port never computes."""
    x = skeletons(t=T_IN)
    want = _jax_loss(lambda x, loc, lam: jax_radar.radar_return_fused(
        x, jnp.asarray(operator), loc, lam, tile=tile))(
        jnp.asarray(x), jnp.asarray(LOC), jnp.asarray(np.float32(lam)))
    w = torch.from_numpy(operator)
    got = _port(lambda x, loc, lam: radar.radar_return_fused(
        x, w, loc, lam, tile=tile), x, LOC, lam)
    _compare(got, want, lam)


@pytest.mark.parametrize("tile", [128, 256, 512])
def test_bone_length_mean_sq_matches_jax(operator, tile):
    """The same tiles of rows summed in the same order: within 1e-6 of the
    largest, as ``(N, E * M)`` (the features' pair order)."""
    x = skeletons(t=T_IN)
    edges = jax_graph.RADAR_EDGES
    src_idx = np.asarray([e[0] for e in edges])
    dst_idx = np.asarray([e[1] for e in edges])
    want = np.asarray(jax_radar._bone_length_mean_sq(
        jnp.asarray(x), jnp.asarray(operator), src_idx, dst_idx, tile))
    got = radar.bone_length_mean_sq(torch.from_numpy(x),
                                    torch.from_numpy(operator), tile=tile)
    assert got.shape == (2, 48)
    want = want.reshape(2, 48)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-6 * np.abs(want).max())
    assert (got[-1, 1::2] == 0).all()  # the empty body's bones


def _dense_inputs(empty_second_body=True, lam=10.0):
    x = torch.from_numpy(skeletons(t=T_IN,
                                   empty_second_body=empty_second_body))
    w = torch.from_numpy(resample.pad_frames_operator(T_IN, UP))
    src, dst = radar.gather_features(x, radar.RADAR_EDGES)
    c = radar.bone_length_mean_sq(x, w)
    return w, src, dst, c, torch.tensor(LOC), torch.tensor(lam)


def test_plain_backward_equals_autograd_where_c_is_positive():
    """Kernel #9's plain version against autograd through kernel #8's
    plain version, at the damped lambda: agreement to f32 rounding, where
    autograd has no NaN (no empty body)."""
    w, src, dst, c, loc, lam = _dense_inputs(empty_second_body=False)
    src, dst, c, loc, lam = (a.requires_grad_() for a in (src, dst, c, loc,
                                                          lam))
    re, im = radar.dense_radar_reference(w, src, dst, c, loc, lam, T_OUT)
    g = torch.randn(2, 2, T_OUT, generator=torch.Generator().manual_seed(0))
    (re * g[0] + im * g[1]).sum().backward()
    got = radar.dense_radar_backward_reference(
        w, src.detach(), dst.detach(), c.detach(), loc.detach(),
        lam.detach(), g[0], g[1], T_OUT)
    for name, p, q in zip(("dsrc", "ddst", "dc", "dloc", "dlam"), got,
                          (src.grad, dst.grad, c.grad, loc.grad, lam.grad)):
        torch.testing.assert_close(p, q, rtol=1e-4,
                                   atol=1e-5 * q.abs().max().item(),
                                   msg=name)


@pytest.mark.parametrize("loc", [LOC, np.zeros(3, np.float32)])
def test_gradients_finite_with_empty_bodies(operator, loc):
    """Every second body all zero, the first of one clip too: zero-length
    bones (c = 0) and zero norms take the backward's guards, and no NaN
    reaches x, loc or lambda; at loc = 0 the empty body's distance is 0
    too. tile 256 does not divide T_out = 600."""
    x = skeletons(t=T_IN)
    x[..., 1] = 0.0
    x[0, ..., 0] = 0.0
    w = torch.from_numpy(operator)
    _, grads = _port(lambda x, l, lam: radar.radar_return_fused(
        x, w, l, lam, tile=256), x, loc, 5e-4)
    for g in grads:
        assert np.isfinite(g).all()


def test_cpu_wrappers_take_the_plain_versions_and_count_nothing(operator):
    """On CPU tensors the autograd Function runs the plain versions; the
    launch counters count only kernel launches."""
    fwd = radar.dense_radar.launches
    bwd = radar.dense_radar_backward.launches
    x = torch.from_numpy(skeletons(t=T_IN)).requires_grad_()
    re, im = radar.radar_return_fused(x, torch.from_numpy(operator),
                                      torch.zeros(3), torch.tensor(5e-4))
    (re.sum() + im.sum()).backward()
    assert re.shape == im.shape == (2, T_OUT)
    assert x.grad is not None
    assert radar.dense_radar.launches == fwd
    assert radar.dense_radar_backward.launches == bwd


def test_wrappers_accept_the_kernel_inputs():
    w, src, dst, c, loc, lam = _dense_inputs()
    re, im = radar.dense_radar(w, src, dst, c, loc, lam, T_OUT)
    g = torch.ones(2, T_OUT)
    grads = radar.dense_radar_backward(w, src, dst, c, loc, lam, g, g, T_OUT)
    assert re.shape == (2, T_OUT)
    assert [tuple(t.shape) for t in grads] == [
        (2, T_IN, 144), (2, T_IN, 144), (2, 48), (3,), ()]


@pytest.mark.parametrize("key,bad", [
    ("w", torch.zeros(600, 31)),
    ("src", torch.zeros(2, T_IN, 143)),
    ("dst", torch.zeros(2, T_IN, 141)),
    ("c", torch.zeros(2, 47)),
    ("loc", torch.zeros(3, dtype=torch.float64)),
    ("lam", torch.zeros(1)),
    ("lam", torch.tensor(1.0, device="meta")),
    ("t_out", 601),
    ("t_out", 0),
])
def test_wrappers_reject_wrong_inputs(key, bad):
    """Shapes, dtypes, devices and the row count, in the forward and the
    backward wrapper."""
    w, src, dst, c, loc, lam = _dense_inputs()
    ok = dict(w=w, src=src, dst=dst, c=c, loc=loc, lam=lam, t_out=T_OUT)
    g = torch.zeros(2, T_OUT)
    with pytest.raises(ValueError):
        radar.dense_radar(**{**ok, key: bad})
    with pytest.raises(ValueError):
        radar.dense_radar_backward(**{**ok, key: bad}, gre=g, gim=g)


@pytest.mark.parametrize("bad", [torch.zeros(2, T_OUT - 1),
                                 torch.zeros(2, T_OUT, dtype=torch.float64)])
def test_backward_wrapper_rejects_wrong_cotangents(bad):
    w, src, dst, c, loc, lam = _dense_inputs()
    with pytest.raises(ValueError):
        radar.dense_radar_backward(w, src, dst, c, loc, lam, bad,
                                   torch.zeros(2, T_OUT), T_OUT)


@pytest.mark.parametrize("lam", [5e-4, 10.0])
def test_dense_route_matches_spline_route(operator, lam):
    """The spline coefficients are an exact factorization of the dense
    operator (``resample.spline_coefficient_operator``), so the two routes
    differ by f32 rounding: 30-term sums against 4-term cubics, which the
    phase factor amplifies at lambda = 5e-4 (``TOL``)."""
    x = skeletons(t=T_IN)
    w = torch.from_numpy(operator)
    dense = _port(lambda x, loc, lam: radar.radar_return_fused(
        x, w, loc, lam, tile=128), x, LOC, lam)
    spline = _port(lambda x, loc, lam: radar.radar_return_spline(
        x, UP, loc, lam, tile=128), x, LOC, lam)
    (re, im), grads = spline
    _compare(dense, ((None, (re, im)), grads), lam)


@pytest.mark.parametrize("lam", [1e-3, 10.0])
def test_virtual_radar_spectrogram_matches_jax(lam):
    """Raw frames -> radar return -> STFT -> log-magnitude against the JAX
    function. Compared as magnitudes ``exp(out) = |S| + eps``, to 1e-3 of
    their largest, as the spectrogram model's routes are
    (tests/test_torch_spectrogram.py): the log of a bin near zero is
    ill-conditioned."""
    x = skeletons(t=200)
    want = np.asarray(jax_vr.virtual_radar_spectrogram(
        jnp.asarray(x), jnp.asarray(LOC), jnp.asarray(np.float32(lam))))
    got = virtual_radar.virtual_radar_spectrogram(
        torch.from_numpy(x), torch.tensor(LOC), torch.tensor(lam))
    assert got.shape == want.shape == (2, 256, 200 // 16 + 1)
    got, want = np.exp(got.numpy()), np.exp(want)
    np.testing.assert_allclose(got, want, atol=1e-3 * want.max())
