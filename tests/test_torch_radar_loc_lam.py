"""Kernel #7's loc/lambda path: where only the radar's location and
wavelength need a gradient (the spectrogram trainer's case: its joints are
data), ``SplineRadar`` asks ``spline_radar_backward`` for ``dloc`` and
``dlambda`` alone. On the CPU that is the plain version with
``coef_grads=False``; it is held here against the JAX package's
``jax.grad`` of ``radar_return_spline`` (Pallas in interpret mode) and
against the full plain version's ``dloc``/``dlambda``, bit for bit."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skeleton_action_recognition_tpu.ops.pallas import radar as jax_radar
from skeleton_action_recognition_tpu_torch import tracing
from skeleton_action_recognition_tpu_torch.ops import radar
from test_torch_radar import LOC, T_IN, TOL, UP, _jax_loss
from test_torch_spectrogram import skeletons


def _recording_backward(monkeypatch):
    """Record the ``coef_grads`` of every ``spline_radar_backward`` call
    the autograd Function makes."""
    calls, real = [], radar.spline_radar_backward

    def wrapped(*args):
        calls.append(args[9])
        return real(*args)

    monkeypatch.setattr(radar, "spline_radar_backward", wrapped)
    return calls


@pytest.mark.parametrize("lam", [5e-4, 10.0])
@pytest.mark.parametrize("tile", [128, 256])
def test_loc_lambda_gradients_match_jax(monkeypatch, tile, lam):
    """``x`` data, ``loc`` and ``lambda`` trained: the backward asks for
    their cotangents alone, which equal the JAX Pallas spline path's
    d/dloc and d/dlambda of ``sum |return|^2`` (the tolerances of
    ``test_spline_radar_matches_jax_kernel``)."""
    x = skeletons(t=T_IN)
    (_, (w_re, _)), w_grads = _jax_loss(
        lambda x, loc, lam: jax_radar.radar_return_spline(
            x, UP, loc, lam, tile=tile))(jnp.asarray(x), jnp.asarray(LOC),
                                         jnp.asarray(np.float32(lam)))
    calls = _recording_backward(monkeypatch)
    tx = torch.from_numpy(x)
    loc = torch.tensor(LOC, requires_grad=True)
    tlam = torch.tensor(np.float32(lam), requires_grad=True)
    re, im = radar.radar_return_spline(tx, UP, loc, tlam, tile=tile)
    (re * re + im * im).sum().backward()
    assert calls == [False]
    assert tx.grad is None
    fwd_tol, grad_tol = TOL[lam]
    scale = np.abs(np.asarray(w_re)).max()
    np.testing.assert_allclose(re.detach().numpy(), np.asarray(w_re),
                               atol=fwd_tol * scale)
    for name, g, w in (("loc", loc.grad, w_grads[1]),
                       ("lambda", tlam.grad, w_grads[2])):
        w = np.asarray(w)
        assert np.isfinite(g.numpy()).all(), name
        np.testing.assert_allclose(
            g.numpy(), w, atol=grad_tol * (np.abs(w).max() or 1.0),
            err_msg=name)


def test_joints_with_a_gradient_take_the_full_backward(monkeypatch):
    calls = _recording_backward(monkeypatch)
    x = torch.from_numpy(skeletons(t=T_IN)).requires_grad_()
    lam = torch.tensor(5e-4, requires_grad=True)
    re, im = radar.radar_return_spline(x, UP, torch.tensor(LOC), lam,
                                       tile=128)
    (re.sum() + im.sum()).backward()
    assert calls == [True]
    assert x.grad is not None and torch.isfinite(x.grad).all()


@pytest.mark.parametrize("lam", [5e-4, 10.0])
def test_plain_loc_lambda_backward_equals_the_full_one(lam):
    """The plain version with ``coef_grads=False``: ``dloc`` and
    ``dlambda`` of the full plain version bit for bit, nothing else."""
    x = torch.from_numpy(skeletons(t=T_IN))
    e, ts, td, c, t_out = radar.spline_inputs(x, UP, tile=128)
    args = (e, ts, td, c, torch.tensor(LOC), torch.tensor(np.float32(lam)))
    g = torch.randn(2, 2, t_out, generator=torch.Generator().manual_seed(4))
    full = radar.spline_radar_backward(*args, g[0], g[1], t_out)
    part = radar.spline_radar_backward(*args, g[0], g[1], t_out,
                                       coef_grads=False)
    assert part[:3] == (None, None, None)
    assert torch.equal(part[3], full[3]) and torch.equal(part[4], full[4])
    assert torch.isfinite(part[3]).all() and torch.isfinite(part[4])


def test_loc_lambda_function_returns_the_loc_lambda_part():
    """``spline_radar_loc_lam_backward``: ``(dloc, dlam)`` of the backward
    with ``coef_grads=False``; on the CPU, the plain version's, counting
    no kernel launch."""
    x = torch.from_numpy(skeletons(t=T_IN))
    e, ts, td, c, t_out = radar.spline_inputs(x, UP, tile=256)
    args = (e, ts, td, c, torch.tensor(LOC), torch.tensor(np.float32(5e-4)))
    g = torch.randn(2, 2, t_out, generator=torch.Generator().manual_seed(5))
    launches = tracing.counters()["launch.radar_bwd_loc_lam"]
    got = radar.spline_radar_loc_lam_backward(*args, g[0], g[1], t_out)
    want = radar.spline_radar_backward_reference(*args, g[0], g[1], t_out,
                                                 coef_grads=False)
    assert len(got) == 2
    assert torch.equal(got[0], want[3]) and torch.equal(got[1], want[4])
    assert tracing.counters()["launch.radar_bwd_loc_lam"] == launches
