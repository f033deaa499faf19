"""Spectrogram training in the port against the JAX trainer: one step of
``make_radar_train_step`` + ``RadarOptimizer`` against the JAX package's
``make_radar_train_step`` + ``make_radar_optimizer(optax.adam(schedule))``
from the same bridged weights, in each phase of the staged unfreeze, and
the physics-parameter update rule against ``radar_physics_transform``."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from skeleton_action_recognition_tpu.models import spectrogram as jax_spec
from skeleton_action_recognition_tpu.train import optim as jax_optim
from skeleton_action_recognition_tpu.train import schedules as jax_sched
from skeleton_action_recognition_tpu.train import steps as jax_steps
from skeleton_action_recognition_tpu.train.train_state import TrainState
from skeleton_action_recognition_tpu_torch import interop
from skeleton_action_recognition_tpu_torch.models import spectrogram
from skeleton_action_recognition_tpu_torch.ops import radar, stft_logmag
from skeleton_action_recognition_tpu_torch.train import optim, schedules
from skeleton_action_recognition_tpu_torch.train import steps as steps_lib
from test_torch_spectrogram import SMALL, skeletons
from torch_parity_helpers import randomized_variables

# Adam's first step moves each element by lr * g / |g| = +-lr (the bias
# corrections cancel), so an element whose gradient sits near zero, where
# f32 sums in other orders can flip its sign, steps the other way: the
# backbone after one step to 2 lr + 1e-6. lr is the schedule's first value.
LR = 1e-4
BACKBONE_ATOL = 2 * LR + 1e-6
# the loss: f32 through the radar at lambda = 5e-4 (see
# test_torch_spectrogram.LOGIT_TOL) and a log-softmax: 1e-3 relative
LOSS_RTOL = 1e-3


def _pair(train_lambda, train_loc):
    """One train step of the JAX model and of the port from one bridged
    init: the JAX loss, params after the step, and the port's."""
    x = skeletons()
    y = np.eye(4, dtype=np.float32)[[1, 3]]
    variables = randomized_variables(
        jax_spec.Model(**SMALL, use_pallas=True, use_pallas_stft=True), x, 7)
    schedule = (1e-4, 0.1, 10)

    jm = jax_spec.Model(**SMALL, use_pallas=True, use_pallas_stft=True)
    tx = jax_optim.make_radar_optimizer(
        optax.adam(jax_sched.cyclic_triangular(*schedule)))
    state = TrainState.create(apply_fn=jm.apply, params=variables["params"],
                              batch_stats=variables["batch_stats"], tx=tx)
    step = jax.jit(jax_steps.make_radar_train_step(
        2, train_lambda=train_lambda, train_loc=train_loc))
    state, m = step(state, jnp.asarray(x), jnp.asarray(y))
    want = interop.flax_to_state_dict(
        {"params": jax.device_get(state.params),
         "batch_stats": jax.device_get(state.batch_stats)})

    port = spectrogram.Model(**SMALL, use_pallas=True, use_pallas_stft=True)
    port.load_state_dict(interop.flax_to_state_dict(variables))
    opt = optim.RadarOptimizer(port.named_parameters(),
                               schedules.cyclic_triangular(*schedule))
    port_step = steps_lib.make_radar_train_step(port, opt, 2, train_lambda,
                                                train_loc)
    metrics = port_step(torch.from_numpy(x), torch.from_numpy(y))
    before = interop.flax_to_state_dict(variables)
    return float(m["loss"]), metrics, want, port.state_dict(), before, opt


@pytest.mark.parametrize("train_lambda,train_loc", [
    (False, False), (True, False), (False, True), (True, True),
], ids=["frozen", "lambda", "loc", "both"])
def test_train_step_matches_jax_in_each_phase(train_lambda, train_loc):
    """The loss, the backbone and BN statistics after one step, and the
    radar parameters: a frozen one bit for bit where it was, a trained one
    moved as JAX moves it (lambda by -1e-2 lambda sign(g), loc by 1e-2 m
    along g / |g|)."""
    loss, metrics, want, got, before, opt = _pair(train_lambda, train_loc)
    np.testing.assert_allclose(metrics["loss"].item(), loss, rtol=LOSS_RTOL)
    assert metrics["count"].item() == 2
    for name, w in want.items():
        g = got[name]
        if "radar" in name:
            trained = train_lambda if "lambda" in name else train_loc
            if not trained:
                assert torch.equal(g, before[name]), name
                assert torch.equal(w, before[name]), name
                continue
            assert not torch.equal(g, before[name]), name
            step, want_step = g - before[name], w - before[name]
            if "lambda" in name:
                # -1e-2 lambda sign(g): the same step where the signs agree
                torch.testing.assert_close(step, want_step, rtol=1e-5,
                                           atol=0)
                continue
            # loc moves 1e-2 m along dloc / |dloc|. Through the log-
            # magnitude at lambda = 5e-4, dloc is a residue of cancelling
            # phase terms (ops/pallas/radar.py's note) and two f32 sums of
            # it agree in direction only: within 8 degrees (measured 2.3)
            assert step.norm().item() == pytest.approx(1e-2, rel=1e-5)
            cos = (step @ want_step) / (step.norm() * want_step.norm())
            assert cos.item() > 0.99, (step, want_step)
        elif "running" in name:
            torch.testing.assert_close(g, w, rtol=1e-3, atol=1e-3, msg=name)
        else:
            torch.testing.assert_close(g, w, rtol=0, atol=BACKBONE_ATOL,
                                       msg=name)
    counts = {opt.param_groups[i]["label"]: opt.state[p].get("count")
              for i in range(len(opt.param_groups))
              for p in opt.param_groups[i]["params"]}
    assert counts["radar_lambda"] == (1.0 if train_lambda else None)
    assert counts["radar_loc"] == (1.0 if train_loc else None)


def test_frozen_phase_records_no_radar_backward():
    """Both radar parameters frozen: the spectrogram needs no gradient, so
    autograd records neither backward (kernels #7 and #11 on the card);
    unfreezing lambda records both."""
    port = spectrogram.Model(**SMALL, use_pallas=True, use_pallas_stft=True)
    calls = {"radar": 0, "stft": 0}
    real = (radar.spline_radar_backward, stft_logmag.stft_logmag_backward)

    def count(key, fn):
        def wrapped(*args):
            calls[key] += 1
            return fn(*args)
        return wrapped

    radar.spline_radar_backward = count("radar", real[0])
    stft_logmag.stft_logmag_backward = count("stft", real[1])
    try:
        x = torch.from_numpy(skeletons())
        y = torch.eye(4)[[0, 1]]
        opt = optim.RadarOptimizer(port.named_parameters(), 1e-4)
        steps_lib.make_radar_train_step(port, opt, 2)(x, y)
        assert calls == {"radar": 0, "stft": 0}
        steps_lib.make_radar_train_step(port, opt, 2, train_lambda=True)(x, y)
        assert calls == {"radar": 1, "stft": 1}
    finally:
        radar.spline_radar_backward, stft_logmag.stft_logmag_backward = real


def _jax_rule(rel_step, floor, step_decay, grads, p0=1.0):
    tx = jax_optim.radar_physics_transform(rel_step, floor, step_decay)
    p = {"p": jnp.asarray(p0, jnp.float32)}
    st = tx.init(p)
    out = []
    for g in grads:
        up, st = tx.update({"p": jnp.asarray(g, jnp.float32)}, st, p)
        p = {"p": p["p"] + up["p"]}
        out.append((float(up["p"]), int(st.count["p"])))
    return out


def _port_rule(rel_step, floor, step_decay, grads, p0=1.0):
    p = torch.tensor(p0)
    count = torch.zeros(())
    out = []
    for g in grads:
        up, count = optim.physics_update(torch.tensor(np.float32(g)), p,
                                         count, rel_step, floor, step_decay)
        p = p + up
        out.append((up.item(), int(count.item())))
    return out


@pytest.mark.parametrize("rel_step,floor,step_decay,grads,p0", [
    (0.1, 0.0, 0.5, [3.0, 0.0, -7.0, 1.0], 1.0),
    (0.1, 0.0, 0.5, [np.nan, 2.0, -np.inf, np.inf], 1.0),
    (0.1, 0.0, 1.0, [2.0, 2.0, 2.0], 1.0),
    (1e-2, 1.0, 1.0, [1e30, -np.inf, 0.0, 5.0], 0.0),
    (1e-2, 0.0, 0.998, [np.inf, np.inf, -1.0], 5e-4),
], ids=["decay-skips-frozen", "nan-and-inf", "constant", "floor", "lambda"])
def test_physics_update_matches_jax(rel_step, floor, step_decay, grads, p0):
    """The update and the active-step count after each gradient, as
    ``radar_physics_transform``: a zero or all-nan gradient moves nothing
    and spends no decay; inf keeps its sign; the floor moves a parameter
    at zero."""
    got = _port_rule(rel_step, floor, step_decay, grads, p0)
    want = _jax_rule(rel_step, floor, step_decay, grads, p0)
    for (gu, gc), (wu, wc) in zip(got, want):
        assert gc == wc
        assert gu == pytest.approx(wu, rel=1e-6, abs=0)


def test_physics_direction_of_a_vector_matches_jax():
    """radar_loc's update is a unit direction: nan entries drop, inf
    entries dominate with their sign."""
    g = np.array([np.inf, -2.0, np.nan], np.float32)
    want = jax_optim._sanitized_direction(jnp.asarray(g))
    got = optim.sanitized_direction(torch.from_numpy(g))
    # -2 / 3e38 is subnormal, which XLA's CPU backend flushes to zero
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-37)


def test_optimizer_state_round_trips_and_skips_frozen():
    """Adam's moments, the step count and the physics counts survive
    ``state_dict``; a parameter with no gradient neither moves nor counts,
    while Adam's count still advances (optax counts every step)."""
    model = spectrogram.Model(**SMALL, use_pallas=True, use_pallas_stft=True)
    opt = optim.RadarOptimizer(model.named_parameters(),
                               schedules.cyclic_triangular(1e-4, 0.1, 2))
    for p in model.parameters():
        p.grad = torch.ones_like(p)
    model.virtual_radar.radar_loc.grad = None
    loc = model.virtual_radar.radar_loc.detach().clone()
    opt.step()
    assert torch.equal(model.virtual_radar.radar_loc, loc)
    assert "count" not in opt.state[model.virtual_radar.radar_loc]
    assert opt.state[model.virtual_radar.radar_lambda]["count"] == 1
    clone = optim.RadarOptimizer(model.named_parameters(),
                                 schedules.cyclic_triangular(1e-4, 0.1, 2))
    clone.load_state_dict(opt.state_dict())
    assert clone.current_lr() == opt.current_lr() == pytest.approx(0.05005)
    for p in model.parameters():
        for key, value in opt.state[p].items():
            assert torch.equal(clone.state[p][key], value)
