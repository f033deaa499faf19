"""The port's training pieces against the JAX package: train-mode
BatchNorm, the L2 penalty, Keras-2 SGD on the piecewise schedule, remat,
and the adjacency freeze."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skeleton_action_recognition_tpu.models import stgcn as jax_stgcn
from skeleton_action_recognition_tpu.models.layers import (
    batch_norm,
    l2_regularization as jax_l2,
)
from skeleton_action_recognition_tpu.train.optim import tf_sgd
from skeleton_action_recognition_tpu.train.schedules import (
    piecewise_constant as jax_piecewise,
)
from skeleton_action_recognition_tpu_torch import interop
from skeleton_action_recognition_tpu_torch.models import layers, stgcn
from skeleton_action_recognition_tpu_torch.train import (
    losses,
    schedules,
    steps as steps_lib,
)
from skeleton_action_recognition_tpu_torch.train.optim import TFSGD
from torch_parity_helpers import randomized_variables

DTYPES = {"f32": (None, None), "bf16": (jnp.bfloat16, torch.bfloat16)}


def _bn_tolerance(dtype, want):
    # f32: batch mean/var summed in other orders. bf16: both normalize in
    # f32 and round the output to bf16 once, so an element may differ by
    # a bf16 ulp, 2^-8 of the largest output
    return 1e-5 if dtype == "f32" else 2**-8 * np.abs(want).max()


def _randomized(variables, rng, features):
    variables["params"]["scale"] = rng.uniform(0.5, 1.5, features).astype(
        np.float32
    )
    variables["params"]["bias"] = rng.normal(size=features).astype(
        np.float32
    )
    variables["batch_stats"]["mean"] = rng.normal(size=features).astype(
        np.float32
    )
    variables["batch_stats"]["var"] = rng.uniform(
        0.5, 2.0, features
    ).astype(np.float32)
    return variables


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_batch_norm_train_mode_matches_flax(dtype):
    """Batch statistics over every axis but the last, biased variance,
    Keras momentum 0.99: output and updated running mean/var."""
    rng = np.random.default_rng(11)
    x = rng.normal(1.0, 2.0, size=(4, 6, 5, 7)).astype(np.float32)
    jax_dtype, port_dtype = DTYPES[dtype]
    x_in = jnp.asarray(x, jax_dtype or jnp.float32)
    bn = batch_norm(True, dtype=jax_dtype)
    variables = _randomized(
        jax.tree_util.tree_map(np.asarray, bn.init(jax.random.key(0), x_in)),
        rng, 7,
    )
    want, mutated = bn.apply(variables, x_in, mutable=["batch_stats"])
    want = np.asarray(want, np.float32)
    port = layers.BatchNorm(7, port_dtype).train()
    port.load_state_dict(interop.flax_to_state_dict(variables))
    got = port(torch.from_numpy(x).to(port_dtype or torch.float32))
    assert got.dtype == (port_dtype or torch.float32)
    np.testing.assert_allclose(
        got.detach().float().numpy(), want, rtol=0,
        atol=_bn_tolerance(dtype, want),
    )
    for name in ("mean", "var"):
        np.testing.assert_allclose(
            getattr(port, f"running_{name}").numpy(),
            np.asarray(mutated["batch_stats"][name]), rtol=1e-5, atol=1e-6,
            err_msg=name,
        )


@pytest.mark.parametrize("case", ["clamped", "unclamped", "frozen"])
def test_batch_norm_stats_from_moments(case):
    """``stats_from_moments`` takes the batch's ``(mean, var)`` from the
    moments, ``var = E[x^2] - E[x]^2`` clamped at 0 unless ``clamp`` is
    off (the third channel's moments give a negative variance), and folds
    them into the running statistics with momentum 0.99, unless
    ``update_stats`` is off (the remat recompute)."""
    bn = layers.BatchNorm(3)
    bn.update_stats = case != "frozen"
    mean = torch.tensor([1.0, -2.0, 0.5])
    sq = torch.tensor([3.0, 4.0, 0.2])
    got_mean, got_var = bn.stats_from_moments(mean, sq, 8,
                                              clamp=case != "unclamped")
    want_var = torch.tensor([2.0, 0.0, -0.05])
    if case != "unclamped":
        want_var = want_var.clamp(min=0.0)
    torch.testing.assert_close(got_mean, mean, rtol=0, atol=0)
    torch.testing.assert_close(got_var, want_var)
    if case == "frozen":
        want_mean, want_var = torch.zeros(3), torch.ones(3)
    else:
        want_mean, want_var = 0.01 * mean, 0.99 + 0.01 * want_var
    torch.testing.assert_close(bn.running_mean, want_mean)
    torch.testing.assert_close(bn.running_var, want_var)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_data_batch_norm_train_mode_matches_flax(dtype):
    """Statistics per (joint, channel) over batch x time."""
    rng = np.random.default_rng(12)
    x = rng.normal(0.5, 1.5, size=(3, 9, 25, 3)).astype(np.float32)
    jax_dtype, port_dtype = DTYPES[dtype]
    dbn = jax_stgcn.DataBatchNorm(dtype=jax_dtype)
    variables = jax.tree_util.tree_map(
        np.asarray, dbn.init(jax.random.key(0), jnp.asarray(x), True)
    )
    variables = {
        c: {"BatchNorm_0": v} for c, v in _randomized(
            {c: variables[c]["BatchNorm_0"] for c in variables}, rng, 75
        ).items()
    }
    want, mutated = dbn.apply(
        variables, jnp.asarray(x), True, mutable=["batch_stats"]
    )
    want = np.asarray(want, np.float32)
    port = stgcn.DataBatchNorm(75, port_dtype).train()
    port.load_state_dict(interop.flax_to_state_dict(variables))
    got = port(torch.from_numpy(x))
    np.testing.assert_allclose(
        got.detach().float().numpy(), want, rtol=0,
        atol=_bn_tolerance(dtype, want),
    )
    stats = mutated["batch_stats"]["BatchNorm_0"]
    np.testing.assert_allclose(
        port.BatchNorm_0.running_mean.numpy(), np.asarray(stats["mean"]),
        rtol=1e-5, atol=1e-6,
    )
    np.testing.assert_allclose(
        port.BatchNorm_0.running_var.numpy(), np.asarray(stats["var"]),
        rtol=1e-5, atol=1e-6,
    )


def test_l2_regularization_matches_jax_and_skips_batch_norm_scales():
    x = np.zeros((1, 3, 8, 25, 2), np.float32)
    variables = randomized_variables(
        jax_stgcn.Model(num_classes=6, remat=False), x, seed=2
    )
    port = stgcn.Model(num_classes=6)
    port.load_state_dict(interop.flax_to_state_dict(variables))
    want = float(jax_l2(variables["params"], 1e-4))
    got = layers.l2_regularization(port, 1e-4).item()
    np.testing.assert_allclose(got, want, rtol=1e-5)
    with torch.no_grad():
        for m in port.modules():
            if isinstance(m, layers.BatchNorm):
                m.weight.mul_(10.0)
    assert layers.l2_regularization(port, 1e-4).item() == got


def test_piecewise_constant_matches_jax():
    jax_sched = jax_piecewise(0.1, [3, 7])
    port_sched = schedules.piecewise_constant(0.1, [3, 7])
    for count in range(10):
        assert port_sched(count) == float(jax_sched(count))
    assert schedules.reference_gnn_boundaries([10, 50], 64) == [6250, 31250]


def test_tf_sgd_matches_jax_across_a_boundary():
    """Six steps with the lr falling 10x after step 3, gradients drawn
    from a seed: parameters and velocity within 1e-6 of the JAX tf_sgd
    (the same f32 arithmetic, rounded in another order)."""
    rng = np.random.default_rng(13)
    p0 = rng.normal(size=(5, 4)).astype(np.float32)
    grads = rng.normal(size=(6, 5, 4)).astype(np.float32)
    tx = tf_sgd(jax_piecewise(0.5, [3]), momentum=0.9, nesterov=True)
    params = jnp.asarray(p0)
    opt_state = tx.init(params)
    port_p = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    port_opt = TFSGD([port_p], schedules.piecewise_constant(0.5, [3]))
    for g in grads:
        updates, opt_state = tx.update(jnp.asarray(g), opt_state, params)
        params = params + updates
        port_p.grad = torch.from_numpy(g.copy())
        port_opt.step()
        np.testing.assert_allclose(
            port_p.detach().numpy(), np.asarray(params), rtol=0, atol=1e-6
        )
        np.testing.assert_allclose(
            port_opt.state[port_p]["velocity"].numpy(),
            np.asarray(opt_state.velocity), rtol=0, atol=1e-6,
        )
    assert port_opt.param_groups[0]["count"] == int(opt_state.count) == 6


def test_mask_gradients_uses_where_and_leaves_zeros():
    model = torch.nn.Module()
    model.adjacency_matrix = torch.nn.Parameter(torch.ones(3))
    model.other = torch.nn.Parameter(torch.ones(2))
    model.adjacency_matrix.grad = torch.tensor([1.0, float("inf"), 2.0])
    model.other.grad = torch.tensor([3.0, 4.0])
    steps_lib.mask_gradients_by_name(model, "adjacency_matrix", False)
    assert model.adjacency_matrix.grad.tolist() == [0.0, 0.0, 0.0]
    assert model.other.grad.tolist() == [3.0, 4.0]
    model.adjacency_matrix.grad = None
    steps_lib.mask_gradients_by_name(model, "adjacency_matrix", True)
    assert model.adjacency_matrix.grad.tolist() == [0.0, 0.0, 0.0]


def _seeded_port(seed, **kwargs):
    x = np.zeros((1, 3, 8, 25, 2), np.float32)
    variables = randomized_variables(
        jax_stgcn.Model(num_classes=6, remat=False), x, seed
    )
    port = stgcn.Model(num_classes=6, **kwargs)
    port.load_state_dict(interop.flax_to_state_dict(variables), strict=False)
    return port


@pytest.mark.parametrize("fused", [False, True], ids=["stock", "fused"])
def test_remat_gives_the_same_step_and_updates_statistics_once(fused):
    """remat=True (torch.utils.checkpoint per block) and remat=False: the
    same loss, gradients and running statistics (the same f32 ops in the
    same order on the CPU). The recompute does not update the statistics
    a second time: they equal those of one train-mode forward."""
    rng = np.random.default_rng(14)
    x = torch.from_numpy(
        rng.normal(size=(2, 3, 12, 25, 2)).astype(np.float32)
    )
    y = torch.nn.functional.one_hot(torch.tensor([1, 4]), 6).float()
    results = {}
    for remat in (False, True):
        port = _seeded_port(3, fused_sgcn=fused, remat=remat).train()
        loss = losses.total_loss(port(x), y, port, 2)
        loss.backward()
        results[remat] = (
            loss.item(),
            {n: p.grad.clone() for n, p in port.named_parameters()},
            {n: b.clone() for n, b in port.named_buffers()},
        )
    once = _seeded_port(3, fused_sgcn=fused, remat=False).train()
    with torch.no_grad():
        once(x)
    assert results[True][0] == pytest.approx(results[False][0], rel=1e-6)
    for name, g in results[False][1].items():
        np.testing.assert_allclose(
            results[True][1][name].numpy(), g.numpy(), rtol=1e-5,
            atol=1e-7, err_msg=name,
        )
    for name, b in once.named_buffers():
        for remat in (False, True):
            np.testing.assert_allclose(
                results[remat][2][name].numpy(), b.numpy(), rtol=1e-6,
                atol=1e-7, err_msg=f"{name} remat={remat}",
            )


def test_adjacency_freeze_holds_until_unfrozen():
    """With trainable_adjacency the adjacency takes no update while frozen
    (train_adj False) and moves once unfrozen."""
    rng = np.random.default_rng(15)
    x = torch.from_numpy(
        rng.normal(size=(2, 3, 8, 25, 2)).astype(np.float32)
    )
    y = torch.nn.functional.one_hot(torch.tensor([0, 2]), 6).float()
    port = _seeded_port(4, trainable_adjacency=True)
    a0 = port.adjacency_matrix.detach().clone()
    assert "adjacency_matrix" in port.state_dict()
    opt = TFSGD(port.parameters(), 0.1)
    step = steps_lib.make_train_step(port, opt, 2)
    for _ in range(2):
        step(x, y, False)
    assert torch.equal(port.adjacency_matrix.detach(), a0)
    step(x, y, True)
    assert not torch.equal(port.adjacency_matrix.detach(), a0)


def test_fused_model_refuses_a_trainable_adjacency():
    with pytest.raises(ValueError):
        stgcn.Model(num_classes=6, fused_sgcn=True, trainable_adjacency=True)
