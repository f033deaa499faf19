"""Checkpoints with resume, and the weight bridge in both directions."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skeleton_action_recognition_tpu.models import stgcn as jax_stgcn
from skeleton_action_recognition_tpu_torch import interop
from skeleton_action_recognition_tpu_torch.models import stgcn
from skeleton_action_recognition_tpu_torch.train import checkpoint, steps
from skeleton_action_recognition_tpu_torch.train.optim import TFSGD
from torch_parity_helpers import randomized_variables


def _trained(seed, steps_taken=2, **kwargs):
    """A small full-width port model and its optimizer after a few steps
    on seeded data."""
    rng = np.random.default_rng(seed)
    model = stgcn.Model(
        num_classes=5, generator=torch.Generator().manual_seed(seed),
        **kwargs,
    )
    opt = TFSGD(model.parameters(), 0.05)
    step = steps.make_train_step(model, opt, 2)
    for _ in range(steps_taken):
        x = torch.from_numpy(
            rng.normal(size=(2, 3, 8, 25, 2)).astype(np.float32)
        )
        y = torch.nn.functional.one_hot(
            torch.from_numpy(rng.integers(0, 5, 2)), 5
        ).float()
        step(x, y, True)
    return model, opt


def _assert_same_state(a, b):
    assert a.keys() == b.keys()
    for name in a:
        assert torch.equal(a[name], b[name]), name


def test_save_and_restore_round_trip(tmp_path):
    model, opt = _trained(0, trainable_adjacency=True)
    manager = checkpoint.CheckpointManager(str(tmp_path / "checkpoints"))
    assert manager.latest_step() is None
    assert manager.restore(model, opt) == (None, None)
    manager.save(3, model, opt, {"epoch": 3})

    fresh, fresh_opt = _trained(1, steps_taken=0, trainable_adjacency=True)
    extra, step = manager.restore(fresh, fresh_opt)
    assert (extra, step) == ({"epoch": 3}, 3)
    _assert_same_state(fresh.state_dict(), model.state_dict())
    assert fresh_opt.param_groups[0]["count"] == 2
    for p, q in zip(fresh.parameters(), model.parameters()):
        assert torch.equal(
            fresh_opt.state[p]["velocity"], opt.state[q]["velocity"]
        )

    eval_only, _ = _trained(2, steps_taken=0, trainable_adjacency=True)
    assert manager.restore_for_eval(eval_only) == 3
    _assert_same_state(eval_only.state_dict(), model.state_dict())


def test_keeps_the_last_five(tmp_path):
    model, opt = _trained(0, steps_taken=0)
    manager = checkpoint.CheckpointManager(str(tmp_path), max_to_keep=5)
    for step in range(7):
        manager.save(step, model, opt, {"epoch": step})
    assert manager.all_steps() == [2, 3, 4, 5, 6]
    assert manager.latest_step() == 6
    manager.save(6, model, opt, {"epoch": 60})  # a step saved again
    assert manager.restore(model, opt)[0] == {"epoch": 60}


def test_resume_continues_the_same_trajectory(tmp_path):
    """Three steps in one go equal two steps, a save, a restore into a
    fresh model and optimizer, and a third step."""
    straight, _ = _trained(5, steps_taken=3)
    model, opt = _trained(5, steps_taken=2)
    manager = checkpoint.CheckpointManager(str(tmp_path))
    manager.save(1, model, opt, {"epoch": 1})
    resumed, resumed_opt = _trained(6, steps_taken=0)
    manager.restore(resumed, resumed_opt)
    rng = np.random.default_rng(5)
    for _ in range(2):  # the batches already seen
        rng.normal(size=(2, 3, 8, 25, 2)), rng.integers(0, 5, 2)
    x = torch.from_numpy(rng.normal(size=(2, 3, 8, 25, 2)).astype(np.float32))
    y = torch.nn.functional.one_hot(
        torch.from_numpy(rng.integers(0, 5, 2)), 5
    ).float()
    steps.make_train_step(resumed, resumed_opt, 2)(x, y, True)
    _assert_same_state(resumed.state_dict(), straight.state_dict())


def test_refuses_glob_metacharacters(tmp_path):
    with pytest.raises(ValueError):
        checkpoint.CheckpointManager(str(tmp_path / "run[10-50]"))


def test_bridge_round_trip_is_exact():
    x = np.zeros((1, 3, 8, 25, 2), np.float32)
    variables = randomized_variables(
        jax_stgcn.Model(num_classes=6, remat=False,
                        trainable_adjacency=True), x, seed=3,
    )
    back = interop.state_dict_to_flax(interop.flax_to_state_dict(variables))
    flat = jax.tree_util.tree_leaves_with_path(variables)
    flat_back = jax.tree_util.tree_leaves_with_path(back)
    assert [p for p, _ in flat] == [p for p, _ in flat_back]
    for (path, a), (_, b) in zip(flat, flat_back):
        assert a.dtype == b.dtype == np.float32
        np.testing.assert_array_equal(a, b, err_msg=str(path))
    assert "adjacency_matrix" in back["params"]


def test_jax_evaluates_weights_trained_in_the_port():
    """Eval logits of the JAX model with the port's trained weights (BN
    statistics included) equal the port's, within the f32 reordering of
    10 blocks: 1e-5 of the largest logit. (After two steps the running
    statistics have moved 2% of the way to the batches', so eval-mode
    logits are large, ~4e5.)"""
    model, _ = _trained(7, steps_taken=2, trainable_adjacency=True)
    x = np.random.default_rng(8).normal(size=(2, 3, 8, 25, 2)).astype(
        np.float32
    )
    variables = interop.state_dict_to_flax(model.state_dict())
    want = np.asarray(jax_stgcn.Model(
        num_classes=5, remat=False, trainable_adjacency=True
    ).apply(variables, jnp.asarray(x), False))
    model.eval()
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    assert np.abs(want).max() > 0.1
    np.testing.assert_allclose(
        got, want, rtol=0, atol=1e-5 * np.abs(want).max()
    )
