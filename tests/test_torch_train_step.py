"""Full-width ST-GCN training steps: the port against the JAX trainer's
step (``make_train_step`` + ``tf_sgd``) from the same bridged weights."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from skeleton_action_recognition_tpu.models import stgcn as jax_stgcn
from skeleton_action_recognition_tpu.train import make_train_step
from skeleton_action_recognition_tpu.train.optim import tf_sgd
from skeleton_action_recognition_tpu.train.schedules import (
    piecewise_constant as jax_piecewise,
)
from skeleton_action_recognition_tpu.train.train_state import TrainState
from skeleton_action_recognition_tpu_torch import interop
from skeleton_action_recognition_tpu_torch.models import stgcn
from skeleton_action_recognition_tpu_torch.train import schedules
from skeleton_action_recognition_tpu_torch.train import steps as steps_lib
from skeleton_action_recognition_tpu_torch.train.optim import TFSGD
from torch_parity_helpers import randomized_variables

# One train step through 10 BN + ReLU blocks is chaotic: f32 sums taken in
# another order flip ReLU boundaries and move single gradients by ~0.5%.
# The JAX package's own tolerance for the fused against the stock model
# after one step (tests/test_pallas_sgcn.py) guards against wiring faults,
# which give order-1 errors.
MODEL_TOL = dict(rtol=5e-2, atol=5e-3)
BOUNDARY = 2  # the lr falls 10x after the second step


def _pair(lr, steps):
    """The JAX fused model (Pallas kernels in interpret mode) and the
    port's, from one bridged init with random BatchNorm statistics, each
    trained ``steps`` steps on the same seeded batches."""
    rng = np.random.default_rng(21)
    xs = rng.normal(size=(steps, 2, 3, 16, 25, 2)).astype(np.float32)
    labels = rng.integers(0, 6, size=(steps, 2))
    ys = np.eye(6, dtype=np.float32)[labels]
    variables = randomized_variables(
        jax_stgcn.Model(num_classes=6, remat=False), xs[0], seed=22
    )

    jax_model = jax_stgcn.Model(num_classes=6, remat=False, fused_sgcn=True)
    state = TrainState.create(
        apply_fn=jax_model.apply, params=variables["params"],
        batch_stats=variables["batch_stats"],
        tx=tf_sgd(jax_piecewise(lr, [BOUNDARY]), 0.9, nesterov=True),
    )
    jax_step = jax.jit(make_train_step(global_batch_size=2),
                       static_argnums=3)
    jax_losses = []
    for x, y in zip(xs, ys):
        state, m = jax_step(state, jnp.asarray(x), jnp.asarray(y), False)
        jax_losses.append(float(m["loss"]))

    port = stgcn.Model(num_classes=6, fused_sgcn=True, remat=False)
    port.load_state_dict(interop.flax_to_state_dict(variables))
    opt = TFSGD(port.parameters(),
                schedules.piecewise_constant(lr, [BOUNDARY]))
    step = steps_lib.make_train_step(port, opt, 2)
    port_losses = [
        step(torch.from_numpy(x), torch.from_numpy(y), False)["loss"].item()
        for x, y in zip(xs, ys)
    ]
    want = interop.flax_to_state_dict(
        {"params": jax.device_get(state.params),
         "batch_stats": jax.device_get(state.batch_stats)}
    )
    return jax_losses, port_losses, want, port.state_dict()


def test_one_train_step_matches_jax():
    """Loss within 1e-4 (the forward in f32, sums in other orders);
    updated parameters and BatchNorm statistics within MODEL_TOL."""
    jax_losses, port_losses, want, got = _pair(0.1, 1)
    np.testing.assert_allclose(port_losses, jax_losses, rtol=1e-4)
    assert want.keys() == got.keys()
    for name, w in want.items():
        np.testing.assert_allclose(
            got[name].numpy(), w.numpy(), err_msg=name, **MODEL_TOL
        )


def test_steps_across_an_lr_boundary_track_jax():
    """Four steps at lr 1e-3, falling 10x after the second. Each step's
    loss within 1e-2 relative: the first is the forward alone (1e-4
    above); each later one carries the parameters' chaotic drift, which
    grows from step to step (a 1e-6 relative change of the input alone
    moves single gradients by 0.5%; measured here: 3.4e-3 at the fourth
    step). At lr 1e-2 the same drift reaches 5% by the fourth step."""
    jax_losses, port_losses, _, _ = _pair(1e-3, 4)
    np.testing.assert_allclose(port_losses, jax_losses, rtol=1e-2)
    assert port_losses[-1] < port_losses[0]
