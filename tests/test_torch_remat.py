"""The port's ST-GCN under ``remat_policy="full"`` and ``"dots"``
(``models/stgcn.py::remat_block``) against no remat and against the JAX
model's ``remat_policy="dots"`` (``jax.checkpoint_policies.checkpoint_dots``)
on the same weights, at full block width and a few frames, on the CPU (the
fused options run their kernels' plain versions here).

A policy changes what the backward keeps, not the math: gradients and
running statistics equal those without remat (``tests/test_remat.py``'s
rtol 1e-5, atol 1e-6). "dots" keeps the outputs of the matrix products, so
its backward recomputes none of them; "full" recomputes every one of the
blocks' (counted with a dispatch mode, as the selective checkpoint context
sees them).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from skeleton_action_recognition_tpu.models import stgcn as jax_stgcn
from skeleton_action_recognition_tpu_torch import interop
from skeleton_action_recognition_tpu_torch.models import stgcn
from skeleton_action_recognition_tpu_torch.train import losses
from skeleton_action_recognition_tpu_torch.train.optim import TFSGD
from skeleton_action_recognition_tpu_torch.train.steps import make_train_step
from torch_parity_helpers import randomized_variables

POLICIES = ("full", "dots")
OPTIONS = {
    "stock": {},
    "fused_sgcn": dict(fused_sgcn=True),
    "sgcn_stats": dict(fused_sgcn=True, sgcn_stats=True),
    "fused_tconv": dict(fused_sgcn=True, fused_tconv=True),
}
GRAD_TOL = dict(rtol=1e-5, atol=1e-6)  # tests/test_remat.py:38-63
STATS_TOL = dict(rtol=1e-6, atol=1e-7)


class ProductCounter(TorchDispatchMode):
    """Counts the matrix products (``stgcn.SAVED_PRODUCTS``) that reach the
    dispatcher while it is on. Entered around a backward, it sits below a
    selective-checkpoint context, which answers the products it keeps
    without running them: what it counts ran."""

    def __init__(self):
        super().__init__()
        self.count = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.count += func in stgcn.SAVED_PRODUCTS
        return func(*args, **(kwargs or {}))


def batch(seed, t=12, n=2):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, 3, t, 25, 2)).astype(np.float32)
    y = np.eye(6, dtype=np.float32)[rng.integers(0, 6, size=n)]
    return torch.from_numpy(x), torch.from_numpy(y)


def seeded(seed=0, **options):
    return stgcn.Model(num_classes=6,
                       generator=torch.Generator().manual_seed(seed),
                       **options)


def grads_and_counts(policy, options, x, y):
    """One loss and backward in training mode: ``(loss, gradients, running
    statistics, products in the forward, products in the backward)``;
    ``policy`` None is no remat."""
    model = seeded(remat=policy is not None,
                   remat_policy=policy or "full", **options).train()
    forward, backward = ProductCounter(), ProductCounter()
    with forward:
        loss = losses.total_loss(model(x), y, model, len(x))
    with backward:
        loss.backward()
    return (loss.item(),
            {n: p.grad.clone() for n, p in model.named_parameters()},
            {n: b.clone() for n, b in model.named_buffers()},
            forward.count, backward.count)


@pytest.mark.parametrize("option", list(OPTIONS))
@pytest.mark.parametrize("policy", POLICIES)
def test_policy_matches_no_remat(policy, option):
    """The same loss, gradients and running statistics as remat off (the
    recompute leaves the statistics as the forward set them), with the
    fused options' autograd Functions (their plain versions here)
    recomputed under both policies."""
    x, y = batch(1)
    base = grads_and_counts(None, OPTIONS[option], x, y)
    got = grads_and_counts(policy, OPTIONS[option], x, y)
    assert got[0] == pytest.approx(base[0], rel=1e-6)
    for name, g in base[1].items():
        np.testing.assert_allclose(got[1][name].numpy(), g.numpy(),
                                   err_msg=name, **GRAD_TOL)
    for name, b in base[2].items():
        np.testing.assert_allclose(got[2][name].numpy(), b.numpy(),
                                   err_msg=name, **STATS_TOL)


def test_dots_recomputes_no_product_and_full_all():
    """Backward products beyond remat off's: none under "dots"; under
    "full" every product of the blocks' forward (all but the logits
    head's)."""
    x, y = batch(2)
    counts = {p: grads_and_counts(p, {}, x, y)[3:]
              for p in (None,) + POLICIES}
    forward, backward = counts[None]
    head = 1  # the logits Linear, outside the blocks
    assert forward > 10 + head
    assert counts["dots"] == (forward, backward)
    assert counts["full"] == (forward, backward + forward - head)


def test_dots_matches_jax_dots_model():
    """The port's "dots" model against JAX's ``Model(remat_policy="dots")``
    on the same randomized weights, one train-mode forward and backward of
    the cross-entropy, JAX's in float64 (``tests/test_torch_zoo.py``'s
    oracle and tolerances: a float32 run flips the ReLUs within rounding of
    0, which moves single gradient tensors by up to 1.8e-2 in norm; each is
    held in norm, relative to the larger of its own norm and a tenth of the
    largest in its block): logits, batch statistics, the parameters' and
    the input's gradients."""
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 3, 12, 25, 2)).astype(np.float32)
    y = np.eye(6, dtype=np.float32)[[1, 4]]
    model = jax_stgcn.Model(num_classes=6, remat=True, remat_policy="dots")
    variables = randomized_variables(
        jax_stgcn.Model(num_classes=6, remat=False), x, seed=4)

    def loss(params, xs):
        logits, mutated = model.apply(
            {**variables, "params": params}, xs, True,
            mutable=["batch_stats"])
        ce = -jnp.mean(jnp.sum(jax.nn.log_softmax(logits) * y, -1))
        return ce, (logits, mutated["batch_stats"])

    with jax.enable_x64(True):
        variables = jax.tree_util.tree_map(np.float64, variables)
        (_, (logits, stats)), grads = jax.jit(jax.value_and_grad(
            loss, argnums=(0, 1), has_aux=True))(
                variables["params"], jnp.asarray(x, jnp.float64))
        logits, stats, grads = jax.device_get((logits, stats, grads))

    port = stgcn.Model(num_classes=6, remat_policy="dots")
    port.load_state_dict(interop.flax_to_state_dict(
        jax.tree_util.tree_map(np.float32, variables)))
    xt = torch.tensor(x, requires_grad=True)
    got = port.train()(xt)
    (-(torch.log_softmax(got, -1) * torch.from_numpy(y)).sum(-1).mean()
     ).backward()

    def rel(a, b):
        return float(np.abs(a - b).max() / np.abs(b).max())

    assert rel(got.detach().numpy(), logits) < 1e-5
    for name, w in interop.flax_to_state_dict(
            {"batch_stats": stats}).items():
        assert rel(port.state_dict()[name].numpy(), w.numpy()) < 2e-5, name
    want = interop.flax_to_state_dict({"params": grads[0]})
    have = {k: p.grad for k, p in port.named_parameters()}
    assert set(want) == set(have)
    floor = {}
    for name, w in want.items():
        block = ".".join(name.split(".")[:2])
        floor[block] = max(floor.get(block, 0.0), 0.1 * float(w.norm()))
    for name, w in want.items():
        scale = max(float(w.norm()), floor[".".join(name.split(".")[:2])])
        err = float((have[name].double() - w.double()).norm())
        assert err < 5e-2 * scale, (name, err / scale)
    dx = np.asarray(grads[1])
    assert np.linalg.norm(xt.grad.numpy() - dx) < 5e-2 * np.linalg.norm(dx)


def test_dots_trains():
    """Four SGD steps of the "dots" model lower the loss (the JAX package's
    ``test_remat_dots_trains``)."""
    x, y = batch(6, n=4)
    model = seeded(remat_policy="dots")
    step = make_train_step(model, TFSGD(model.parameters(), 1e-2,
                                        momentum=0.9, nesterov=True), 4)
    losses_ = [step(x, y, False)["loss"].item() for _ in range(4)]
    assert np.isfinite(losses_).all()
    assert losses_[-1] < losses_[0]


def test_unknown_policy_raises():
    """JAX takes any name but "dots" as "full"; the port refuses it."""
    with pytest.raises(ValueError, match="remat_policy"):
        stgcn.Model(num_classes=6, remat_policy="offload")
    with pytest.raises(ValueError, match="remat_policy"):
        stgcn.remat_block(torch.nn.Identity(), torch.zeros(1), None, "dot")
