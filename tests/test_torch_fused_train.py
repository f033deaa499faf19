"""Full-width ST-GCN with the two fused training options, ``sgcn_stats``
(kernel #2) and ``fused_tconv`` (kernels #4/#5), against the JAX model
with the same options: one train step, the bf16 forward, the routing of
the blocks, remat and eval.

On the CPU the kernels' plain versions run; the JAX side runs its Pallas
kernels in interpret mode.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skeleton_action_recognition_tpu.models import stgcn as jax_stgcn
from skeleton_action_recognition_tpu.train import make_train_step
from skeleton_action_recognition_tpu.train.optim import tf_sgd
from skeleton_action_recognition_tpu.train.train_state import TrainState
from skeleton_action_recognition_tpu_torch import interop
from skeleton_action_recognition_tpu_torch.models import stgcn
from skeleton_action_recognition_tpu_torch.train import losses
from skeleton_action_recognition_tpu_torch.train import steps as steps_lib
from skeleton_action_recognition_tpu_torch.train.optim import TFSGD
from torch_parity_helpers import randomized_variables

OPTIONS = {
    "fused_tconv": dict(fused_tconv=True),
    "sgcn_stats": dict(fused_sgcn=True, sgcn_stats=True),
}
# one train step through 10 BN + ReLU blocks is chaotic (see
# test_torch_train_step.py): the JAX package's own tolerance for a fused
# model against the stock one after a step
MODEL_TOL = dict(rtol=5e-2, atol=5e-3)


def _batch(seed, t=16):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(2, 3, t, 25, 2)).astype(np.float32)
    y = np.eye(6, dtype=np.float32)[rng.integers(0, 6, size=2)]
    return x, y


def _stock_variables(x, seed):
    """A stock JAX model's randomized variables: the options keep its
    variable tree, so a stock checkpoint loads into either."""
    return randomized_variables(
        jax_stgcn.Model(num_classes=6, remat=False), x, seed
    )


def _port(variables, **kwargs):
    port = stgcn.Model(num_classes=6, remat=False, **kwargs)
    port.load_state_dict(interop.flax_to_state_dict(variables))
    return port


@pytest.mark.parametrize("option", list(OPTIONS))
def test_one_train_step_matches_jax(option):
    """Loss within 1e-4; updated parameters and BatchNorm statistics
    within MODEL_TOL; the updated tree is the stock one."""
    x, y = _batch(31)
    variables = _stock_variables(x, seed=32)
    jax_model = jax_stgcn.Model(num_classes=6, remat=False,
                                **OPTIONS[option])
    state = TrainState.create(
        apply_fn=jax_model.apply, params=variables["params"],
        batch_stats=variables["batch_stats"],
        tx=tf_sgd(0.1, 0.9, nesterov=True),
    )
    state, metrics = jax.jit(make_train_step(global_batch_size=2),
                             static_argnums=3)(
        state, jnp.asarray(x), jnp.asarray(y), False)

    port = _port(variables, **OPTIONS[option])
    step = steps_lib.make_train_step(port, TFSGD(port.parameters(), 0.1), 2)
    loss = step(torch.from_numpy(x), torch.from_numpy(y), False)["loss"]
    np.testing.assert_allclose(loss.item(), float(metrics["loss"]),
                               rtol=1e-4)
    want = interop.flax_to_state_dict(
        {"params": jax.device_get(state.params),
         "batch_stats": jax.device_get(state.batch_stats)}
    )
    got = port.state_dict()
    assert want.keys() == got.keys()
    for name, w in want.items():
        np.testing.assert_allclose(got[name].numpy(), w.numpy(),
                                   err_msg=name, **MODEL_TOL)


@pytest.mark.parametrize("option", list(OPTIONS))
def test_bf16_train_forward_tracks_jax(option):
    """dtype=bfloat16, train mode (where the kernels run): logits within
    the bf16 bound of test_torch_stgcn.py, 5% of the largest (8
    significant bits through 10 blocks, rounded at other places)."""
    x, _ = _batch(33)
    variables = _stock_variables(x, seed=34)
    want, _ = jax_stgcn.Model(
        num_classes=6, remat=False, dtype=jnp.bfloat16, **OPTIONS[option]
    ).apply(variables, jnp.asarray(x), True, mutable=["batch_stats"])
    port = _port(variables, dtype=torch.bfloat16, **OPTIONS[option])
    got = port.train()(torch.from_numpy(x))
    assert got.dtype == torch.float32
    want = np.asarray(want)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0,
                               atol=5e-2 * np.abs(want).max())


def _tgcn_types(**kwargs):
    model = stgcn.Model(num_classes=6, **kwargs)
    return [type(getattr(model.backbone, f"block_{i}").tgcn).__name__
            for i in range(len(stgcn.BLOCK_PLAN))]


def test_routing_follows_the_jax_block():
    """sgcn_stats takes precedence over fused_tconv and applies at stride
    2; fused_tconv leaves the stride-2 blocks (4 and 7) stock;
    fused_sgcn_min_channels=128 leaves the C=64 blocks unstatted;
    sgcn_stats without fused_sgcn does nothing."""
    stats, fused, stock = ("StatsTemporalConv", "FusedTemporalConv",
                           "TemporalConv")
    assert _tgcn_types(fused_sgcn=True, sgcn_stats=True,
                       fused_tconv=True) == [stats] * 10
    assert _tgcn_types(fused_tconv=True) == [
        fused, fused, fused, fused, stock, fused, fused, stock, fused, fused]
    assert _tgcn_types(fused_sgcn=True, sgcn_stats=True,
                       fused_sgcn_min_channels=128) == [stock] * 4 + [
        stats] * 6
    assert _tgcn_types(fused_sgcn=True, sgcn_stats=True, fused_tconv=True,
                       fused_sgcn_min_channels=128) == [fused] * 4 + [
        stats] * 6
    assert _tgcn_types(sgcn_stats=True) == [stock] * 10


def test_every_temporal_chain_draws_one_parameter_layout():
    """The three chains build the same state dict from the same draws of
    ``generator``; the fused chain refuses what it cannot run (C -> C' or
    other taps or stride) before it draws anything."""
    def drawn(cls, *args, **kwargs):
        g = torch.Generator().manual_seed(3)
        return cls(*args, generator=g, **kwargs).state_dict()

    want = drawn(stgcn.TemporalConv, 8, 8)
    for cls in (stgcn.StatsTemporalConv, stgcn.FusedTemporalConv):
        got = drawn(cls, 8, 8)
        assert got.keys() == want.keys()
        for name, w in want.items():
            assert torch.equal(got[name], w), (cls.__name__, name)
    for args, kwargs in (((4, 8), {}), ((8, 8, 5), {}),
                         ((8, 8), dict(stride=2))):
        g = torch.Generator().manual_seed(3)
        before = g.get_state()
        with pytest.raises(ValueError, match="fused chain"):
            stgcn.FusedTemporalConv(*args, generator=g, **kwargs)
        assert torch.equal(g.get_state(), before)


def test_fused_spatial_conv_feeds_the_sums_to_the_chains_that_take_them():
    """A block's spatial conv emits BN1's sums (in training) where it is
    the fused default one and its temporal module takes them: every
    ``sgcn_stats`` block, and the ``fused_tconv`` stride-1 blocks whose
    spatial conv is fused; never under ``fused_sgcn_min_channels``, with
    the unfused spatial conv or with another spatial module."""
    def emitted(**kwargs):
        model = stgcn.Model(num_classes=6, **kwargs)
        return [getattr(model.backbone, f"block_{i}").emit_stats
                for i in range(len(stgcn.BLOCK_PLAN))]

    chain = [True] * 4 + [False, True, True, False, True, True]
    assert emitted(fused_sgcn=True, fused_tconv=True) == chain
    assert emitted(fused_sgcn=True, fused_tconv=True,
                   fused_sgcn_min_channels=128) == [False] * 4 + chain[4:]
    assert emitted(fused_sgcn=True, sgcn_stats=True,
                   fused_tconv=True) == [True] * 10
    assert emitted(fused_tconv=True) == [False] * 10
    assert emitted(fused_sgcn=True) == [False] * 10
    gin = stgcn.STConvBlock(
        8, 8, fused_sgcn=True, fused_tconv=True,
        sgcn_factory=lambda c_in, c, g: stgcn.GraphConvTD(c_in, c))
    assert isinstance(gin.tgcn, stgcn.FusedTemporalConv)
    assert not gin.emit_stats


def test_stock_checkpoint_loads_under_every_option():
    """The options keep the stock variable tree: a stock JAX model's
    variables load strictly, and the port's state dict maps back onto
    the stock tree."""
    x, _ = _batch(35, t=8)
    variables = _stock_variables(x, seed=36)
    state = interop.flax_to_state_dict(variables)
    stock_tree = jax.tree_util.tree_structure(variables)
    for kwargs in (OPTIONS["fused_tconv"], OPTIONS["sgcn_stats"],
                   dict(fused_sgcn=True, sgcn_stats=True, fused_tconv=True)):
        port = stgcn.Model(num_classes=6, **kwargs)
        port.load_state_dict(state)  # strict
        back = interop.state_dict_to_flax(port.state_dict())
        assert jax.tree_util.tree_structure(back) == stock_tree


# the options and fused_tconv behind the fused spatial conv, whose
# epilogue gives BN1's sums to the fused chain (its stats route rerun in
# the recompute)
REMAT_OPTIONS = {**OPTIONS,
                 "fused_sgcn_tconv": dict(fused_sgcn=True, fused_tconv=True)}


@pytest.mark.parametrize("option", list(REMAT_OPTIONS))
def test_remat_gives_the_same_step_and_updates_statistics_once(option):
    """remat=True and remat=False: the same loss, gradients and running
    statistics, equal to those of one train-mode forward: the recompute
    in the backward leaves the statistics the fused modules set."""
    x, y = _batch(37, t=12)
    variables = _stock_variables(x, seed=38)
    xt, yt = torch.from_numpy(x), torch.from_numpy(y)
    results = {}
    for remat in (False, True):
        port = _port(variables, **REMAT_OPTIONS[option])
        port.backbone.remat = remat
        loss = losses.total_loss(port.train()(xt), yt, port, 2)
        loss.backward()
        results[remat] = (
            loss.item(),
            {n: p.grad.clone() for n, p in port.named_parameters()},
            {n: b.clone() for n, b in port.named_buffers()},
        )
    once = _port(variables, **REMAT_OPTIONS[option]).train()
    with torch.no_grad():
        once(xt)
    assert results[True][0] == pytest.approx(results[False][0], rel=1e-6)
    for name, g in results[False][1].items():
        np.testing.assert_allclose(results[True][1][name].numpy(),
                                   g.numpy(), rtol=1e-5, atol=1e-7,
                                   err_msg=name)
    for name, b in once.named_buffers():
        for remat in (False, True):
            np.testing.assert_allclose(
                results[remat][2][name].numpy(), b.numpy(), rtol=1e-6,
                atol=1e-7, err_msg=f"{name} remat={remat}",
            )


def test_sgcn_stats_eval_equals_fused_eval():
    """The epilogue is a training construct: in eval a sgcn_stats model
    equals the fused-only model, as the JAX package checks
    (tests/test_pallas_sgcn.py)."""
    x, _ = _batch(39)
    variables = _stock_variables(x, seed=40)
    with torch.no_grad():
        base = _port(variables, fused_sgcn=True).eval()(torch.from_numpy(x))
        stats = _port(variables, **OPTIONS["sgcn_stats"]).eval()(
            torch.from_numpy(x))
    np.testing.assert_allclose(stats.numpy(), base.numpy(), rtol=1e-5,
                               atol=1e-5)


def test_fused_tconv_eval_matches_jax():
    """Eval logits of a fused_tconv model (its plain folded chain) against
    the JAX model with the same option, at the f32 bound of
    test_torch_stgcn.py."""
    x, _ = _batch(41)
    variables = _stock_variables(x, seed=42)
    want = jax_stgcn.Model(num_classes=6, remat=False, fused_tconv=True
                           ).apply(variables, jnp.asarray(x), False)
    with torch.no_grad():
        got = _port(variables, fused_tconv=True).eval()(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-4)
