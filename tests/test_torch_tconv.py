"""The fused temporal chain (``ops/tconv.py``, kernels #4/#5) and the two
temporal modules fed by fused statistics, against the JAX package.

On the CPU ``affine_relu_tconv`` runs its plain forward and backward; the
CUDA kernels are held against those on the card
(``test_torch_tconv_gpu.py`` and ``chip_smoke.py``). The JAX side runs its
Pallas kernel in interpret mode, as ``tests/test_pallas_tconv.py`` does.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skeleton_action_recognition_tpu.models import stgcn as jax_stgcn
from skeleton_action_recognition_tpu.ops.pallas.tconv import (
    affine_relu_tconv as jax_affine_relu_tconv,
)
from skeleton_action_recognition_tpu_torch import interop
from skeleton_action_recognition_tpu_torch.models import stgcn
from skeleton_action_recognition_tpu_torch.ops import tconv

# the JAX package's tolerances for its Pallas kernel against the XLA chain
# (tests/test_pallas_tconv.py): f32 sums of 9 * C products, and of the
# statistics over every row, taken in other orders
U_ATOL = 1e-5
SUM_TOL = dict(rtol=1e-5, atol=1e-3)
GRAD_TOL = dict(rtol=2e-4, atol=1e-4)
# module outputs and updated statistics: the JAX test of the fused module
# against the stock one
MODULE_TOL = dict(rtol=2e-4, atol=2e-4)


def _op_inputs(t, seed=3, nm=2, c=16):
    """``(s, scale, shift, kernel HWIO, bias)`` as numpy f32. The shift is
    positive and large, so that the padded frames' ``relu(0 * scale +
    shift)`` is far from 0: a kernel that zero-pads ``s`` instead of
    ``h`` fails."""
    rng = np.random.default_rng(seed)
    s = rng.normal(size=(nm, t, 25, c)).astype(np.float32)
    scale = rng.normal(size=(c,)).astype(np.float32)
    shift = (0.5 + np.abs(rng.normal(size=(c,)))).astype(np.float32)
    kernel = (rng.normal(size=(9, 1, c, c)) * 0.1).astype(np.float32)
    bias = (rng.normal(size=(c,)) * 0.1).astype(np.float32)
    return s, scale, shift, kernel, bias


def _port_args(s, scale, shift, kernel, bias, requires_grad=False):
    args = [torch.tensor(s), torch.tensor(scale), torch.tensor(shift),
            torch.tensor(kernel.transpose(3, 2, 0, 1).copy()),
            torch.tensor(bias)]
    return [a.requires_grad_(requires_grad) for a in args]


@pytest.mark.parametrize("t", [12, 16])
def test_forward_matches_pallas_kernel(t):
    s, scale, shift, kernel, bias = _op_inputs(t)
    want = jax_affine_relu_tconv(
        jnp.asarray(s), jnp.asarray(scale), jnp.asarray(shift),
        jnp.asarray(kernel), jnp.asarray(bias), 25, 9,
    )
    got = tconv.affine_relu_tconv(*_port_args(s, scale, shift, kernel, bias))
    np.testing.assert_allclose(got[0].numpy(), want[0], rtol=0,
                               atol=U_ATOL)
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_allclose(g.numpy(), w, **SUM_TOL)


def test_padding_is_zero_after_the_affine():
    """The first and last output frames see relu(shift) > 0 only where a
    kernel wrongly zero-pads ``s``: they equal a conv of zero-padded
    ``h``."""
    s, scale, shift, kernel, bias = _op_inputs(12)
    port = _port_args(s, scale, shift, kernel, bias)
    u = tconv.affine_relu_tconv(*port)[0]
    h = torch.relu(port[0] * port[1] + port[2])
    first = torch.einsum(
        "ntvc,oct->nvo", h[:, :5], port[3][:, :, 4:, 0]
    ) + port[4]
    np.testing.assert_allclose(u[:, 0].numpy(), first.numpy(), atol=1e-5)


def _sin_loss(u, s2, ss2):
    """``tests/test_pallas_tconv.py``'s loss: every cotangent is nonzero."""
    return (torch.sin(u).sum() + (s2 * 0.1).sum() + (ss2 * 0.01).sum())


@pytest.mark.parametrize("t", [12, 16])
def test_gradients_match_pallas_vjp(t):
    s, scale, shift, kernel, bias = _op_inputs(t, seed=4)

    def jax_loss(args):
        u, s2, ss2 = jax_affine_relu_tconv(*args, 25, 9)
        return (jnp.sum(jnp.sin(u)) + jnp.sum(s2 * 0.1)
                + jnp.sum(ss2 * 0.01))

    want = jax.grad(jax_loss)(tuple(
        jnp.asarray(a) for a in (s, scale, shift, kernel, bias)
    ))
    port = _port_args(s, scale, shift, kernel, bias, requires_grad=True)
    _sin_loss(*tconv.affine_relu_tconv(*port)).backward()
    got = [p.grad.numpy() for p in port]
    got[3] = got[3].transpose(2, 3, 1, 0)  # OIHW -> HWIO
    for name, g, w in zip(("g_s", "g_scale", "g_shift", "g_kernel",
                           "g_bias"), got, want):
        np.testing.assert_allclose(g, np.asarray(w), err_msg=name,
                                   **GRAD_TOL)


def test_backward_reference_passes_gradcheck():
    """The hand-written backward (with the statistics' cotangents folded
    in) against autograd of the forward's plain version, in float64."""
    s, scale, shift, kernel, bias = _op_inputs(8, seed=5, nm=1, c=4)
    args = [a.double().requires_grad_()
            for a in _port_args(s, scale, shift, kernel, bias)]
    assert torch.autograd.gradcheck(
        tconv.AffineReluTconv.apply, args, eps=1e-6, atol=1e-6
    )


def test_wrapper_rejects_what_the_kernels_do_not_take():
    s, scale, shift, kernel, bias = _port_args(*_op_inputs(8))
    with pytest.raises(TypeError):
        tconv.affine_relu_tconv(s.double(), scale, shift, kernel, bias)
    with pytest.raises(ValueError):
        tconv.affine_relu_tconv(s, scale, shift, kernel[:, :, :3], bias)
    with pytest.raises(ValueError):
        tconv.affine_relu_tconv_backward(s, scale, shift, kernel, s[:1])


def _module_variables(module, x, *args, seed):
    """``module.init`` on ``x`` and every BatchNorm scale, statistic and
    bias redrawn from a numpy seed."""
    variables = jax.device_get(
        module.init(jax.random.key(0), jnp.asarray(x), *args)
    )
    rng = np.random.default_rng(seed)

    def redraw(path, leaf):
        name = path[-1].key
        if name in ("scale", "var"):
            return rng.uniform(0.5, 1.5, leaf.shape).astype(np.float32)
        if name in ("mean", "bias"):
            return rng.normal(0.0, 0.1, leaf.shape).astype(np.float32)
        return np.asarray(leaf, np.float32)

    return jax.tree_util.tree_map_with_path(redraw, variables)


def _assert_stats_match(port, updated):
    want = interop.flax_to_state_dict({"batch_stats": updated})
    for name, w in want.items():
        np.testing.assert_allclose(port.state_dict()[name].numpy(),
                                   w.numpy(), err_msg=name, **MODULE_TOL)


def _module_input(seed, c=8):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(3, 16, 25, c)) + 0.3).astype(np.float32)


def test_fused_temporal_conv_matches_jax():
    """Train-mode output and both BatchNorms' updated statistics, then
    eval output, from the same randomized variables; the state dict is
    the stock TemporalConv's."""
    x = _module_input(5)
    variables = _module_variables(jax_stgcn.FusedTemporalConv(8), x, False,
                                  seed=6)
    port = stgcn.FusedTemporalConv(8, 8)
    assert port.state_dict().keys() == stgcn.TemporalConv(8, 8).state_dict(
    ).keys()
    port.load_state_dict(interop.flax_to_state_dict(variables))
    want, updated = jax_stgcn.FusedTemporalConv(8).apply(
        variables, jnp.asarray(x), True, mutable=["batch_stats"]
    )
    got = port.train()(torch.from_numpy(x))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.detach().numpy(), want, **MODULE_TOL)
    _assert_stats_match(port, updated["batch_stats"])

    port.load_state_dict(interop.flax_to_state_dict(variables))
    want = jax_stgcn.FusedTemporalConv(8).apply(variables, jnp.asarray(x),
                                                False)
    with torch.no_grad():
        got = port.eval()(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), want, **MODULE_TOL)


@pytest.mark.parametrize("stride", [1, 2])
def test_stats_temporal_conv_matches_jax(stride):
    """Fed the sums of its input, as the spatial kernel's epilogue gives
    them: train-mode output and updated statistics, then eval output."""
    x = _module_input(7)
    s, ss = x.sum((0, 1, 2)), (x * x).sum((0, 1, 2))
    module = jax_stgcn.StatsTemporalConv(8, stride=stride)
    variables = _module_variables(module, x, None, None, False, seed=8)
    port = stgcn.StatsTemporalConv(8, 8, stride=stride)
    assert port.state_dict().keys() == stgcn.TemporalConv(
        8, 8, stride=stride).state_dict().keys()
    port.load_state_dict(interop.flax_to_state_dict(variables))
    want, updated = module.apply(
        variables, jnp.asarray(x), jnp.asarray(s), jnp.asarray(ss), True,
        mutable=["batch_stats"],
    )
    got = port.train()(*(torch.from_numpy(a) for a in (x, s, ss)))
    np.testing.assert_allclose(got.detach().numpy(), want, **MODULE_TOL)
    _assert_stats_match(port, updated["batch_stats"])

    port.load_state_dict(interop.flax_to_state_dict(variables))
    want = module.apply(variables, jnp.asarray(x), None, None, False)
    with torch.no_grad():
        got = port.eval()(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), want, **MODULE_TOL)


def test_fused_temporal_conv_honours_frozen_stats():
    """Under ``frozen_stats`` (the remat recompute) neither BatchNorm's
    running statistics move."""
    from skeleton_action_recognition_tpu_torch.models.layers import (
        frozen_stats,
    )

    port = stgcn.FusedTemporalConv(8, 8).train()
    before = {k: v.clone() for k, v in port.state_dict().items()}
    with frozen_stats(port):
        port(torch.from_numpy(_module_input(9)))
    for name, b in port.state_dict().items():
        assert torch.equal(b, before[name]), name
    port(torch.from_numpy(_module_input(9)))
    assert not torch.equal(port.BatchNorm_1.running_mean,
                           before["BatchNorm_1.running_mean"])
