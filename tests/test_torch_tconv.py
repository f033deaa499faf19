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


def _jax_weight_operands(kernel, dtype):
    """The JAX wrapper's weight operands in ``dtype``: ``wall`` (the
    forward's, ``ops/pallas/tconv.py:323-325``) and ``wt`` (the
    backward's, ``:389-391``), both ``(C, 9 * C)``."""
    k = jnp.asarray(kernel)
    c = k.shape[-1]
    wall = jnp.transpose(k[:, 0], (1, 0, 2)).reshape(c, 9 * c)
    wt = jnp.transpose(k[::-1, 0], (2, 0, 1)).reshape(c, 9 * c)
    return wall.astype(dtype), wt.astype(dtype)


@pytest.mark.parametrize("c,dtype", [(8, torch.bfloat16),
                                     (6, torch.bfloat16),
                                     (8, torch.float32),
                                     (6, torch.float32)])
def test_weight_operands_match_the_jax_wrapper(c, dtype):
    """The kernels' weight operands are the JAX wrapper's ``wall`` and
    ``wt``, exactly: in f32 as they are, ``(C, 9, C)``; in bf16 permuted
    to ``[dt][n][k]``."""
    kernel = _op_inputs(8, seed=11, c=c)[3]
    weight = torch.tensor(kernel.transpose(3, 2, 0, 1).copy())
    operands = tconv.weight_operands(weight, dtype)
    jax_dtype = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    for got, want in zip(operands, _jax_weight_operands(kernel, jax_dtype)):
        assert got.dtype == dtype and got.is_contiguous()
        want = np.asarray(want.astype(jnp.float32)).reshape(c, 9, c)
        if dtype == torch.float32:
            # wall (C_in, 9, C_out), wt (C_out, 9, C_in): the f32 kernels'
            # [k][dt][n]
            assert got.shape == (c, 9, c)
            np.testing.assert_array_equal(got.numpy(), want)
        else:
            # wall -> (9, C_out, C_in); wt -> (9, C_in, C_out)
            assert got.shape == (9, c, c)
            np.testing.assert_array_equal(got.float().numpy(),
                                          want.transpose(1, 2, 0))


# the model's stride-1 temporal chains at the training batch: (T, C) at
# NM = 256 (128 clips of 2 bodies)
MODEL_SHAPES = [(300, 64), (150, 128), (75, 256)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_backward_splits_bound_the_workspace(dtype):
    """At the model's shapes the dW kernels' splits fill most of two waves
    of three blocks per SM of the H100's 132 in f32, of one wave of one
    block per SM in bf16, without starting another, each split holds at
    least one (clip, joint) sequence (f32) or one clip (bf16), and the
    workspace of one ``9 C^2 + C`` f32 partial a split stays within ~40
    MB."""
    blocks_most = {torch.float32: 2 * 3 * 132, torch.bfloat16: 132}[dtype]
    tiles = {torch.float32: (32, 32), torch.bfloat16: (64, 64)}[dtype]
    unit = {torch.float32: 25, torch.bfloat16: 1}[dtype]
    for t, c in MODEL_SHAPES:
        splits = tconv.backward_splits(256, t, c, dtype)
        assert 1 <= splits <= 256 * unit
        assert splits * (9 * c * c + c) * 4 <= 40e6
        blocks = splits * -(-c // tiles[0]) * -(-c // tiles[1])
        assert blocks_most * 0.9 < blocks <= blocks_most
    # fewer sequences or clips than the wave holds: one each
    assert tconv.backward_splits(1, 3, 16, dtype) == unit


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("nm,t,c", [(256, 300, 64), (256, 150, 128),
                                    (256, 75, 256), (1, 3, 20),
                                    (4, 77, 136)])
def test_tile_partials_match_the_tile_grid(nm, t, c, dtype):
    """One partial of the two channel sums per (tile, channel): tiles of 16
    frames of 24 of the nm * 25 (clip, joint) sequences in f32 (the tile
    kernel's grid.x, csrc/tconv_tile.cuh::tile_grid), of 512 rows of a
    clip in bf16."""
    tiles = {torch.float32: -(-(nm * 25) // 24) * -(-t // 16),
             torch.bfloat16: nm * -(-(t * 25) // 512)}[dtype]
    assert tconv._tile_partials(nm, t, c, dtype) == tiles * 2 * c


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
    the stock TemporalConv's. The port's module ends the block, so its
    output is the JAX module's plus a residual, through the ReLU; a
    residual of 10 (above every |output|) leaves the ReLU the identity and
    every output compared."""
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
    res = torch.full(x.shape, 10.0)
    assert np.abs(want).max() < 10.0
    got = port.train()(torch.from_numpy(x), res)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.detach().numpy() - 10.0, want,
                               **MODULE_TOL)
    _assert_stats_match(port, updated["batch_stats"])

    port.load_state_dict(interop.flax_to_state_dict(variables))
    want = jax_stgcn.FusedTemporalConv(8).apply(variables, jnp.asarray(x),
                                                False)
    with torch.no_grad():
        got = port.eval()(torch.from_numpy(x), res)
    np.testing.assert_allclose(got.numpy() - 10.0, want, **MODULE_TOL)


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


@pytest.mark.parametrize("c_in,residual", [(8, True), (4, True), (8, False)],
                         ids=["identity", "projected", "none"])
def test_fused_st_conv_block_matches_jax(c_in, residual):
    """A fused ``STConvBlock`` in training, where the port's
    ``FusedTemporalConv`` ends the block (residual and ReLU through
    ``block_tail``), against the JAX block on the same variables: output,
    updated statistics, and the gradients of ``sum(sin(out))`` with respect
    to the input and every parameter."""
    x = _module_input(11, c=c_in)
    a = stgcn.spatial_adjacency()
    module = jax_stgcn.STConvBlock(8, residual=residual, fused_tconv=True)
    variables = _module_variables(module, x, jnp.asarray(a), False, seed=12)

    def loss(params, x):
        (out, _), updated = module.apply(
            {**variables, "params": params}, x, jnp.asarray(a), True,
            mutable=["batch_stats"])
        return jnp.sin(out).sum(), (out, updated)

    (_, (want, updated)), (g_params, g_x) = jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True)(variables["params"],
                                            jnp.asarray(x))
    port = stgcn.STConvBlock(c_in, 8, residual=residual, fused_tconv=True)
    assert isinstance(port.tgcn, stgcn.FusedTemporalConv)
    port.load_state_dict(interop.flax_to_state_dict(variables))
    xt = torch.from_numpy(x).requires_grad_()
    got = port.train()(xt, torch.from_numpy(a))
    assert got.dtype == torch.float32 and bool((got == 0).any())
    np.testing.assert_allclose(got.detach().numpy(), want, **MODULE_TOL)
    _assert_stats_match(port, updated["batch_stats"])
    got.sin().sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), g_x, **MODULE_TOL)
    want_grads = {k: v.numpy() for k, v in interop.flax_to_state_dict(
        {"params": jax.device_get(g_params)}).items()}
    largest = max(np.abs(w).max() for w in want_grads.values())
    for name, p in port.named_parameters():
        got_g, want_g = p.grad.numpy(), want_grads[name]
        if name in ("tgcn.Conv_0.bias", "residual_conv.bias"):
            # ahead of a training BatchNorm: 0 but for rounding, both sides
            assert max(np.abs(got_g).max(),
                       np.abs(want_g).max()) <= 1e-5 * largest, name
        else:
            # f32 sums over every row in another order: MODULE_TOL's 2e-4
            # of the largest |gradient| of the tensor
            assert (np.abs(got_g - want_g).max()
                    <= MODULE_TOL["rtol"] * np.abs(want_g).max()), name
