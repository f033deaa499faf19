"""The fused spatial graph conv's gradient: the autograd Function and the
plain backward against JAX and torch autograd.

On the CPU ``fused_graph_conv`` runs its plain forward and backward; the
CUDA backward kernel is held against the plain backward on the card
(``test_torch_sgcn_gpu.py`` and ``chip_smoke.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skeleton_action_recognition_tpu.graphs.ntu_rgb_d import Graph
from skeleton_action_recognition_tpu.models.gcn import (
    GraphConvTD as JaxGraphConvTD,
)
from skeleton_action_recognition_tpu.ops.pallas.sgcn import (
    make_fused_graph_conv,
)
from skeleton_action_recognition_tpu_torch import interop, tracing
from skeleton_action_recognition_tpu_torch.models.gcn import GraphConvTD
from skeleton_action_recognition_tpu_torch.ops import sgcn

A = Graph("spatial").A.astype(np.float32)
# the JAX package's own tolerance for the Pallas VJP against autodiff of
# the einsum (tests/test_pallas_sgcn.py): f32 sums in other orders
GRAD_TOL = dict(rtol=2e-4, atol=1e-5)


def _inputs(seed, nm, t, c_in, c_out):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(nm, t, 25, c_in)).astype(np.float32)
    kernel = rng.normal(size=(c_in, 3 * c_out)).astype(np.float32) * 0.1
    bias = rng.normal(size=(3 * c_out,)).astype(np.float32)
    return x, kernel, bias


def _port_grads(fn, x, kernel, bias):
    xt = torch.tensor(x, requires_grad=True)
    wt = torch.tensor(kernel.T.copy(), requires_grad=True)
    bt = torch.tensor(bias, requires_grad=True)
    torch.sin(fn(xt, wt, bt, torch.from_numpy(A))).sum().backward()
    return xt.grad.numpy(), wt.grad.numpy().T, bt.grad.numpy()


@pytest.mark.parametrize("c_in", [3, 16])
@pytest.mark.parametrize("t", [10, 12, 25])
def test_fused_op_gradients_match_pallas_vjp(t, c_in):
    """dx/dW/db of a sum(sin(out)) loss against jax.grad through the
    Pallas kernel's custom VJP (interpret mode). T=10, 12 and 25 are its
    tail-group cases; C_in=3 is the first block's input width."""
    x, kernel, bias = _inputs(t * 10 + c_in, 2, t, c_in, 8)
    fgc = make_fused_graph_conv(A, 25)
    want = jax.grad(
        lambda s: jnp.sum(jnp.sin(fgc(*s)))
    )((jnp.asarray(x), jnp.asarray(kernel), jnp.asarray(bias)))
    got = _port_grads(sgcn.fused_graph_conv, x, kernel, bias)
    for name, g, w in zip(("dx", "dW", "db"), got, want):
        np.testing.assert_allclose(g, np.asarray(w), err_msg=name,
                                   **GRAD_TOL)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_backward_reference_matches_autograd(dtype):
    """graph_conv_backward_reference against torch autograd of
    graph_conv_reference. f32: the same sums in other orders (1e-5).
    bf16: the plain backward sums dz, dx and dW in f32 as the TPU kernel
    does, so it is held against autograd of the f32 forward on the same
    bf16-rounded inputs, within bf16's rounding of dz and dx (2^-7 of
    the largest gradient)."""
    rng = np.random.default_rng(4)
    x = torch.tensor(rng.normal(size=(2, 6, 25, 5)), dtype=torch.float32)
    w = torch.tensor(rng.normal(size=(12, 5)), dtype=torch.float32)
    b = torch.tensor(rng.normal(size=(12,)), dtype=torch.float32)
    g = torch.tensor(rng.normal(size=(2, 6, 25, 4)), dtype=torch.float32)
    a = torch.from_numpy(A)
    x, g = x.to(dtype), g.to(dtype)
    xr = x.float().clone().requires_grad_()
    wr = w.to(dtype).float().clone().requires_grad_()
    br = b.clone().requires_grad_()
    sgcn.graph_conv_reference(xr, wr, br, a.to(dtype).float()).backward(
        g.float()
    )
    got = sgcn.graph_conv_backward_reference(x, w, a, g)
    assert got[0].dtype == dtype
    assert got[1].dtype == got[2].dtype == torch.float32
    for name, p, want in zip(("dx", "dW", "db"), got, (xr, wr, br)):
        ref = want.grad
        tol = 1e-5 if dtype == torch.float32 else 2**-7
        np.testing.assert_allclose(
            p.float().numpy(), ref.numpy(), rtol=0,
            atol=tol * ref.abs().max().item(), err_msg=name,
        )


def test_fused_layer_gradients_equal_stock_and_jax_layer():
    """GraphConvTD(fused=True) trains: its parameter and input gradients
    equal the stock layer's (torch autograd) and the JAX stock layer's,
    from the same bridged weights."""
    rng = np.random.default_rng(6)
    x = rng.normal(size=(2, 8, 25, 12)).astype(np.float32)
    layer = JaxGraphConvTD(16)
    variables = jax.device_get(
        layer.init(jax.random.key(0), jnp.asarray(x), jnp.asarray(A))
    )
    variables["params"]["Dense_0"]["bias"] = np.linspace(
        -1, 1, 48, dtype=np.float32
    )

    def jax_loss(params, xx):
        out, _ = layer.apply({"params": params}, xx, jnp.asarray(A))
        return jnp.sum(jnp.sin(out))

    jax_gp, jax_gx = jax.grad(jax_loss, argnums=(0, 1))(
        variables["params"], jnp.asarray(x)
    )
    grads = {}
    for fused in (False, True):
        port = GraphConvTD(12, 16, fused=fused)
        port.load_state_dict(interop.flax_to_state_dict(variables))
        xt = torch.tensor(x, requires_grad=True)
        torch.sin(port(xt, torch.from_numpy(A))).sum().backward()
        grads[fused] = (
            xt.grad.numpy(), port.Dense_0.weight.grad.numpy(),
            port.Dense_0.bias.grad.numpy(),
        )
    want = (
        np.asarray(jax_gx), np.asarray(jax_gp["Dense_0"]["kernel"]).T,
        np.asarray(jax_gp["Dense_0"]["bias"]),
    )
    for name, fused, stock, ref in zip(
        ("dx", "dW", "db"), grads[True], grads[False], want
    ):
        np.testing.assert_allclose(fused, stock, err_msg=name, **GRAD_TOL)
        np.testing.assert_allclose(fused, ref, err_msg=name, **GRAD_TOL)


def test_fused_layer_refuses_a_trainable_adjacency():
    layer = GraphConvTD(4, 8, fused=True)
    a = torch.from_numpy(A).requires_grad_()
    with pytest.raises(ValueError):
        layer(torch.zeros(1, 2, 25, 4), a)


def test_cpu_backward_takes_the_plain_version_without_a_launch():
    x = torch.zeros(2, 4, 25, 8)
    before = tracing.counters()["launch.sgcn_bwd"]
    dx, dw, db = sgcn.fused_graph_conv_backward(
        x, torch.zeros(48, 8), torch.from_numpy(A), torch.ones(2, 4, 25, 16)
    )
    assert dx.shape == x.shape and dw.shape == (48, 8) and db.shape == (48,)
    assert tracing.counters()["launch.sgcn_bwd"] == before


@pytest.mark.parametrize(
    "override,error",
    [
        (dict(g=torch.zeros(2, 4, 25, 15)), ValueError),
        (dict(g=torch.zeros(2, 4, 24, 16)), ValueError),
        (dict(g=torch.zeros(2, 3, 25, 16)), ValueError),
        (dict(x=torch.zeros(2, 4, 25, 8, dtype=torch.float64)), TypeError),
        (dict(weight=torch.zeros(48, 9)), ValueError),
        (dict(a=torch.zeros(2, 25, 25)), ValueError),
        (dict(g=torch.zeros(2, 4, 25, 16, device="meta")), ValueError),
    ],
    ids=["g-channels", "g-joints", "g-frames", "x-f64", "w-cols",
         "a-parts", "g-device"],
)
def test_backward_rejects_what_the_kernel_cannot_take(override, error):
    args = dict(x=torch.zeros(2, 4, 25, 8), weight=torch.zeros(48, 8),
                a=torch.from_numpy(A), g=torch.zeros(2, 4, 25, 16))
    args.update(override)
    with pytest.raises(error):
        sgcn.fused_graph_conv_backward(**args)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_backward_splits_bound_the_workspace(dtype):
    """At NM=256 (128 clips) the dW workspace of every block shape stays
    under 16 MB, each split holds at least one chunk of frames (2 in f32,
    5 in bf16), and the dW grid fills more than half of one wave on the
    H100's 132 SMs (2 blocks an SM: f32 tiles of 64 output x 64 input
    channels, bf16 of 32 x 128) without starting a second."""
    chunk = {torch.float32: 2, torch.bfloat16: 5}[dtype]
    tiles = {torch.float32: (64, 64), torch.bfloat16: (32, 128)}[dtype]
    wave = 2 * 132
    for t, c_in, c_out in [(300, 3, 64), (300, 64, 64), (300, 64, 128),
                           (150, 128, 128), (150, 128, 256),
                           (75, 256, 256)]:
        frames = 256 * t
        splits = sgcn.backward_splits(frames, c_in, c_out, dtype)
        assert 1 <= splits <= frames // chunk
        assert splits * 3 * c_out * (c_in + 1) * 4 < 16e6
        blocks = splits * -(-c_out // tiles[0]) * -(-c_in // tiles[1])
        assert wave // 2 < blocks <= wave
    assert sgcn.backward_splits(3, 16, 16, dtype) == -(-3 // chunk)


@pytest.mark.parametrize("frames,dtype,tiles", [
    (1, torch.float32, 1), (5, torch.float32, 1), (7, torch.float32, 2),
    (76800, torch.float32, 15360),
    (1, torch.bfloat16, 1), (5, torch.bfloat16, 1), (7, torch.bfloat16, 2),
    (76800, torch.bfloat16, 15360),
])
def test_forward_tiles_size_the_stats_workspace(frames, dtype, tiles):
    """One partial row per block row of the stats kernel: 5 frames (a
    tile's 125 rows) a row in f32 and in bf16."""
    assert sgcn.forward_tiles(frames, dtype) == tiles


def test_kernel_weight_is_cast_once_to_the_kernels_dtype():
    """The f32 kernels read the weight as it is (no copy); the bf16 ones a
    contiguous bf16 copy, rounded to nearest even as the plain version's
    ``weight.to(x.dtype)`` rounds it."""
    w = torch.randn(48, 16)
    assert sgcn.kernel_weight(w, torch.float32) is w
    got = sgcn.kernel_weight(w.T.contiguous().T, torch.bfloat16)
    assert got.dtype == torch.bfloat16 and got.is_contiguous()
    assert torch.equal(got, w.to(torch.bfloat16))


def test_forward_weight_is_transposed_for_the_f32_kernels():
    """The f32 forward kernels read W^T, ``(C_in, K * C_out)``, contiguous
    and equal to the weight's transpose; the bf16 ones the weight as the
    backward reads it."""
    w = torch.randn(48, 16)
    got = sgcn.forward_weight(w, torch.float32)
    assert got.shape == (16, 48) and got.is_contiguous()
    assert torch.equal(got, w.T)
    assert torch.equal(sgcn.forward_weight(w, torch.bfloat16),
                       sgcn.kernel_weight(w, torch.bfloat16))
