"""The spatial graph conv with the BatchNorm-statistics epilogue (kernel
#2, ``ops/sgcn.py::fused_graph_conv_stats``) against the JAX package's
``make_fused_graph_conv(a, 25, with_stats=True)`` in interpret mode.

On the CPU the op runs its plain forward and the plain backward; the CUDA
stats kernel is held against its plain version on the card
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
from skeleton_action_recognition_tpu_torch import interop
from skeleton_action_recognition_tpu_torch.models.gcn import GraphConvTD
from skeleton_action_recognition_tpu_torch.ops import sgcn

A = Graph("spatial").A.astype(np.float32)
# tests/test_pallas_sgcn.py::test_stats_kernel_outputs_and_grads: f32 sums
# in other orders; some bias gradients nearly cancel through the mean
# subtraction (an O(1e-4) residue of O(1) sums)
FWD_TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=2e-4, atol=1e-4)


def _inputs(seed, t=12, c_in=16, c_out=8):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(2, t, 25, c_in)).astype(np.float32)
    kernel = (rng.normal(size=(c_in, 3 * c_out)) * 0.1).astype(np.float32)
    bias = (rng.normal(size=(3 * c_out,)) * 0.1).astype(np.float32)
    return x, kernel, bias


def _bn_loss(out, s, ss, xp):
    """The BN-shaped loss of the JAX test: all three cotangents flow."""
    n = out.shape[0] * out.shape[1] * out.shape[2]
    mu = s / n
    if xp is jnp:
        var = jnp.maximum(ss / n - mu * mu, 0.0)
        return jnp.sum(jnp.sin((out - mu) * jax.lax.rsqrt(var + 1e-3)))
    var = torch.clamp(ss / n - mu * mu, min=0.0)
    return torch.sin((out - mu) * torch.rsqrt(var + 1e-3)).sum()


@pytest.mark.parametrize("t", [12, 25])
def test_stats_op_matches_pallas_kernel(t):
    x, kernel, bias = _inputs(3, t)
    fgc = make_fused_graph_conv(A, 25, with_stats=True)
    jx = tuple(jnp.asarray(a) for a in (x, kernel, bias))
    want = fgc(*jx)
    xt = torch.tensor(x, requires_grad=True)
    wt = torch.tensor(kernel.T.copy(), requires_grad=True)
    bt = torch.tensor(bias, requires_grad=True)
    got = sgcn.fused_graph_conv_stats(xt, wt, bt, torch.from_numpy(A))
    for name, g, w in zip(("out", "s", "ss"), got, want):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w),
                                   err_msg=name, **FWD_TOL)

    want_grads = jax.grad(lambda args: _bn_loss(*fgc(*args), jnp))(jx)
    _bn_loss(*got, torch).backward()
    got_grads = (xt.grad.numpy(), wt.grad.numpy().T, bt.grad.numpy())
    for name, g, w in zip(("dx", "dW"), got_grads, want_grads):
        np.testing.assert_allclose(g, np.asarray(w), err_msg=name,
                                   **GRAD_TOL)
    # db of the first partition vanishes in exact arithmetic (the
    # BatchNorm removes a per-channel constant) and is a float residue in
    # every implementation: up to 4.4e-4 here, and the JAX package's own
    # XLA and Pallas routes differ by 2.9e-4 on these inputs. So db is held
    # to 1e-4 of its largest component (~18), with GRAD_TOL's rtol.
    want_db = np.asarray(want_grads[2])
    np.testing.assert_allclose(got_grads[2], want_db, rtol=GRAD_TOL["rtol"],
                               atol=1e-4 * np.abs(want_db).max(),
                               err_msg="db")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_stats_reference_sums_the_rounded_output(dtype):
    """The sums are taken in f32 on the output as stored: in bf16 they
    are the sums of the bf16 values, not of the f32 accumulator."""
    x, kernel, bias = _inputs(4)
    out, s, ss = sgcn.graph_conv_stats_reference(
        torch.tensor(x).to(dtype), torch.tensor(kernel.T.copy()),
        torch.tensor(bias), torch.from_numpy(A),
    )
    assert out.dtype == dtype
    assert s.dtype == ss.dtype == torch.float32
    of = out.float()
    assert torch.equal(s, of.sum((0, 1, 2)))
    assert torch.equal(ss, (of * of).sum((0, 1, 2)))


def test_graph_conv_emits_stats_in_training_only():
    """GraphConvTD(fused, emit_stats) gives (out, s, ss) in training, as
    the JAX layer with ``emit_stats`` does, and ``out`` alone in eval."""
    x, _, _ = _inputs(5, c_out=16)
    layer = JaxGraphConvTD(16, fused=True, fused_adjacency=A,
                           emit_stats=True)
    variables = jax.device_get(
        layer.init(jax.random.key(0), jnp.asarray(x), jnp.asarray(A))
    )
    (want, ws, wss), _ = layer.apply(variables, jnp.asarray(x),
                                     jnp.asarray(A), True)
    port = GraphConvTD(16, 16, fused=True, emit_stats=True)
    port.load_state_dict(interop.flax_to_state_dict(variables))
    a = torch.from_numpy(A)
    out, s, ss = port.train()(torch.from_numpy(x), a)
    for name, g, w in zip(("out", "s", "ss"), (out, s, ss),
                          (want, ws, wss)):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w),
                                   err_msg=name, **FWD_TOL)
    with torch.no_grad():
        evaluated = port.eval()(torch.from_numpy(x), a)
    assert torch.equal(evaluated, out.detach())
