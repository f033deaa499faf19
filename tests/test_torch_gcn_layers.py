"""The port's graph tools, graph ops, PointwiseMLP and graph-conv layers
against the JAX package's, forward and gradients."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skeleton_action_recognition_tpu import graphs as jax_graphs
from skeleton_action_recognition_tpu.models import (
    gcn as jax_gcn,
    layers as jax_layers,
)
from skeleton_action_recognition_tpu.ops import graph as jax_graph_ops
from skeleton_action_recognition_tpu_torch import graphs, interop
from skeleton_action_recognition_tpu_torch.models import gcn, layers
from skeleton_action_recognition_tpu_torch.ops import graph as graph_ops
from torch_parity_helpers import (
    assert_parity,
    cotangent,
    layer_parity,
    redrawn,
)

V = 25
# f32 on the CPU in both frameworks, sums in other orders: outputs and
# gradients of one layer agree to a few float32 ulps of their scale
OUT_TOL = 1e-5
GRAD_TOL = 1e-5
EPSILON = 0.3  # GIN's self-loop weight, redrawn from its initial 0


def _variables(module, *inputs, seed=0, epsilon=None):
    """Flax variables of ``module`` on ``inputs``, with every BatchNorm
    scale, bias, mean and variance and every bias redrawn from ``seed``,
    and ``epsilon`` set where given."""
    variables = redrawn(jax.device_get(module.init(
        jax.random.key(seed), *map(jnp.asarray, inputs), False)), seed + 100)
    if epsilon is None:
        return variables
    return jax.tree_util.tree_map_with_path(
        lambda path, leaf: np.float32(epsilon)
        if path[-1].key == "epsilon" else leaf, variables)


def _binary_stack(k, seed):
    rng = np.random.default_rng(seed)
    return (rng.random((k, V, V)) > 0.7).astype(np.float32)


# graph tools -----------------------------------------------------------


def test_graph_tools_match_jax():
    rng = np.random.default_rng(0)
    edges = [tuple(e) for e in rng.integers(0, 7, size=(12, 2))]
    np.testing.assert_array_equal(graphs.edge2mat(edges, 7),
                                  jax_graphs.edge2mat(edges, 7))
    a = rng.random((7, 7)) * (rng.random((7, 7)) > 0.5)
    a[:, 3] = 0.0  # a zero column stays zero
    np.testing.assert_array_equal(graphs.normalize_digraph(a),
                                  jax_graphs.normalize_digraph(a))
    for normalize in (True, False):
        np.testing.assert_array_equal(
            graphs.get_spatial_graph(V, graphs.SELF_LINK, graphs.INWARD,
                                     graphs.OUTWARD, normalize=normalize),
            jax_graphs.get_spatial_graph(
                V, jax_graphs.SELF_LINK, jax_graphs.INWARD,
                jax_graphs.OUTWARD, normalize=normalize),
        )


@pytest.mark.parametrize("mode,shape", [("spatial", (3, V, V)),
                                        ("GIN", (2, V, V))])
def test_graph_labelings_match_jax(mode, shape):
    got = graphs.Graph(mode)
    want = jax_graphs.Graph(mode)
    assert got.A.shape == shape
    np.testing.assert_array_equal(got.A, want.A)
    assert got.neighbor == want.neighbor and got.self_link == want.self_link
    if mode == "GIN":  # binary, without the identity
        assert set(np.unique(got.A)) == {0.0, 1.0}
        assert not np.diagonal(got.A, axis1=1, axis2=2).any()


def test_spatial_adjacency_is_the_spatial_labeling():
    a = graphs.spatial_adjacency()
    assert a.dtype == np.float32
    np.testing.assert_array_equal(
        a, jax_graphs.Graph("spatial").A.astype(np.float32))
    with pytest.raises(ValueError, match="labeling_mode"):
        graphs.Graph("bogus")


# ops/graph.py -----------------------------------------------------------


@pytest.mark.parametrize("bias", [None, (3, 8), (8,)],
                         ids=["no_bias", "bias_per_partition", "bias"])
def test_spatial_graph_conv_matches_jax(bias):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 5, V, 6)).astype(np.float32)
    w = rng.normal(size=(6, 3, 8)).astype(np.float32)
    a = rng.normal(size=(3, V, V)).astype(np.float32)
    args = [x, w, a] + ([] if bias is None else
                        [rng.normal(size=bias).astype(np.float32)])
    ct = cotangent((2, 5, V, 8), 2)

    def jax_loss(*xs):
        return jnp.sum(jax_graph_ops.spatial_graph_conv(*xs) * ct)

    want_out = np.asarray(jax_graph_ops.spatial_graph_conv(
        *map(jnp.asarray, args)))
    want_grads = jax.grad(jax_loss, argnums=tuple(range(len(args))))(
        *map(jnp.asarray, args))
    ts = [torch.tensor(v, requires_grad=True) for v in args]
    out = graph_ops.spatial_graph_conv(*ts)
    (out * torch.from_numpy(ct)).sum().backward()
    scale = np.abs(want_out).max()
    np.testing.assert_allclose(out.detach().numpy(), want_out, rtol=0,
                               atol=OUT_TOL * scale)
    for t, g in zip(ts, want_grads):
        g = np.asarray(g)
        np.testing.assert_allclose(t.grad.numpy(), g, rtol=0,
                                   atol=GRAD_TOL * np.abs(g).max())


@pytest.mark.parametrize("tensor_eps", [False, True])
def test_gin_aggregate_matches_jax(tensor_eps):
    """The self loop comes last; a float32 tensor epsilon is differentiated
    as the layers' parameter is."""
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 4, V, 5)).astype(np.float32)
    a = _binary_stack(2, 4)
    ct = cotangent((2, 4, 3, V, 5), 5)
    eps = np.float32(EPSILON)

    def jax_loss(x, a, e):
        return jnp.sum(jax_graph_ops.gin_aggregate(x, a, e) * ct)

    e_in = jnp.asarray(eps) if tensor_eps else EPSILON
    want_out = np.asarray(jax_graph_ops.gin_aggregate(
        jnp.asarray(x), jnp.asarray(a), e_in))
    argnums = (0, 1, 2) if tensor_eps else (0, 1)
    want_grads = jax.grad(jax_loss, argnums=argnums)(
        jnp.asarray(x), jnp.asarray(a), e_in)
    tx = torch.tensor(x, requires_grad=True)
    ta = torch.tensor(a, requires_grad=True)
    te = torch.tensor(eps, requires_grad=True) if tensor_eps else EPSILON
    out = graph_ops.gin_aggregate(tx, ta, te)
    (out * torch.from_numpy(ct)).sum().backward()
    assert out.shape == (2, 4, 3, V, 5)
    np.testing.assert_allclose(out[:, :, -1].detach().numpy(),
                               (1 + EPSILON) * x, rtol=1e-6)
    np.testing.assert_allclose(out.detach().numpy(), want_out, rtol=0,
                               atol=OUT_TOL * np.abs(want_out).max())
    got_grads = [tx.grad, ta.grad] + ([te.grad] if tensor_eps else [])
    for got, want in zip(got_grads, want_grads):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=GRAD_TOL * np.abs(want).max())


def test_gin_aggregate_promotes_bf16_as_jnp():
    """A bfloat16 input with a float32 epsilon and stack computes in
    float32, as in JAX."""
    x = np.random.default_rng(6).normal(size=(1, 2, V, 3)).astype(np.float32)
    a = _binary_stack(2, 7)
    want = jax_graph_ops.gin_aggregate(
        jnp.asarray(x, jnp.bfloat16), jnp.asarray(a),
        jnp.asarray(EPSILON, jnp.float32))
    got = graph_ops.gin_aggregate(
        torch.from_numpy(x).bfloat16(), torch.from_numpy(a),
        torch.tensor(EPSILON))
    assert want.dtype == jnp.float32 and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


# models/layers.py ---------------------------------------------------------


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("return_logits", [False, True])
def test_pointwise_mlp_matches_jax(return_logits, train):
    x = np.random.default_rng(8).normal(size=(3, 7, 6)).astype(np.float32)
    flax_mlp = jax_layers.PointwiseMLP((16, 8, 4),
                                       return_logits=return_logits)
    variables = _variables(flax_mlp, x)
    port = layers.PointwiseMLP(6, (16, 8, 4), return_logits=return_logits)
    assert {k: tuple(v.shape) for k, v in port.state_dict().items()} == {
        k: tuple(v.shape) for k, v in
        interop.flax_to_state_dict(variables).items()}
    assert_parity(layer_parity(flax_mlp, port, variables, [x], train),
                  OUT_TOL, GRAD_TOL)


# models/gcn.py ------------------------------------------------------------


def _first(out):
    return out[0] if isinstance(out, tuple) else out


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("per_sample", [False, True],
                         ids=["shared", "per_sample"])
def test_graph_conv_matches_jax(per_sample, train):
    rng = np.random.default_rng(9)
    x = rng.normal(size=(3, V, 6)).astype(np.float32)
    a = rng.normal(size=(3, V, V) if per_sample else (V, V)).astype(
        np.float32)
    flax_layer = jax_gcn.GraphConv(10)
    variables = _variables(flax_layer, x, a)
    result = layer_parity(flax_layer, gcn.GraphConv(6, 10), variables,
                          [x, a], train, pick=_first)
    assert_parity(result, OUT_TOL, GRAD_TOL)


def test_graph_conv_refuses_other_adjacency_shapes():
    x = torch.zeros(3, V, 6)
    with pytest.raises(ValueError, match="unsupported adjacency"):
        gcn.GraphConv(6, 4)(x, torch.zeros(2, V, V))


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("per_sample", [False, True],
                         ids=["shared", "per_sample"])
def test_graph_iso_conv_matches_jax(per_sample, train):
    rng = np.random.default_rng(10)
    x = rng.normal(size=(3, V, 6)).astype(np.float32)
    a = _binary_stack(3, 11) if per_sample else _binary_stack(1, 11)[0]
    flax_layer = jax_gcn.GraphIsoConv((12, 8))
    variables = _variables(flax_layer, x, a, epsilon=EPSILON)
    result = layer_parity(flax_layer, gcn.GraphIsoConv(6, (12, 8)),
                          variables, [x, a], train, pick=_first)
    assert_parity(result, OUT_TOL, GRAD_TOL)
    assert np.abs(result["params"]["epsilon"][0]) > 0  # epsilon trains


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_graph_iso_conv_td_matches_jax(train):
    """ST-GIN's spatial module: three partitions, each with its MLP."""
    rng = np.random.default_rng(12)
    x = rng.normal(size=(2, 5, V, 6)).astype(np.float32)
    a = graphs.Graph("spatial").A[:2].astype(np.float32)
    flax_layer = jax_gcn.GraphIsoConvTD((8, 8))
    variables = _variables(flax_layer, x, a, epsilon=EPSILON)
    port = gcn.GraphIsoConvTD(6, (8, 8))
    assert port.out_channels == 8
    result = layer_parity(flax_layer, port, variables, [x, a], train,
                          pick=_first)
    assert_parity(result, OUT_TOL, GRAD_TOL)


def test_graph_iso_conv_td_promotes_bf16_as_jax():
    """A bfloat16 input computes in float32 (the GIN layer takes no dtype in
    JAX): the same float32 output."""
    x = np.random.default_rng(13).normal(size=(2, 5, V, 6)).astype(
        np.float32)
    a = graphs.Graph("spatial").A[:2].astype(np.float32)
    flax_layer = jax_gcn.GraphIsoConvTD((8, 8))
    variables = _variables(flax_layer, x, a, epsilon=EPSILON)
    x16 = jnp.asarray(x, jnp.bfloat16)
    want = flax_layer.apply(variables, x16, jnp.asarray(a), False)[0]
    port = gcn.GraphIsoConvTD(6, (8, 8)).eval()
    port.load_state_dict(interop.flax_to_state_dict(variables))
    with torch.no_grad():
        got = port(torch.from_numpy(x).bfloat16(), torch.from_numpy(a))
    assert want.dtype == jnp.float32 and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=OUT_TOL * np.abs(np.asarray(want)).max())


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_adj_graph_conv_matches_jax(train):
    """Its adjacency is a parameter, ``adjacency_matrix``, with a
    gradient."""
    x = np.random.default_rng(14).normal(size=(2, 5, V, 6)).astype(
        np.float32)
    a = graphs.spatial_adjacency()
    flax_layer = jax_gcn.AdjGraphConv(8, a)
    variables = _variables(flax_layer, x)
    port = gcn.AdjGraphConv(6, 8, a)
    result = layer_parity(flax_layer, port, variables, [x], train)
    assert_parity(result, OUT_TOL, GRAD_TOL)
    assert np.abs(result["params"]["adjacency_matrix"][0]).max() > 0


def test_plain_parameters_carry_no_l2_penalty():
    """``epsilon`` and ``adjacency_matrix`` are no ``kernel`` in JAX, so the
    L2 penalty skips them; the Dense weights count."""
    x = np.zeros((1, 2, V, 6), np.float32)
    a = graphs.Graph("spatial").A[:2].astype(np.float32)
    for flax_layer, port, args in (
        (jax_gcn.GraphIsoConvTD((8, 8)), gcn.GraphIsoConvTD(6, (8, 8)),
         (x, a)),
        (jax_gcn.AdjGraphConv(8, graphs.spatial_adjacency()),
         gcn.AdjGraphConv(6, 8, graphs.spatial_adjacency()), (x,)),
    ):
        variables = _variables(flax_layer, *args, epsilon=EPSILON)
        port.load_state_dict(interop.flax_to_state_dict(variables))
        np.testing.assert_allclose(
            layers.l2_regularization(port).item(),
            float(jax_layers.l2_regularization(variables["params"])),
            rtol=1e-5)
