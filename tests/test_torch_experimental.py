"""The port's experimental zoo (GPool, SGCN, SGTACN, TemporalAttention and
the debug ST-GCN) and LSTM frame sampler against the JAX package's, forward
and gradients, and the LSTM weight converter both ways."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skeleton_action_recognition_tpu.models import (
    experimental as jax_experimental,
    layers as jax_layers,
    lstm_sampler as jax_lstm_sampler,
)
from skeleton_action_recognition_tpu_torch import graphs, interop
from skeleton_action_recognition_tpu_torch.models import (
    experimental,
    layers,
    lstm_sampler,
)
from torch_parity_helpers import assert_parity, layer_parity, redrawn

V = 25
# f32 on the CPU, one layer, sums in other orders
OUT_TOL = 1e-5
GRAD_TOL = 1e-5
# the LSTM's recurrence over 20 steps: measured 2e-7 of the scale
LSTM_TOL = 1e-5
# the debug model, 10 blocks at T=300: see test_torch_zoo.py. Measured eval
# logits 3e-7, train-mode logits 1e-6 of their scale
MODEL_TOL = 1e-5
STATS_TOL = 2e-5
MODEL_GRAD_TOL = 5e-2  # in norm, against JAX in float64 (ReLU flips)


def _init(module, *inputs, seed=0):
    variables = jax.device_get(module.init(
        jax.random.key(seed), *map(jnp.asarray, inputs)))
    return redrawn(variables, seed + 1)


def _first(out):
    return out[0] if isinstance(out, tuple) else out


def lambda_module(flax_layer):
    """``flax_layer`` behind ``apply(variables, x, train, mutable)``, the
    call :func:`layer_parity` makes, for a layer without ``train``."""
    class Wrapped:
        @staticmethod
        def apply(variables, x, train, mutable=False):
            return flax_layer.apply(variables, x)

    return Wrapped


@pytest.mark.parametrize("keeprate", [0.5, 0.55])
@pytest.mark.parametrize("per_sample", [False, True],
                         ids=["shared", "per_sample"])
@pytest.mark.parametrize("output", [0, 1], ids=["x", "adjacency"])
def test_gpool_matches_jax(output, per_sample, keeprate):
    """``int(keeprate * V)`` vertices (12 and 13: rounded down), chosen by
    a stable sort of scores with no ties; the adjacency becomes its second
    power at the kept vertices."""
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 6, V, 8)).astype(np.float32)
    a = graphs.spatial_adjacency()
    if per_sample:
        a = np.stack([a, a * rng.uniform(0.5, 1.5, a.shape)]).astype(
            np.float32)
    flax_layer = jax_experimental.GPool(keeprate)
    variables = _init(flax_layer, x, a)
    port = experimental.GPool(8, 6, keeprate)
    result = layer_parity(flax_layer, port, variables, [x, a], False,
                          pick=lambda out: out[output])
    keep = int(keeprate * V)
    want_shape = (2, 6, keep, 8) if output == 0 else (2, 3, keep, keep)
    assert result["out"][1].shape == want_shape
    assert_parity(result, OUT_TOL, GRAD_TOL)


def test_gpool_scores_have_no_ties():
    """The test's scores are distinct, so the selection is unique."""
    x = np.random.default_rng(1).normal(size=(2, 6, V, 8)).astype(np.float32)
    port = experimental.GPool(8, 6, 0.5)
    feats = torch.from_numpy(x).permute(0, 2, 1, 3).reshape(2, V, -1)
    y = (feats @ port.projection_vector.detach())[..., 0]
    assert all(len(set(row.tolist())) == V for row in y)


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_sgcn_matches_jax(train):
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 4, V, 8)).astype(np.float32)
    a = rng.normal(size=(2, 3, V, V)).astype(np.float32)
    flax_layer = jax_experimental.SGCN(16)
    result = layer_parity(flax_layer, experimental.SGCN(8, 16),
                          _init(flax_layer, x, a), [x, a], train,
                          pick=_first)
    assert_parity(result, OUT_TOL, GRAD_TOL)


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_sgtacn_matches_jax(train):
    """The per-timestep adjacency ``(3, T, V, V)`` is a parameter with a
    gradient."""
    x = np.random.default_rng(3).normal(size=(2, 10, V, 8)).astype(
        np.float32)
    a = graphs.spatial_adjacency()
    flax_layer = jax_experimental.SGTACN(16, a, temporal_dim=10)
    variables = _init(flax_layer, x)
    port = experimental.SGTACN(8, 16, a, temporal_dim=10)
    assert port.adjacency_matrix.shape == (3, 10, V, V)
    np.testing.assert_array_equal(port.adjacency_matrix.detach()[:, 7], a)
    result = layer_parity(flax_layer, port, variables, [x], train)
    assert_parity(result, OUT_TOL, GRAD_TOL)


def test_temporal_attention_matches_jax():
    x = np.random.default_rng(4).normal(size=(2, 5, V, 4)).astype(
        np.float32)
    flax_layer = jax_experimental.TemporalAttention((8, 6))
    variables = jax.device_get(flax_layer.init(jax.random.key(0),
                                               jnp.asarray(x)))
    port = experimental.TemporalAttention(V * 4, (8, 6))
    result = layer_parity(
        lambda_module(flax_layer), port, variables, [x], False)
    assert_parity(result, OUT_TOL, GRAD_TOL)


def _sampler_pair(seed=5):
    x = np.random.default_rng(seed).normal(size=(2, 20, V, 3)).astype(
        np.float32)
    flax_sampler = jax_lstm_sampler.TemporalSampler((16,), top_k=5)
    variables = jax.device_get(flax_sampler.init(jax.random.key(seed),
                                                 jnp.asarray(x)))
    variables = jax.tree_util.tree_map(np.asarray, variables)
    # nonzero recurrent biases, so that the bias path is checked
    rng = np.random.default_rng(seed + 1)
    for cell in variables["params"].values():
        for gate in "ifgo":
            cell[f"h{gate}"]["bias"] = rng.normal(
                0, 0.3, cell[f"h{gate}"]["bias"].shape).astype(np.float32)
    return x, flax_sampler, variables


def test_temporal_sampler_matches_jax():
    """Stacked LSTMs through the converted weights, the top 5 of 20 frames
    (scores with no ties), forward and gradients."""
    x, flax_sampler, variables = _sampler_pair()
    port = lstm_sampler.TemporalSampler(V * 3, (16,), top_k=5)
    result = layer_parity(lambda_module(flax_sampler), port, variables, [x],
                          False)
    assert result["out"][1].shape == (2, 5, V, 3)
    with torch.no_grad():
        scores = port.scores(torch.from_numpy(x))
    assert all(len(set(row.tolist())) == 20 for row in scores)
    # torch's input bias adds to the same gates as its recurrent one, which
    # is flax's only bias: both gradients are that bias's
    for i in (0, 1):
        grads = result["params"]
        grads[f"OptimizedLSTMCell_{i}.bias_ih_l0"] = (
            grads[f"OptimizedLSTMCell_{i}.bias_hh_l0"][0],
            grads[f"OptimizedLSTMCell_{i}.bias_ih_l0"][1])
    assert_parity(result, LSTM_TOL, LSTM_TOL)


def test_lstm_converter_round_trips_both_ways():
    """flax -> torch -> flax gives every leaf back bit for bit; torch ->
    flax -> torch too where ``bias_ih`` is 0 (as the port draws it and the
    bridge writes it), and otherwise folds ``bias_ih + bias_hh`` into the
    flax cell's one bias: the same function."""
    x, _, variables = _sampler_pair(7)
    state = interop.flax_to_state_dict(variables)
    assert set(state) == {f"OptimizedLSTMCell_{i}.{leaf}_l0" for i in (0, 1)
                          for leaf in ("weight_ih", "weight_hh", "bias_ih",
                                       "bias_hh")}
    back = interop.state_dict_to_flax(state)
    jax.tree_util.tree_map(np.testing.assert_array_equal, back, variables)

    port = lstm_sampler.TemporalSampler(
        V * 3, (16,), top_k=5, generator=torch.Generator().manual_seed(8))
    drawn = port.state_dict()
    again = interop.flax_to_state_dict(interop.state_dict_to_flax(drawn))
    for name, t in drawn.items():
        torch.testing.assert_close(again[name], t, rtol=0, atol=0)

    with torch.no_grad():
        port.OptimizedLSTMCell_0.bias_ih_l0.normal_(
            0, 0.3, generator=torch.Generator().manual_seed(9))
        want = port(torch.from_numpy(x))
        port.load_state_dict(interop.flax_to_state_dict(
            interop.state_dict_to_flax(port.state_dict())))
        assert float(port.OptimizedLSTMCell_0.bias_ih_l0.abs().max()) == 0
        torch.testing.assert_close(port(torch.from_numpy(x)), want,
                                   rtol=1e-6, atol=1e-6)


def test_temporal_sampler_l2_penalty_matches_jax():
    """The LSTMs' input and recurrent weights are ``kernel`` leaves in
    JAX, so the penalty counts them; their biases it skips."""
    _, _, variables = _sampler_pair(10)
    port = lstm_sampler.TemporalSampler(V * 3, (16,), top_k=5)
    port.load_state_dict(interop.flax_to_state_dict(variables))
    np.testing.assert_allclose(
        layers.l2_regularization(port).item(),
        float(jax_layers.l2_regularization(variables["params"])), rtol=1e-6)


@pytest.fixture(scope="module")
def debug_pair():
    """The debug ST-GCN at B=1, M=1, T=300 (its fixed temporal sizes) from
    bridged random weights: eval logits (float32 both), and a train-mode
    forward and backward of the cross-entropy, JAX's in float64."""
    rng = np.random.default_rng(11)
    x = rng.normal(size=(1, 3, 300, V, 1)).astype(np.float32)
    y = np.eye(6, dtype=np.float32)[[4]]
    port = experimental.Model(num_classes=6,
                              generator=torch.Generator().manual_seed(12))
    variables = redrawn(interop.state_dict_to_flax(port.state_dict()), 13)
    port.load_state_dict(interop.flax_to_state_dict(variables))
    model = jax_experimental.Model(num_classes=6)
    jax_eval = np.asarray(jax.jit(model.apply, static_argnums=2)(
        variables, jnp.asarray(x), False))

    def loss(params, variables, x, y):
        logits, mutated = model.apply({**variables, "params": params}, x,
                                      True, mutable=["batch_stats"])
        ce = -jnp.mean(jnp.sum(jax.nn.log_softmax(logits) * y, -1))
        return ce, (logits, mutated["batch_stats"])

    with jax.enable_x64(True):
        v64 = jax.tree_util.tree_map(np.float64, variables)
        (_, (jax_train, jax_stats)), jax_grads = jax.jit(
            jax.value_and_grad(loss, has_aux=True))(
                v64["params"], v64, jnp.asarray(x, jnp.float64),
                jnp.asarray(y, jnp.float64))
        jax_train, jax_stats, jax_grads = jax.device_get(
            (jax_train, jax_stats, jax_grads))

    with torch.no_grad():
        port_eval = port.eval()(torch.from_numpy(x)).numpy()
    port.train()
    logits = port(torch.from_numpy(x))
    (-(torch.log_softmax(logits, -1) * torch.from_numpy(y)).sum(-1)
     .mean()).backward()
    return {
        "eval": (jax_eval, port_eval),
        "train": (np.asarray(jax_train), logits.detach().numpy()),
        "stats": (interop.flax_to_state_dict({"batch_stats": jax_stats}),
                  port.state_dict()),
        "grads": (interop.flax_to_state_dict({"params": jax_grads}),
                  {k: p.grad for k, p in port.named_parameters()}),
    }


def _rel(got, want):
    return float(np.abs(got - want).max() / np.abs(want).max())


def test_debug_model_eval_logits_match_jax(debug_pair):
    want, got = debug_pair["eval"]
    assert got.shape == (1, 6) and np.abs(want).max() > 0.1
    assert _rel(got, want) < MODEL_TOL


def test_debug_model_train_logits_and_stats_match_jax(debug_pair):
    want, got = debug_pair["train"]
    assert _rel(got, want) < MODEL_TOL
    stats, state = debug_pair["stats"]
    for name, w in stats.items():
        assert _rel(state[name].numpy(), w.numpy()) < STATS_TOL, name


def test_debug_model_gradients_match_jax(debug_pair):
    """Every parameter, the ten per-timestep adjacencies included."""
    want, got = debug_pair["grads"]
    assert set(want) == set(got)
    # the 60-class model's count less the 54 classes' head rows
    assert sum(w.numel() for w in want.values()) == 7_017_582 - 54 * 257
    floor = 0.1 * max(float(w.norm()) for w in want.values())
    for name, w in want.items():
        scale = max(float(w.norm()), floor)
        err = float((got[name].double() - w.double()).norm())
        assert err < MODEL_GRAD_TOL * scale, (name, err / scale)
    assert float(got["block_9.sgcn.adjacency_matrix"].abs().max()) > 0
