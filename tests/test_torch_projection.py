"""The port's soft-projection layers: ``SoftProjection`` against a float64
oracle of the reference's unexpanded form and against JAX stage by stage,
and ``ProjectionGraphConv`` / ``ProjectionGraphPool`` against JAX, forward
and gradients."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skeleton_action_recognition_tpu.models import projection as jax_proj
from skeleton_action_recognition_tpu_torch import interop
from skeleton_action_recognition_tpu_torch.models import projection
from torch_parity_helpers import assert_parity, layer_parity

N, P, C, J = 2, 60, 16, 8
# SoftProjection is ill-conditioned: d2 sums C whitened squares (~100
# here), softmax(-d2 / 2) is sharply peaked, and an error of d2 moves q by
# that error times q. The expanded float32 form's d2 is a difference of
# terms larger than d2. Measured against float64 over four seeds: q, z and
# a_proj within 4e-6 of their scales, for the port and for JAX alike.
ORACLE_TOL = {"q": 1e-5, "z": 1e-5, "a_proj": 1e-5}
# the two float32 frameworks, each that far from float64, sum in other
# orders: measured within 4e-6 of each other's scales
JAX_TOL = {"q": 1e-5, "z": 1e-5, "a_proj": 1e-5}
# the layers, forward and gradients (through q, z and the graph conv)
OUT_TOL = 1e-5
GRAD_TOL = 1e-4


def _points(seed, n=N, p=P, c=C):
    return np.random.default_rng(seed).normal(size=(n, p, c)).astype(
        np.float32)


def _soft_projection(x, seed):
    flax_layer = jax_proj.SoftProjection(J)
    variables = jax.device_get(
        flax_layer.init(jax.random.key(seed), jnp.asarray(x)))
    variables = jax.tree_util.tree_map(np.array, variables)  # writable
    port = projection.SoftProjection(x.shape[-1], J)
    port.load_state_dict(interop.flax_to_state_dict(variables))
    return flax_layer, variables, port


def oracle(x, centers, variance):
    """The reference's form in float64: the whitened residuals ``z = (x -
    mu) / s`` materialized, ``q = softmax(-||z||^2 / 2)``, the q-weighted
    mean of ``z`` per center, L2-normalized over the centers, and its Gram
    matrix over channels."""
    x, mu = np.float64(x), np.float64(centers)
    s = 1.0 / (1.0 + np.exp(-np.float64(variance)))  # (C, J)
    z = (x[:, :, None, :] - mu.T[None, None]) / s.T[None, None]
    logits = -0.5 * np.sum(z * z, axis=-1)  # (N, P, J)
    q = np.exp(logits - logits.max(-1, keepdims=True))
    q /= q.sum(-1, keepdims=True)
    zbar = np.einsum("npj,npjc->njc", q, z) / q.sum(1)[..., None]
    zbar /= np.sqrt(np.sum(zbar * zbar, axis=1, keepdims=True))
    return {"q": q, "z": zbar, "a_proj": np.einsum("nic,njc->nij", zbar,
                                                     zbar)}


def _rel_err(got, want):
    return float(np.abs(got - want).max() / np.abs(want).max())


def test_soft_projection_matches_the_float64_oracle():
    x = _points(0)
    _, variables, port = _soft_projection(x, seed=1)
    sp = variables["params"]
    want = oracle(x, sp["centers"], sp["variance"])
    with torch.no_grad():
        got = dict(zip(("q", "z", "a_proj"), port(torch.from_numpy(x))))
    # the assignment is peaked but not one-hot: the check sees softmax work
    assert 0.3 < want["q"].max(-1).mean() < 0.99
    for stage, tol in ORACLE_TOL.items():
        assert _rel_err(got[stage].numpy(), want[stage]) < tol, stage


@pytest.mark.parametrize("stage", ["q", "z", "a_proj"])
def test_soft_projection_matches_jax_by_stage(stage):
    x = _points(2)
    flax_layer, variables, port = _soft_projection(x, seed=3)
    want = dict(zip(("q", "z", "a_proj"),
                    flax_layer.apply(variables, jnp.asarray(x))))
    with torch.no_grad():
        got = dict(zip(("q", "z", "a_proj"), port(torch.from_numpy(x))))
    assert _rel_err(got[stage].numpy(), np.asarray(want[stage])) < (
        JAX_TOL[stage])


def test_soft_projection_bf16_input_matches_jax():
    """A bfloat16 input is squared in bfloat16 and promoted, as jnp does;
    everything after runs in float32 in both."""
    x = _points(4)
    flax_layer, variables, port = _soft_projection(x, seed=5)
    want = flax_layer.apply(variables, jnp.asarray(x, jnp.bfloat16))
    with torch.no_grad():
        got = port(torch.from_numpy(x).bfloat16())
    for w, g, stage in zip(want, got, ("q", "z", "a_proj")):
        assert w.dtype == jnp.float32 and g.dtype == torch.float32
        assert _rel_err(g.numpy(), np.asarray(w)) < JAX_TOL[stage], stage


def test_soft_projection_guards_a_center_without_mass():
    """A center far from every point gets no mass (q underflows to 0 in
    float32): its row of z is zeros, not NaN, as in JAX."""
    x = _points(6)
    flax_layer, variables, port = _soft_projection(x, seed=7)
    variables["params"]["centers"][:, 0] = 1e3
    port.load_state_dict(interop.flax_to_state_dict(variables))
    want = flax_layer.apply(variables, jnp.asarray(x))
    with torch.no_grad():
        q, z, a_proj = port(torch.from_numpy(x))
    assert float(q[..., 0].max()) == 0.0
    assert torch.isfinite(z).all() and torch.isfinite(a_proj).all()
    assert float(z[:, 0].abs().max()) == 0.0
    np.testing.assert_allclose(z.numpy(), np.asarray(want[1]), rtol=0,
                               atol=JAX_TOL["z"])


def test_soft_projection_init_matches_tf_glorot_bounds():
    """``centers`` and ``variance`` are uniform within TF's glorot bound on
    the reference's ``[1, C, 1, J]`` weight, sqrt(6 / (C + C J))."""
    port = projection.SoftProjection(64, 32, torch.Generator().manual_seed(0))
    limit = np.sqrt(6.0 / (64 + 64 * 32))
    for p in (port.centers.detach(), port.variance.detach()):
        assert p.shape == (64, 32)
        assert float(p.abs().max()) <= limit
        assert float(p.abs().max()) > 0.95 * limit
        np.testing.assert_allclose(float(p.std()), limit / np.sqrt(3),
                                   rtol=5e-2)


def _first(out):
    return out[0] if isinstance(out, tuple) else out


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_projection_graph_conv_matches_jax(train):
    """ST-PGCN's block over ``(N, T, V, C)``: forward, the input's and every
    parameter's gradient."""
    x = np.random.default_rng(8).normal(size=(N, 4, 25, C)).astype(
        np.float32)
    a = np.zeros((3, 25, 25), np.float32)  # passed through, unused
    flax_layer = jax_proj.ProjectionGraphConv(C, J)
    variables = jax.tree_util.tree_map(np.asarray, jax.device_get(
        flax_layer.init(jax.random.key(9), jnp.asarray(x), jnp.asarray(a))))
    variables["params"]["graph_conv"]["Dense_0"]["bias"] = (
        np.random.default_rng(10).normal(0, 0.1, C).astype(np.float32))
    port = projection.ProjectionGraphConv(C, C, J)
    result = layer_parity(flax_layer, port, variables, [x, a], train,
                          pick=_first)
    assert_parity(result, OUT_TOL, GRAD_TOL)
    assert np.abs(result["params"]["SoftProjection_0.centers"][0]).max() > 0


@pytest.mark.parametrize("rank", [4, 3])
@pytest.mark.parametrize("output", [0, 1], ids=["z", "a_proj"])
def test_projection_graph_pool_matches_jax(output, rank):
    """ST-PGCN-P's pools take ``(N, T, V, C)`` (the first) or already
    pooled ``(N, V, C)`` (the second) and return ``(z, a_proj)``."""
    shape = (N, 4, 25, C) if rank == 4 else (N, 30, C)
    x = np.random.default_rng(11).normal(size=shape).astype(np.float32)
    a = np.zeros((N, 30, 30), np.float32)  # replaced, unused
    flax_layer = jax_proj.ProjectionGraphPool(J)
    variables = jax.tree_util.tree_map(np.asarray, jax.device_get(
        flax_layer.init(jax.random.key(12), jnp.asarray(x), jnp.asarray(a))))
    port = projection.ProjectionGraphPool(C, J)
    result = layer_parity(flax_layer, port, variables, [x, a], False,
                          pick=lambda out: out[output])
    result["inputs"] = result["inputs"][:1]  # a_in has no gradient
    assert_parity(result, OUT_TOL, GRAD_TOL)
