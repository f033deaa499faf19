"""PyTorch port of ST-GCN: parity with the JAX model through the bridge."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skeleton_action_recognition_tpu.models import stgcn as jax_stgcn
from skeleton_action_recognition_tpu.models.layers import (
    CONV_INIT,
    batch_norm,
)
from skeleton_action_recognition_tpu_torch import interop
from skeleton_action_recognition_tpu_torch.models import layers, stgcn
from torch_parity_helpers import randomized_variables

# f32 on the CPU in both frameworks; the two sum in different orders
# through 10 blocks, which moves logits of magnitude ~1 by ~1e-6
LOGIT_ATOL = 1e-4


def _bridged_pair(num_classes, x, seed, **port_kwargs):
    # the stock model has the fused one's variable tree and initializes
    # without running the Pallas kernel in interpret mode
    variables = randomized_variables(
        jax_stgcn.Model(num_classes=num_classes, remat=False), x, seed
    )
    jax_model = jax_stgcn.Model(
        num_classes=num_classes, remat=False, fused_sgcn=True
    )
    port = stgcn.Model(num_classes=num_classes, **port_kwargs)
    port.load_state_dict(interop.flax_to_state_dict(variables))
    return jax.jit(jax_model.apply, static_argnums=2), variables, port.eval()


@pytest.mark.parametrize("t", [16, 15])
def test_model_matches_jax_fused_model(t):
    """Eval logits at full block width. T=16 makes the stride-2 blocks pad
    3 before and 4 after (flax SAME); T=15 makes them pad 4 and 4."""
    x = np.random.default_rng(0).normal(size=(2, 3, t, 25, 2)).astype(
        np.float32
    )
    jax_apply, variables, port = _bridged_pair(
        6, x, seed=1, fused_sgcn=True
    )
    want = np.asarray(jax_apply(variables, jnp.asarray(x), False))
    with torch.no_grad():
        got = port(torch.from_numpy(x)).numpy()
    assert got.shape == (2, 6)
    assert np.abs(want).max() > 0.1  # the check is not on vanishing logits
    np.testing.assert_allclose(got, want, rtol=0, atol=LOGIT_ATOL)


def test_bridge_covers_every_parameter():
    x = np.zeros((1, 3, 8, 25, 2), np.float32)
    variables = randomized_variables(
        jax_stgcn.Model(num_classes=60, remat=False), x, seed=0
    )
    state = interop.flax_to_state_dict(variables)
    port = stgcn.Model(num_classes=60)
    assert {k: tuple(v.shape) for k, v in state.items()} == {
        k: tuple(v.shape) for k, v in port.state_dict().items()
    }
    n_params = sum(p.numel() for p in port.parameters())
    assert n_params == sum(
        leaf.size for leaf in jax.tree_util.tree_leaves(variables["params"])
    ) == 3_080_082


@pytest.mark.parametrize("stride,t", [(1, 9), (2, 8), (2, 9)])
def test_temporal_conv_matches_flax(stride, t):
    rng = np.random.default_rng(stride * 10 + t)
    x = rng.normal(size=(2, t, 25, 8)).astype(np.float32)
    flax_tconv = jax_stgcn.TemporalConv(16, stride=stride)
    variables = jax.tree_util.tree_map(
        np.asarray, flax_tconv.init(jax.random.key(1), jnp.asarray(x), False)
    )
    variables["params"]["BatchNorm_0"]["scale"] = rng.uniform(
        0.5, 1.5, 8
    ).astype(np.float32)
    variables["batch_stats"]["BatchNorm_1"]["mean"] = rng.normal(
        size=16
    ).astype(np.float32)
    port = stgcn.TemporalConv(8, 16, stride=stride).eval()
    port.load_state_dict(interop.flax_to_state_dict(variables))
    want = np.asarray(flax_tconv.apply(variables, jnp.asarray(x), False))
    with torch.no_grad():
        got = port(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_batch_norm_matches_flax(dtype):
    """Keras epsilon 1e-3, running statistics, output in ``dtype``."""
    rng = np.random.default_rng(5)
    x = rng.normal(1.0, 2.0, size=(4, 6, 5, 7)).astype(np.float32)
    jax_dtype, port_dtype = {
        "f32": (None, None), "bf16": (jnp.bfloat16, torch.bfloat16),
    }[dtype]
    bn = batch_norm(False, dtype=jax_dtype)
    variables = jax.tree_util.tree_map(
        np.asarray, bn.init(jax.random.key(0), jnp.asarray(x))
    )
    variables["params"]["scale"] = rng.uniform(0.5, 1.5, 7).astype(
        np.float32
    )
    variables["params"]["bias"] = rng.normal(size=7).astype(np.float32)
    variables["batch_stats"]["mean"] = rng.normal(size=7).astype(np.float32)
    variables["batch_stats"]["var"] = rng.uniform(0.5, 2.0, 7).astype(
        np.float32
    )
    want = np.asarray(bn.apply(variables, jnp.asarray(x)), np.float32)
    port = layers.BatchNorm(7, port_dtype).eval()
    port.load_state_dict(interop.flax_to_state_dict(variables))
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    assert got.dtype == (port_dtype or torch.float32)
    # bf16: both normalize in f32 and round the output to bf16 once, so
    # they may differ by a bf16 ulp, 2^-8 of the largest output
    atol = 1e-5 if dtype == "f32" else 2**-8 * np.abs(want).max()
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0, atol=atol)


def test_batch_norm_refuses_training_mode():
    """Batch statistics and momentum updates come with the training
    port; until then a module in training mode must not run."""
    with pytest.raises(NotImplementedError):
        layers.BatchNorm(7)(torch.zeros(2, 7))


def test_conv_init_matches_flax_distribution():
    """CONV_INIT: the same truncated normal (scale 2 over fan_out) as flax,
    compared by its spread and bounds (the two draw different bits)."""
    flax_w = np.asarray(
        CONV_INIT(jax.random.key(0), (256, 768), jnp.float32)
    )
    port_w = layers.conv_init_(
        torch.empty(768, 256), torch.Generator().manual_seed(0)
    ).numpy()
    std = np.sqrt(2.0 / 768) / 0.87962566103423978
    for w in (flax_w, port_w):
        assert np.abs(w).max() <= 2 * std * (1 + 1e-6)
    np.testing.assert_allclose(port_w.std(), flax_w.std(), rtol=1e-2)
    np.testing.assert_allclose(port_w.std(), np.sqrt(2.0 / 768), rtol=1e-2)


def test_bf16_model_tracks_jax_bf16_model():
    """dtype=bfloat16 runs the blocks in bf16 with f32 pooling and logits.
    Both frameworks round at other places (the port rounds x @ W + b once,
    the JAX stock layer rounds x @ W and the bias add apart), so the
    bound is a bf16 one: 8 significant bits through 10 blocks."""
    x = np.random.default_rng(2).normal(size=(2, 3, 16, 25, 2)).astype(
        np.float32
    )
    variables = randomized_variables(
        jax_stgcn.Model(num_classes=6, remat=False), x, seed=3
    )
    want = np.asarray(jax_stgcn.Model(
        num_classes=6, remat=False, dtype=jnp.bfloat16
    ).apply(variables, jnp.asarray(x), False))
    port = stgcn.Model(num_classes=6, dtype=torch.bfloat16).eval()
    port.load_state_dict(interop.flax_to_state_dict(variables))
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(
        got.numpy(), want, rtol=0, atol=5e-2 * np.abs(want).max()
    )
