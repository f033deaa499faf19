"""PyTorch port of the fused spatial graph conv: parity with the JAX op.

On the CPU ``fused_graph_conv`` runs its plain version; the CUDA kernel is
held against that plain version on the card (``test_torch_sgcn_gpu.py``
and ``chip_smoke.py``).
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
from skeleton_action_recognition_tpu_torch.graphs.ntu_rgb_d import (
    spatial_adjacency,
)
from skeleton_action_recognition_tpu_torch.models.gcn import GraphConvTD
from skeleton_action_recognition_tpu_torch.ops import build, sgcn

# f32 both sides; sums over C_in <= 16 and K*V = 75 terms in other orders
ATOL = RTOL = 1e-5
A = Graph("spatial").A.astype(np.float32)


def test_spatial_adjacency_matches_jax_graph():
    got = spatial_adjacency()
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, A)


def _inputs(seed, nm, t, c_in, c_out):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(nm, t, 25, c_in)).astype(np.float32)
    kernel = rng.normal(size=(c_in, 3 * c_out)).astype(np.float32) * 0.1
    bias = rng.normal(size=(3 * c_out,)).astype(np.float32)
    return x, kernel, bias


@pytest.mark.parametrize("c_in", [3, 16])
@pytest.mark.parametrize("t", [12, 25])
def test_fused_graph_conv_matches_pallas_kernel(t, c_in):
    """T=12 and T=25 are the Pallas kernel's tail-group cases; C_in=3 is
    the first block's input width."""
    x, kernel, bias = _inputs(t * 100 + c_in, 2, t, c_in, 16)
    want = make_fused_graph_conv(A, 25)(
        jnp.asarray(x), jnp.asarray(kernel), jnp.asarray(bias)
    )
    got = sgcn.fused_graph_conv(
        torch.from_numpy(x), torch.from_numpy(kernel.T.copy()),
        torch.from_numpy(bias), torch.from_numpy(A),
    )
    assert got.shape == (2, t, 25, 16) and got.dtype == torch.float32
    np.testing.assert_allclose(
        got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL
    )


@pytest.mark.parametrize("fused", [False, True])
def test_graph_conv_layer_matches_jax_stock_layer(fused):
    x, _, _ = _inputs(7, 2, 8, 12, 16)
    layer = JaxGraphConvTD(16)
    variables = jax.device_get(
        layer.init(jax.random.key(0), jnp.asarray(x), jnp.asarray(A))
    )
    # a nonzero bias: A's columns sum to 0, 0.5 or 1, so a bias added
    # after the contraction instead of before it would show
    variables["params"]["Dense_0"]["bias"] = np.linspace(
        -1, 1, 48, dtype=np.float32
    )
    want, _ = layer.apply(variables, jnp.asarray(x), jnp.asarray(A))
    port = GraphConvTD(12, 16, fused=fused)
    port.load_state_dict(interop.flax_to_state_dict(variables))
    with torch.no_grad():
        got = port(torch.from_numpy(x), torch.from_numpy(A))
    np.testing.assert_allclose(
        got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL
    )


def _args(**override):
    args = dict(
        x=torch.zeros(2, 4, 25, 8), weight=torch.zeros(48, 8),
        bias=torch.zeros(48), a=torch.from_numpy(A),
    )
    args.update(override)
    return args


@pytest.mark.parametrize(
    "override,error",
    [
        (dict(x=torch.zeros(2, 4, 25, 8, dtype=torch.float64)), TypeError),
        (dict(x=torch.zeros(2, 4, 24, 8)), ValueError),
        (dict(x=torch.zeros(8, 25, 8)), ValueError),
        (dict(weight=torch.zeros(47, 8)), ValueError),
        (dict(weight=torch.zeros(48, 9)), ValueError),
        (dict(bias=torch.zeros(45)), ValueError),
        (dict(a=torch.zeros(3, 25, 25, dtype=torch.bfloat16)), ValueError),
        (dict(a=torch.zeros(2, 25, 25)), ValueError),
        (dict(x=torch.zeros(2, 4, 25, 8, device="meta")), ValueError),
    ],
    ids=["x-f64", "x-joints", "x-rank", "w-rows", "w-cols", "bias", "a-dtype",
         "a-parts", "device"],
)
def test_fused_graph_conv_rejects_what_the_kernel_cannot_take(
    override, error
):
    with pytest.raises(error):
        sgcn.fused_graph_conv(**_args(**override))


def test_cpu_tensors_take_the_plain_version_without_a_launch():
    before = sgcn.fused_graph_conv.launches
    out = sgcn.fused_graph_conv(**_args())
    assert out.shape == (2, 4, 25, 16)
    assert sgcn.fused_graph_conv.launches == before


def test_library_name_follows_the_sources(tmp_path, monkeypatch):
    monkeypatch.setattr(build, "CSRC_DIR", tmp_path)
    (tmp_path / "k.cu").write_text("// one")
    first = build.library_path("k.cu")
    assert first == build.library_path("k.cu")
    (tmp_path / "k.cu").write_text("// two")
    assert build.library_path("k.cu") != first
    assert first.parent == build.BUILD_DIR and first.suffix == ".so"
