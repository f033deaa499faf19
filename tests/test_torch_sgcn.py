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
from skeleton_action_recognition_tpu_torch import interop, tracing
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
    before = tracing.counters()["launch.sgcn_fwd"]
    out = sgcn.fused_graph_conv(**_args())
    assert out.shape == (2, 4, 25, 16)
    assert tracing.counters()["launch.sgcn_fwd"] == before


def test_library_name_follows_the_sources(tmp_path, monkeypatch):
    monkeypatch.setattr(build, "CSRC_DIR", tmp_path)
    (tmp_path / "k.cu").write_text("// one")
    first = build.library_path("k.cu")
    assert first == build.library_path("k.cu")
    (tmp_path / "k.cu").write_text("// two")
    assert build.library_path("k.cu") != first
    assert first.parent == build.BUILD_DIR and first.suffix == ".so"


# (frames, C_in, C_out): the six block shapes at NM=256 (the 128-clip
# training batch) and the GPU tests' tile edges (frames not a multiple of 5
# or 2, one frame, C_in = 3, 20 and 136, C_out = 33, 40 and 72)
PLAN_SHAPES = [(76800, 3, 64), (76800, 64, 64), (76800, 64, 128),
               (38400, 128, 128), (38400, 128, 256), (19200, 256, 256),
               (21, 3, 64), (1, 16, 32), (21, 20, 40), (20, 136, 72),
               (5, 16, 33), (18, 256, 256)]


@pytest.mark.parametrize("frames,c_in,c_out", PLAN_SHAPES)
def test_f32_tiles_cover_every_frame_by_the_shapes_alone(frames, c_in,
                                                         c_out):
    """The f32 kernels' plans: the stats workspace has one row per 5-frame
    tile (``forward_tiles``), and the dW kernel's splits (``backward_splits``)
    cut the 2-frame chunks into contiguous, non-empty ranges that cover
    every frame once, as the kernel computes them (``chunks * s //
    splits``). Both are functions of the shapes alone, so the sums' order,
    and with it the result, is the same from launch to launch."""
    tiles = sgcn.forward_tiles(frames, torch.float32)
    assert (tiles - 1) * 5 < frames <= tiles * 5
    splits = sgcn.backward_splits(frames, c_in, c_out, torch.float32)
    assert splits == sgcn.backward_splits(frames, c_in, c_out,
                                          torch.float32)
    chunks = -(-frames // 2)
    bounds = [chunks * s // splits for s in range(splits + 1)]
    assert bounds[0] == 0 and bounds[-1] == chunks
    assert all(lo < hi for lo, hi in zip(bounds, bounds[1:]))
    covered = [f for lo, hi in zip(bounds, bounds[1:])
               for f in range(2 * lo, min(2 * hi, frames))]
    assert covered == list(range(frames))
