"""The CUDA spatial graph-conv kernel against its plain version, on the card.

Marked ``gpu``: each test skips where there is no CUDA device. The file
imports neither jax nor the test configuration's jax setup, so on a
machine with a card and no jax it runs as

    python -m pytest --noconftest -p no:cacheprovider -m gpu \
        tests/test_torch_sgcn_gpu.py
"""

import pytest
import torch

from skeleton_action_recognition_tpu_torch.graphs.ntu_rgb_d import (
    spatial_adjacency,
)
from skeleton_action_recognition_tpu_torch.ops import sgcn

# (T, C_in, C_out) of the ten ST-GCN blocks' spatial convs
MODEL_SHAPES = [
    (300, 3, 64), (300, 64, 64), (300, 64, 128),
    (150, 128, 128), (150, 128, 256), (75, 256, 256),
]
# max |kernel - plain| / max |plain|. f32: both sum in f32 in other orders.
# bf16: both round z and the output to bf16 (8 significant bits) once, from
# sums taken in other orders, so single elements may differ by a bf16 ulp.
REL_TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _inputs(t, c_in, c_out, dtype, device, nm=4):
    g = torch.Generator(device=device).manual_seed(t + c_in + c_out)
    x = torch.randn(nm, t, 25, c_in, generator=g, device=device).to(dtype)
    w = torch.randn(3 * c_out, c_in, generator=g, device=device)
    w = w * (2.0 / c_in) ** 0.5
    b = torch.randn(3 * c_out, generator=g, device=device)
    a = torch.from_numpy(spatial_adjacency()).to(device)
    return x, w, b, a


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("t,c_in,c_out", MODEL_SHAPES)
def test_kernel_matches_plain_version(cuda, t, c_in, c_out, dtype):
    x, w, b, a = _inputs(t, c_in, c_out, dtype, cuda)
    before = sgcn.fused_graph_conv.launches
    got = sgcn.fused_graph_conv(x, w, b, a)
    torch.cuda.synchronize()
    assert sgcn.fused_graph_conv.launches == before + 1
    want = sgcn.graph_conv_reference(x, w, b, a)
    assert got.dtype == dtype and got.shape == want.shape
    err = (got.float() - want.float()).abs().max().item()
    assert err <= REL_TOL[dtype] * want.float().abs().max().item()


@pytest.mark.gpu
def test_kernel_takes_a_partial_last_block(cuda):
    """An odd number of frames and a C_out that is no multiple of the
    kernel's channel tile."""
    x, w, b, a = _inputs(7, 20, 40, torch.float32, cuda, nm=3)
    got = sgcn.fused_graph_conv(x, w, b, a)
    want = sgcn.graph_conv_reference(x, w, b, a)
    err = (got - want).abs().max().item()
    assert err <= 1e-5 * want.abs().max().item()


@pytest.mark.gpu
def test_kernel_rejects_a_strided_input(cuda):
    x, w, b, a = _inputs(8, 16, 16, torch.float32, cuda)
    with pytest.raises(ValueError):
        sgcn.fused_graph_conv(x[:, ::2], w, b, a)
