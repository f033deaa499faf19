"""CTR-GCN's channel-wise aggregation kernels (``csrc/ctrgc_fwd.cu``,
``csrc/ctrgc_bwd.cu``) against their plain version, on the card: forward
and backward, f32 and bf16, at the shapes of the 64-frame cell's ten
blocks and at the edges of the tile (ragged frames, joints that need
padding, one clip, the 300-frame clips of the CLI).

Marked ``gpu``: each test skips where there is no CUDA device. The file
imports neither jax nor the test configuration's jax setup, so on a
machine with a card and no jax it runs as

    python -m pytest --noconftest -p no:cacheprovider -m gpu \\
        tests/test_torch_ctrgc_gpu.py
"""

import pytest
import torch

from skeleton_action_recognition_tpu_torch import tracing
from skeleton_action_recognition_tpu_torch.models import ctrgcn
from skeleton_action_recognition_tpu_torch.ops import ctrgc

DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}
# (N, K, C, T, V): the cell's ten blocks at NM = 256 (four shapes), and
# the edges
SHAPES = [(256, 3, 64, 64, 25), (256, 3, 128, 64, 25),
          (256, 3, 128, 32, 25), (256, 3, 256, 16, 25),
          (1, 3, 3, 5, 25), (2, 3, 7, 30, 18), (3, 2, 5, 7, 7),
          (2, 3, 64, 300, 25)]
# kernel vs plain (both sum in f32, in other orders), |diff| over the
# largest |plain| of the tensor: f32 sums of up to 75 (z), 25 (dx3) and
# 300 (ds) terms; bf16 z and dx3 rounded once (2^-8) from sums that
# differ in their last f32 bits, so an element may sit one bf16 ulp away
TOL = {"f32": 1e-5, "bf16": 2**-7}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def operands(shape, dtype, device, seed=0):
    n, k, c, t, v = shape
    g = torch.Generator(device=device).manual_seed(seed)
    x3 = torch.randn(shape, generator=g, device=device).to(dtype)
    s = torch.randn((n, k, c, v, v), generator=g, device=device)
    dz = torch.randn((n, c, t, v), generator=g, device=device).to(dtype)
    return x3, s, dz


def rel(got, want):
    want = want.float()
    return ((got.float() - want).abs().max()
            / want.abs().max().clamp_min(1e-30)).item()


@pytest.mark.gpu
@pytest.mark.parametrize("name", list(DTYPES))
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_kernels_match_plain(cuda, shape, name):
    dtype = DTYPES[name]
    x3, s, dz = operands(shape, dtype, cuda)
    before = tracing.counters()
    z = ctrgc._forward(x3, s)
    dx3, ds = ctrgc._backward(dz, x3, s)
    after = tracing.counters()
    assert after["launch.ctrgc_fwd"] - before["launch.ctrgc_fwd"] == 1
    assert after["launch.ctrgc_bwd"] - before["launch.ctrgc_bwd"] == 1
    want_z = ctrgc.channel_aggregate_reference(x3, s)
    want_dx3, want_ds = ctrgc.channel_aggregate_backward_reference(dz, x3, s)
    assert z.dtype == dtype and dx3.dtype == dtype
    assert ds.dtype == torch.float32
    errs = {"z": rel(z, want_z), "dx3": rel(dx3, want_dx3),
            "ds": rel(ds, want_ds)}
    tol = {"z": TOL[name], "dx3": TOL[name], "ds": TOL["f32"]}
    assert all(errs[k] <= tol[k] for k in errs), errs
    # repeats are bit-identical
    assert torch.equal(ctrgc._forward(x3, s), z)
    dx3_again, ds_again = ctrgc._backward(dz, x3, s)
    assert torch.equal(dx3_again, dx3) and torch.equal(ds_again, ds)


@pytest.mark.gpu
def test_autograd_launches_one_kernel_each_way(cuda):
    x3, s, dz = operands((4, 3, 16, 12, 25), torch.bfloat16, cuda)
    x3.requires_grad_(True)
    s.requires_grad_(True)
    before = tracing.counters()
    z = ctrgc.channel_aggregate(x3, s)
    z.backward(dz)
    after = tracing.counters()
    assert after["launch.ctrgc_fwd"] - before["launch.ctrgc_fwd"] == 1
    assert after["launch.ctrgc_bwd"] - before["launch.ctrgc_bwd"] == 1
    want_dx3, want_ds = ctrgc.channel_aggregate_backward_reference(
        dz, x3.detach(), s.detach())
    assert rel(x3.grad, want_dx3) <= TOL["bf16"]
    assert rel(s.grad, want_ds) <= TOL["f32"]


@pytest.mark.gpu
def test_model_step_launches_ten_each_way(cuda):
    """A training step of the full model at remat off: one forward and one
    backward launch a block."""
    model = ctrgcn.Model(num_classes=60, dtype=torch.bfloat16, remat=False,
                         device=cuda,
                         generator=torch.Generator().manual_seed(0))
    x = torch.randn(2, 3, 64, 25, 2, device=cuda)
    before = tracing.counters()
    model(x).sum().backward()
    after = tracing.counters()
    assert after["launch.ctrgc_fwd"] - before["launch.ctrgc_fwd"] == 10
    assert after["launch.ctrgc_bwd"] - before["launch.ctrgc_bwd"] == 10
