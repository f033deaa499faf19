"""The CUDA spline radar kernels (#6 forward, #7 backward) against their
plain versions, on the card.

Marked ``gpu``: each test skips where there is no CUDA device. The file
imports neither jax nor the test configuration's jax setup, so on a
machine with a card and no jax it runs as

    python -m pytest --noconftest -p no:cacheprovider -m gpu \
        tests/test_torch_radar_gpu.py
"""

import numpy as np
import pytest
import torch

from skeleton_action_recognition_tpu_torch.ops import radar

# kernel vs plain, max |diff| / max |plain|. At lambda = 5e-4 the phase is
# ~1e4 rad and the two evaluate the cubic in other orders, which moves it
# by ~1e-3 rad: 2e-3 for the return and 1e-2 for the cotangents (the JAX
# package's Pallas-vs-XLA tolerances). At lambda = 10 both agree to f32
# rounding of sums over up to 57.6 M terms in other orders: 1e-4.
TOL = {5e-4: (2e-3, 1e-2), 10.0: (1e-4, 1e-4)}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def kernel_inputs(n, t_in, up, lam, device, tile=radar.TILE, seed=0):
    """The spline kernels' inputs for seeded skeleton-like clips (``normal
    x 0.3``, the second body of the last clip all zero): ``(e, src, dst,
    c, loc, lam, t_out)``."""
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(n, 3, t_in, 25, 2)) * 0.3).astype(np.float32)
    x[-1, ..., 1] = 0.0
    x = torch.from_numpy(x).to(device)
    e, ts, td, c, t_out = radar.spline_inputs(x, up, tile=tile)
    loc = torch.tensor([0.1, -0.2, 0.3], device=device)
    return e, ts, td, c, loc, torch.tensor(lam, device=device), t_out


def _rel(p, q):
    return ((p - q).abs().max() / q.abs().max().clamp_min(1e-30)).item()


@pytest.mark.gpu
@pytest.mark.parametrize("lam", [5e-4, 10.0])
@pytest.mark.parametrize("t_in,up,tile", [(30, 20, 128), (30, 20, 256),
                                          (300, 250, 512)])
def test_forward_kernel_matches_plain_version(cuda, t_in, up, tile, lam):
    args = kernel_inputs(2, t_in, up, lam, cuda, tile)
    before = radar.spline_radar.launches
    re, im = radar.spline_radar(*args)
    torch.cuda.synchronize()
    assert radar.spline_radar.launches == before + 1
    want = radar.spline_radar_reference(*args)
    for got, ref in zip((re, im), want):
        assert got.shape == ref.shape == (2, t_in * up)
        assert _rel(got, ref) <= TOL[lam][0]


@pytest.mark.gpu
@pytest.mark.parametrize("lam", [5e-4, 10.0])
@pytest.mark.parametrize("t_in,up,tile", [(30, 20, 128), (30, 20, 256),
                                          (300, 250, 512)])
def test_backward_kernel_matches_plain_version(cuda, t_in, up, tile, lam):
    args = kernel_inputs(2, t_in, up, lam, cuda, tile)
    g = torch.randn(2, 2, t_in * up, device=cuda,
                    generator=torch.Generator(cuda).manual_seed(1))
    before = radar.spline_radar_backward.launches
    got = radar.spline_radar_backward(*args[:6], g[0], g[1], args[6])
    torch.cuda.synchronize()
    assert radar.spline_radar_backward.launches == before + 1
    want = radar.spline_radar_backward_reference(*args[:6], g[0], g[1],
                                                 args[6])
    for name, p, q in zip(("dsrc", "ddst", "dc", "dloc", "dlam"), got, want):
        assert p.shape == q.shape, name
        assert torch.isfinite(p).all(), name
        assert _rel(p, q) <= TOL[lam][1], (name, _rel(p, q))


@pytest.mark.gpu
def test_backward_kernel_repeats_bit_for_bit(cuda):
    """No float atomics: two launches on the same inputs agree exactly."""
    args = kernel_inputs(3, 300, 250, 5e-4, cuda)
    g = torch.randn(2, 3, 75000, device=cuda,
                    generator=torch.Generator(cuda).manual_seed(2))
    first = radar.spline_radar_backward(*args[:6], g[0], g[1], args[6])
    second = radar.spline_radar_backward(*args[:6], g[0], g[1], args[6])
    for p, q in zip(first, second):
        assert torch.equal(p, q)


@pytest.mark.gpu
def test_empty_bodies_give_finite_gradients(cuda):
    """All-zero bodies (c = 0, zero norms) take the guards of the
    backward: no NaN, where autograd through the plain forward has one."""
    x = torch.zeros(2, 3, 30, 25, 2, device=cuda)
    x[0, ..., 0] = 0.3 * torch.randn(3, 30, 25, device=cuda)
    x.requires_grad_()
    loc = torch.tensor([0.1, -0.2, 0.3], device=cuda, requires_grad=True)
    lam = torch.tensor(5e-4, device=cuda, requires_grad=True)
    re, im = radar.radar_return_spline(x, 20, loc, lam, tile=128)
    (re * re + im * im).sum().backward()
    for grad in (x.grad, loc.grad, lam.grad):
        assert torch.isfinite(grad).all()


@pytest.mark.gpu
def test_autograd_function_launches_both_kernels(cuda):
    x = torch.randn(2, 3, 30, 25, 2, device=cuda).mul_(0.3).requires_grad_()
    lam = torch.tensor(10.0, device=cuda, requires_grad=True)
    fwd = radar.spline_radar.launches
    bwd = radar.spline_radar_backward.launches
    re, im = radar.radar_return_spline(x, 20, torch.zeros(3, device=cuda),
                                       lam, tile=128)
    (re.sum() + im.sum()).backward()
    torch.cuda.synchronize()
    assert radar.spline_radar.launches == fwd + 1
    assert radar.spline_radar_backward.launches == bwd + 1
    assert torch.isfinite(x.grad).all() and torch.isfinite(lam.grad)


@pytest.mark.gpu
def test_kernels_reject_a_strided_input(cuda):
    e, ts, td, c, loc, lam, t_out = kernel_inputs(2, 30, 20, 5e-4, cuda, 128)
    wide = torch.cat([ts, ts], -1)[..., ::2]
    with pytest.raises(ValueError, match="contiguous"):
        radar.spline_radar(e, wide, td, c, loc, lam, t_out)


@pytest.mark.gpu
def test_virtual_radar_refuses_tf32_matmuls(cuda):
    """TF32 would round the spline positions to ~1e-3 and the phase to
    noise; the layer raises instead of differing silently."""
    from skeleton_action_recognition_tpu_torch.models import spectrogram

    layer = spectrogram.VirtualRadar(num_pad_frames=20, use_pallas=True,
                                     use_pallas_stft=True).to(cuda)
    x = torch.randn(1, 3, 30, 25, 2, device=cuda)
    before = torch.backends.cuda.matmul.allow_tf32
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        with pytest.raises(ValueError, match="allow_tf32"):
            layer(x)
        torch.backends.cuda.matmul.allow_tf32 = False
        assert layer(x).shape == (1, 256, 38)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before
