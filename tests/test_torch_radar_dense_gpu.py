"""The CUDA dense-operator radar kernels (#8 forward, #9 backward) against
their plain versions, on the card.

Marked ``gpu``: each test skips where there is no CUDA device. The file
imports neither jax nor the test configuration's jax setup, so on a
machine with a card and no jax it runs as

    python -m pytest --noconftest -p no:cacheprovider -m gpu \
        tests/test_torch_radar_dense_gpu.py
"""

import numpy as np
import pytest
import torch

from skeleton_action_recognition_tpu_torch.ops import radar, resample

# kernel vs plain, max |diff| / max |plain|. At lambda = 5e-4 the phase is
# ~2.5e4 rad a metre and the two sum the positions' T_in terms in other
# orders, which moves the phase by ~1e-3 rad: 2e-3 for the return and 1e-2
# for the cotangents (the JAX package's Pallas-vs-XLA tolerances). At
# lambda = 10 both agree to f32 rounding: 1e-4.
TOL = {5e-4: (2e-3, 1e-2), 10.0: (1e-4, 1e-4)}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False  # f32 plain versions
    return torch.device("cuda")


def clips(n, t_in, device, seed=0):
    """Seeded skeleton-like clips ``(n, 3, t_in, 25, 2)`` (``normal x
    0.3``), the second body of the last clip all zero."""
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(n, 3, t_in, 25, 2)) * 0.3).astype(np.float32)
    x[-1, ..., 1] = 0.0
    return torch.from_numpy(x).to(device)


def kernel_inputs(n, t_in, up, lam, device, tile=radar.TILE, seed=0):
    """The dense kernels' inputs for seeded clips: ``(w, src, dst, c, loc,
    lam, t_out)``, ``w`` padded to a multiple of ``tile`` rows as
    ``radar_return_fused`` pads it."""
    x = clips(n, t_in, device, seed)
    w = torch.from_numpy(resample.pad_frames_operator(t_in, up)).to(device)
    t_out = w.shape[0]
    src, dst = radar.gather_features(x, radar.RADAR_EDGES)
    c = radar.bone_length_mean_sq(x, w, tile=tile)
    w = torch.nn.functional.pad(w, (0, 0, 0, -(-t_out // tile) * tile - t_out))
    loc = torch.tensor([0.1, -0.2, 0.3], device=device)
    return w, src, dst, c, loc, torch.tensor(lam, device=device), t_out


def _rel(p, q):
    return ((p - q).abs().max() / q.abs().max().clamp_min(1e-30)).item()


SHAPES = [(30, 20, 128), (30, 20, 256), (300, 250, 512)]


@pytest.mark.gpu
@pytest.mark.parametrize("lam", [5e-4, 10.0])
@pytest.mark.parametrize("t_in,up,tile", SHAPES)
def test_forward_kernel_matches_plain_version(cuda, t_in, up, tile, lam):
    args = kernel_inputs(2, t_in, up, lam, cuda, tile)
    before = radar.dense_radar.launches
    re, im = radar.dense_radar(*args)
    torch.cuda.synchronize()
    assert radar.dense_radar.launches == before + 1
    want = radar.dense_radar_reference(*args)
    for got, ref in zip((re, im), want):
        assert got.shape == ref.shape == (2, t_in * up)
        assert _rel(got, ref) <= TOL[lam][0]


@pytest.mark.gpu
@pytest.mark.parametrize("lam", [5e-4, 10.0])
@pytest.mark.parametrize("t_in,up,tile", SHAPES)
def test_backward_kernel_matches_plain_version(cuda, t_in, up, tile, lam):
    args = kernel_inputs(2, t_in, up, lam, cuda, tile)
    g = torch.randn(2, 2, t_in * up, device=cuda,
                    generator=torch.Generator(cuda).manual_seed(1))
    before = radar.dense_radar_backward.launches
    got = radar.dense_radar_backward(*args[:6], g[0], g[1], args[6])
    torch.cuda.synchronize()
    assert radar.dense_radar_backward.launches == before + 1
    want = radar.dense_radar_backward_reference(*args[:6], g[0], g[1],
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
    first = radar.dense_radar_backward(*args[:6], g[0], g[1], args[6])
    second = radar.dense_radar_backward(*args[:6], g[0], g[1], args[6])
    for p, q in zip(first, second):
        assert torch.equal(p, q)


@pytest.mark.gpu
@pytest.mark.parametrize("loc", [[0.1, -0.2, 0.3], [0.0, 0.0, 0.0]])
def test_empty_bodies_give_finite_gradients(cuda, loc):
    """All-zero bodies (c = 0, zero norms; at loc = 0 a zero distance too)
    take the guards of the backward: no NaN, where autograd through the
    plain forward has one. tile 256 does not divide T_out = 600."""
    x = torch.zeros(2, 3, 30, 25, 2, device=cuda)
    x[0, ..., 0] = 0.3 * torch.randn(3, 30, 25, device=cuda)
    x.requires_grad_()
    w = torch.from_numpy(resample.pad_frames_operator(30, 20)).to(cuda)
    loc = torch.tensor(loc, device=cuda, requires_grad=True)
    lam = torch.tensor(5e-4, device=cuda, requires_grad=True)
    re, im = radar.radar_return_fused(x, w, loc, lam, tile=256)
    (re * re + im * im).sum().backward()
    for grad in (x.grad, loc.grad, lam.grad):
        assert torch.isfinite(grad).all()


@pytest.mark.gpu
def test_autograd_function_launches_both_kernels(cuda):
    x = clips(2, 30, cuda).requires_grad_()
    w = torch.from_numpy(resample.pad_frames_operator(30, 20)).to(cuda)
    lam = torch.tensor(10.0, device=cuda, requires_grad=True)
    fwd = radar.dense_radar.launches
    bwd = radar.dense_radar_backward.launches
    re, im = radar.radar_return_fused(x, w, torch.zeros(3, device=cuda), lam,
                                      tile=128)
    (re.sum() + im.sum()).backward()
    torch.cuda.synchronize()
    assert radar.dense_radar.launches == fwd + 1
    assert radar.dense_radar_backward.launches == bwd + 1
    assert torch.isfinite(x.grad).all() and torch.isfinite(lam.grad)


@pytest.mark.gpu
def test_kernels_reject_a_strided_input(cuda):
    w, src, dst, c, loc, lam, t_out = kernel_inputs(2, 30, 20, 5e-4, cuda,
                                                    128)
    wide = torch.cat([src, src], -1)[..., ::2]
    with pytest.raises(ValueError, match="contiguous"):
        radar.dense_radar(w, wide, dst, c, loc, lam, t_out)
    g = torch.zeros(2, t_out, device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        radar.dense_radar_backward(w, src, dst, c, loc, lam,
                                   torch.zeros(2, 2 * t_out,
                                               device=cuda)[:, ::2], g,
                                   t_out)
