"""The CUDA STFT log-magnitude kernels (#10 forward, #11 backward) against
their plain versions, on the card.

Marked ``gpu``: each test skips where there is no CUDA device. The file
imports neither jax nor the test configuration's jax setup, so on a
machine with a card and no jax it runs as

    python -m pytest --noconftest -p no:cacheprovider -m gpu \
        tests/test_torch_stft_gpu.py
"""

import pytest
import torch

from skeleton_action_recognition_tpu_torch.ops import stft, stft_logmag

N_FFT, HOP = 256, 16
# kernel vs plain: f32 sums of 256 products in other orders, then a log
# whose error grows as 1/|S| at the smallest bins; the forward to 5e-4
# absolute (see tests/test_torch_stft.py), the gradient to 1e-3 of its
# largest.
ATOL, GRAD_TOL = 5e-4, 1e-3


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _inputs(n, t, device, seed=0):
    g = torch.Generator(device).manual_seed(seed)
    re = torch.randn(n, t, device=device, generator=g)
    im = torch.randn(n, t, device=device, generator=g)
    cos, sin = (torch.from_numpy(b).to(device) for b in stft.stft_basis(N_FFT))
    return re, im, cos, sin


@pytest.mark.gpu
@pytest.mark.parametrize("t", [130, 600, 3000, 9000, 75000])
def test_forward_kernel_matches_plain_version(cuda, t):
    re, im, cos, sin = _inputs(2, t, cuda)
    before = stft_logmag.stft_logmag.launches
    got = stft_logmag.stft_logmag(re, im, HOP, cos, sin)
    torch.cuda.synchronize()
    assert stft_logmag.stft_logmag.launches == before + 1
    want = stft_logmag.stft_logmag_reference(re, im, HOP, cos, sin)
    assert got.shape == want.shape == (2, N_FFT, t // HOP + 1)
    assert (got - want).abs().max().item() <= ATOL


@pytest.mark.gpu
def test_forward_kernel_without_shift_or_center(cuda):
    re, im, cos, sin = _inputs(1, 4096, cuda)
    kw = dict(fftshift=False, center=False)
    got = stft_logmag.stft_logmag(re, im, HOP, cos, sin, **kw)
    want = stft_logmag.stft_logmag_reference(re, im, HOP, cos, sin, **kw)
    assert (got - want).abs().max().item() <= ATOL


@pytest.mark.gpu
@pytest.mark.parametrize("t", [130, 600, 3000, 9000, 75000])
def test_backward_kernel_matches_plain_version(cuda, t):
    re, im, cos, sin = _inputs(2, t, cuda)
    g = torch.randn(2, N_FFT, t // HOP + 1, device=cuda,
                    generator=torch.Generator(cuda).manual_seed(1))
    before = stft_logmag.stft_logmag_backward.launches
    got = stft_logmag.stft_logmag_backward(re, im, HOP, cos, sin, g)
    torch.cuda.synchronize()
    assert stft_logmag.stft_logmag_backward.launches == before + 1
    want = stft_logmag.stft_logmag_backward_reference(re, im, HOP, cos, sin,
                                                      g)
    for p, q in zip(got, want):
        assert p.shape == q.shape
        err = (p - q).abs().max().item()
        assert err <= GRAD_TOL * q.abs().max().item()


@pytest.mark.gpu
def test_backward_kernel_repeats_bit_for_bit(cuda):
    re, im, cos, sin = _inputs(4, 75000, cuda)
    g = torch.randn(4, N_FFT, 4688, device=cuda,
                    generator=torch.Generator(cuda).manual_seed(2))
    first = stft_logmag.stft_logmag_backward(re, im, HOP, cos, sin, g)
    second = stft_logmag.stft_logmag_backward(re, im, HOP, cos, sin, g)
    for p, q in zip(first, second):
        assert torch.equal(p, q)


@pytest.mark.gpu
def test_kernel_path_raises_on_a_short_signal(cuda):
    """T <= n_fft / 2 + 1 would need a second reflection, which the
    backward's fold does not take: the kernel path refuses it rather than
    differ silently."""
    re, im, cos, sin = _inputs(1, 129, cuda)
    with pytest.raises(ValueError, match="n_fft / 2"):
        stft_logmag.stft_logmag(re, im, HOP, cos, sin)


@pytest.mark.gpu
def test_autograd_function_launches_both_kernels(cuda):
    re, im, cos, sin = _inputs(2, 600, cuda)
    re.requires_grad_(), im.requires_grad_()
    fwd = stft_logmag.stft_logmag.launches
    bwd = stft_logmag.stft_logmag_backward.launches
    stft_logmag.stft_logmag(re, im, HOP, cos, sin).sum().backward()
    torch.cuda.synchronize()
    assert stft_logmag.stft_logmag.launches == fwd + 1
    assert stft_logmag.stft_logmag_backward.launches == bwd + 1
    assert torch.isfinite(re.grad).all() and torch.isfinite(im.grad).all()


@pytest.mark.gpu
@pytest.mark.parametrize("op", ["stft_real", "stft_complex",
                                "virtual_radar_spectrogram"])
def test_frame_matmul_ignores_the_tf32_switch(cuda, op):
    """The STFT's basis contraction is float32 exact on both passes (the
    JAX package pins it at HIGHEST): the same output and input gradient
    with TF32 allowed as without."""
    from test_torch_radar_gpu import _assert_same_with_tf32_on, _clips

    from skeleton_action_recognition_tpu_torch.ops import virtual_radar

    re, im, cos, sin = _inputs(2, 600, cuda)
    if op == "stft_real":
        _assert_same_with_tf32_on(
            lambda r: stft.stft_real(r, HOP, cos, sin), re)
    elif op == "stft_complex":
        _assert_same_with_tf32_on(
            lambda r, i: stft.stft_complex(r, i, HOP, cos, sin), re, im)
    else:
        loc = torch.tensor([0.1, -0.2, 0.3], device=cuda)
        _assert_same_with_tf32_on(
            lambda x, l: (virtual_radar.virtual_radar_spectrogram(
                x, l, torch.tensor(10.0, device=cuda)),),
            _clips(cuda), loc)
