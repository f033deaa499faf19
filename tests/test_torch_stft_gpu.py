"""The CUDA STFT log-magnitude kernels (#10 forward, #11 backward) against
their plain versions evaluated in float64, on the card.

Marked ``gpu``: each test skips where there is no CUDA device. The file
imports neither jax nor the test configuration's jax setup, so on a
machine with a card and no jax it runs as

    python -m pytest --noconftest -p no:cacheprovider -m gpu \
        tests/test_torch_stft_gpu.py
"""

import numpy as np
import pytest
import torch

from skeleton_action_recognition_tpu_torch import tracing
from skeleton_action_recognition_tpu_torch.ops import stft, stft_logmag

N_FFT, HOP = 256, 16
# kernel vs the plain version in float64: an f32 FFT of 256 points, then a
# log whose error grows as 1/|S| at the smallest bins; the forward to 5e-4
# absolute (see tests/test_torch_stft.py), the gradient to 1e-3 of its
# largest.
ATOL, GRAD_TOL = 5e-4, 1e-3


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _inputs(n, t, device, seed=0, n_fft=N_FFT, f=None):
    g = torch.Generator(device).manual_seed(seed)
    re = torch.randn(n, t, device=device, generator=g)
    im = torch.randn(n, t, device=device, generator=g)
    cos, sin = (torch.from_numpy(b).to(device)
                for b in stft.stft_basis(n_fft, f))
    return re, im, cos, sin


def _f64(re, im, cos, g=None, hop=HOP, **kw):
    """The plain version of #10 (or, given ``g``, of #11) in float64: the
    inputs promoted, the bases rebuilt by ``stft_basis`` in float64; the
    result in f32."""
    f, n_fft = cos.shape
    c64, s64 = (torch.from_numpy(b).to(re.device)
                for b in stft.stft_basis(n_fft, f, dtype=np.float64))
    args = (re.double(), im.double(), hop, c64, s64)
    if g is None:
        return stft_logmag.stft_logmag_reference(*args, **kw).float()
    return tuple(d.float() for d in stft_logmag.stft_logmag_backward_reference(
        *args, g.double(), **kw))


@pytest.mark.gpu
@pytest.mark.parametrize("t", [130, 600, 3000, 9000, 75000])
def test_forward_kernel_matches_plain_version(cuda, t):
    re, im, cos, sin = _inputs(2, t, cuda)
    before = tracing.counters()["launch.stft_fwd"]
    got = stft_logmag.stft_logmag(re, im, HOP, cos, sin)
    torch.cuda.synchronize()
    assert tracing.counters()["launch.stft_fwd"] == before + 1
    want = _f64(re, im, cos)
    assert got.shape == want.shape == (2, N_FFT, t // HOP + 1)
    assert (got - want).abs().max().item() <= ATOL


@pytest.mark.gpu
def test_forward_kernel_without_shift_or_center(cuda):
    re, im, cos, sin = _inputs(1, 4096, cuda)
    kw = dict(fftshift=False, center=False)
    got = stft_logmag.stft_logmag(re, im, HOP, cos, sin, **kw)
    want = _f64(re, im, cos, **kw)
    assert (got - want).abs().max().item() <= ATOL


@pytest.mark.gpu
@pytest.mark.parametrize("t", [130, 600, 3000, 9000, 75000])
def test_backward_kernel_matches_plain_version(cuda, t):
    re, im, cos, sin = _inputs(2, t, cuda)
    g = torch.randn(2, N_FFT, t // HOP + 1, device=cuda,
                    generator=torch.Generator(cuda).manual_seed(1))
    before = tracing.counters()["launch.stft_bwd"]
    got = stft_logmag.stft_logmag_backward(re, im, HOP, cos, sin, g)
    torch.cuda.synchronize()
    assert tracing.counters()["launch.stft_bwd"] == before + 1
    want = _f64(re, im, cos, g)
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
def test_forward_kernel_repeats_bit_for_bit(cuda):
    re, im, cos, sin = _inputs(4, 75000, cuda)
    first = stft_logmag.stft_logmag(re, im, HOP, cos, sin)
    assert torch.equal(first, stft_logmag.stft_logmag(re, im, HOP, cos, sin))


@pytest.mark.gpu
@pytest.mark.parametrize("n_fft,hop,f,t", [
    (64, 16, 64, 3000), (512, 16, 512, 9000), (256, 16, 100, 3000),
    (512, 32, 300, 9000), (64, 64, 40, 2000), (1024, 256, 1024, 9000)])
def test_kernels_at_other_sizes(cuda, n_fft, hop, f, t):
    """n_fft 64 and 512 (radix plans 16 x 4 and 16 x 16 x 2) and 1024, F <
    n_fft (the first F bins, rolled by F // 2), hop up to n_fft."""
    re, im, cos, sin = _inputs(2, t, cuda, n_fft=n_fft, f=f)
    frames = t // hop + 1
    g = torch.randn(2, f, frames, device=cuda,
                    generator=torch.Generator(cuda).manual_seed(3))
    got = stft_logmag.stft_logmag(re, im, hop, cos, sin)
    got_bwd = stft_logmag.stft_logmag_backward(re, im, hop, cos, sin, g)
    want = _f64(re, im, cos, hop=hop)
    assert got.shape == want.shape == (2, f, frames)
    assert (got - want).abs().max().item() <= ATOL
    for p, q in zip(got_bwd, _f64(re, im, cos, g, hop=hop)):
        assert (p - q).abs().max().item() <= GRAD_TOL * q.abs().max().item()


@pytest.mark.gpu
def test_kernel_path_raises_on_bases_it_does_not_take(cuda):
    """Bases that are not windowed Fourier bases, and an n_fft that is not a
    power of two, raise on CUDA; nothing gives way to the plain version."""
    re, im, cos, sin = _inputs(1, 3000, cuda)
    bent = cos.clone()
    bent[5, 7] += 1e-3
    before = tracing.counters()["launch.stft_fwd"]
    with pytest.raises(ValueError, match="Fourier bases"):
        stft_logmag.stft_logmag(re, im, HOP, bent, sin)
    g = torch.zeros(1, N_FFT, 3000 // HOP + 1, device=cuda)
    with pytest.raises(ValueError, match="Fourier bases"):
        stft_logmag.stft_logmag_backward(re, im, HOP, cos, -sin, g)
    c192, s192 = _inputs(1, 3000, cuda, n_fft=192)[2:]
    with pytest.raises(ValueError, match="power-of-two"):
        stft_logmag.stft_logmag(re, im, HOP, c192, s192)
    assert tracing.counters()["launch.stft_fwd"] == before


@pytest.mark.gpu
def test_forward_kernel_agrees_with_torch_stft(cuda):
    """#10's magnitudes are torch.stft's (cuFFT: centered, reflect-padded,
    two-sided) up to the roll by n_fft / 2, to 1e-5 of the largest."""
    re, im, cos, sin = _inputs(2, 9000, cuda)
    got = stft_logmag.stft_logmag(re, im, HOP, cos, sin)
    spec = torch.stft(torch.complex(re, im), N_FFT, hop_length=HOP,
                      window=cos[0], center=True, pad_mode="reflect",
                      onesided=False, return_complex=True)
    want = torch.roll(spec.abs(), N_FFT // 2, 1) + 1e-6
    assert got.shape == want.shape
    assert (got.exp() - want).abs().max() <= 1e-5 * want.abs().max()


@pytest.mark.gpu
def test_backward_kernel_allocates_no_workspace(cuda):
    """#11 allocates its outputs and the padding's small edge buffer, not
    the (N, frames, 2F) and (N, frames, 2 n_fft) workspaces of a DFT
    product (75 MB here): what the call held at its peak beyond the
    outputs it returns (which the allocator may round up by a cached
    block) stays under 1 MiB."""
    re, im, cos, sin = _inputs(4, 75000, cuda)
    g = torch.randn(4, N_FFT, 4688, device=cuda,
                    generator=torch.Generator(cuda).manual_seed(4))
    stft_logmag.stft_logmag_backward(re, im, HOP, cos, sin, g)  # caches
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    dre, dim = stft_logmag.stft_logmag_backward(re, im, HOP, cos, sin, g)
    torch.cuda.synchronize()
    held = torch.cuda.max_memory_allocated() - torch.cuda.memory_allocated()
    assert held <= 2**20


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
    fwd = tracing.counters()["launch.stft_fwd"]
    bwd = tracing.counters()["launch.stft_bwd"]
    stft_logmag.stft_logmag(re, im, HOP, cos, sin).sum().backward()
    torch.cuda.synchronize()
    assert tracing.counters()["launch.stft_fwd"] == fwd + 1
    assert tracing.counters()["launch.stft_bwd"] == bwd + 1
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
