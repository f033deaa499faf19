"""The port's STFT (the plain route of :mod:`ops.stft` and the plain
versions of kernels #10/#11 in :mod:`ops.stft_logmag`) against the JAX
package's ``ops/stft.py`` and its Pallas ``stft_logmag`` (interpret mode on
the CPU, as the JAX package's own tests run it), at the production n_fft
256 and hop 16."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skeleton_action_recognition_tpu.ops import stft as jax_stft
from skeleton_action_recognition_tpu.ops.pallas import stft as jax_fused
from skeleton_action_recognition_tpu_torch import tracing
from skeleton_action_recognition_tpu_torch.ops import stft, stft_logmag
import torch_parity_helpers  # noqa: F401  (caps torch's threads)

N_FFT, HOP = 256, 16
# f32 basis contractions of 256 terms in other orders, then a log, whose
# error grows as 1/|S| at the smallest bins (down to 2e-4 of the largest on
# these inputs). The JAX package holds its Pallas kernel to its XLA route
# at 2e-4 (tests/test_pallas_stft.py), but on these inputs the two differ
# by 1.75e-4 at T = 9000, and the port's plain version (torch's CPU matmul,
# blocked otherwise) by 3.6e-4 from either: 5e-4.
ATOL = 5e-4
# the (re, im) gradients, relative to their largest. The gradient of log|S|
# carries 1/|S| as well: JAX's own Pallas and XLA backwards differ by
# 1.9e-4 of the scale at T = 9000 here, the port's plain version by 3.9e-4.
GRAD_TOL = 1e-3


def _signal(n, t, seed=11):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, t)).astype(np.float32),
            rng.normal(size=(n, t)).astype(np.float32))


def _bases():
    return tuple(torch.from_numpy(b) for b in stft.stft_basis(N_FFT))


def test_stft_basis_equals_jax():
    for got, want in zip(stft.stft_basis(N_FFT), jax_stft.stft_basis(N_FFT)):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("t,center", [(200, True), (3000, True),
                                      (3000, False)])
def test_stft_complex_and_log_magnitude_equal_jax(t, center):
    """The ``use_pallas_stft=False`` route; T = 200 < n_fft: the reflect
    padding as jnp.pad's at a short signal."""
    re, im = _signal(2, t)
    cos, sin = jax_stft.stft_basis(N_FFT)
    w_re, w_im = jax_stft.stft_complex(jnp.asarray(re), jnp.asarray(im), HOP,
                                       jnp.asarray(cos), jnp.asarray(sin),
                                       center=center)
    want = jax_stft.log_magnitude(w_re, w_im)
    g_re, g_im = stft.stft_complex(torch.from_numpy(re), torch.from_numpy(im),
                                   HOP, *_bases(), center=center)
    got = stft.log_magnitude(g_re, g_im)
    assert got.shape == want.shape
    scale = np.abs(np.asarray(w_re)).max()
    np.testing.assert_allclose(g_re.numpy(), np.asarray(w_re),
                               atol=1e-5 * scale)
    np.testing.assert_allclose(g_im.numpy(), np.asarray(w_im),
                               atol=1e-5 * scale)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


@pytest.mark.parametrize("pad", [3, 7, 12])
def test_reflect_pad_repeats_like_numpy(pad):
    """Reflect padding at least as long as the signal (which torch's own
    pad refuses) repeats the reflection as numpy and jnp.pad do."""
    x = np.arange(5, dtype=np.float32)[None]
    got = stft.reflect_pad(torch.from_numpy(x), pad)
    np.testing.assert_array_equal(got.numpy(),
                                  np.pad(x, ((0, 0), (pad, pad)), "reflect"))


@pytest.mark.parametrize("t", [3000, 9000])
def test_fused_forward_matches_jax(t):
    """Kernel #10's plain version against the JAX Pallas kernel."""
    re, im = _signal(2, t)
    cos, sin = jax_stft.stft_basis(N_FFT)
    want = jax_fused.stft_logmag(jnp.asarray(re), jnp.asarray(im), HOP,
                                 jnp.asarray(cos), jnp.asarray(sin))
    got = stft_logmag.stft_logmag(torch.from_numpy(re), torch.from_numpy(im),
                                  HOP, *_bases())
    assert got.shape == want.shape == (2, N_FFT, t // HOP + 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_fused_forward_without_shift_or_center():
    re, im = _signal(1, 4096)
    cos, sin = jax_stft.stft_basis(N_FFT)
    want = jax_fused.stft_logmag(jnp.asarray(re), jnp.asarray(im), HOP,
                                 jnp.asarray(cos), jnp.asarray(sin),
                                 fftshift=False, center=False)
    got = stft_logmag.stft_logmag(torch.from_numpy(re), torch.from_numpy(im),
                                  HOP, *_bases(), fftshift=False,
                                  center=False)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


@pytest.mark.parametrize("t", [3000, 9000])
def test_fused_gradients_match_jax(t):
    """Kernel #11's plain version (through the autograd Function) against
    the JAX Pallas backward, with a seeded upstream cotangent; both bases
    get a zero cotangent."""
    re, im = _signal(2, t)
    w = np.random.default_rng(3).normal(
        size=(2, N_FFT, t // HOP + 1)).astype(np.float32)
    cos, sin = jax_stft.stft_basis(N_FFT)
    jw = jnp.asarray(w)
    want = jax.grad(
        lambda re, im, c, s: jnp.sum(
            jax_fused.stft_logmag(re, im, HOP, c, s) * jw),
        argnums=(0, 1, 2, 3),
    )(jnp.asarray(re), jnp.asarray(im), jnp.asarray(cos), jnp.asarray(sin))
    tre = torch.tensor(re, requires_grad=True)
    tim = torch.tensor(im, requires_grad=True)
    tc, ts = (b.clone().requires_grad_() for b in _bases())
    (stft_logmag.stft_logmag(tre, tim, HOP, tc, ts)
     * torch.from_numpy(w)).sum().backward()
    for got, ref in zip((tre.grad, tim.grad), want):
        ref = np.asarray(ref)
        np.testing.assert_allclose(got.numpy(), ref,
                                   atol=GRAD_TOL * np.abs(ref).max())
    assert tc.grad.abs().max() == 0 and ts.grad.abs().max() == 0
    assert np.abs(np.asarray(want[2])).max() == 0


def test_plain_backward_equals_autograd_of_the_plain_route():
    """Kernel #11's plain version against autograd through
    ``stft_complex`` + ``log_magnitude`` (the XLA route's own gradient),
    at T = 600, the smallest radar signal of the tests."""
    re, im = _signal(2, 600, seed=5)
    g = torch.from_numpy(np.random.default_rng(6).normal(
        size=(2, N_FFT, 600 // HOP + 1)).astype(np.float32))
    tre = torch.tensor(re, requires_grad=True)
    tim = torch.tensor(im, requires_grad=True)
    cos, sin = _bases()
    (stft_logmag.stft_logmag_reference(tre, tim, HOP, cos, sin)
     * g).sum().backward()
    got = stft_logmag.stft_logmag_backward_reference(
        torch.from_numpy(re), torch.from_numpy(im), HOP, cos, sin, g)
    for p, q in zip(got, (tre.grad, tim.grad)):
        torch.testing.assert_close(p, q, rtol=1e-4,
                                   atol=1e-5 * q.abs().max().item())


def test_kernel_path_refuses_what_it_cannot_fold():
    """The kernel path raises on T <= n_fft / 2 + 1 when centered (its
    reflect fold holds for one reflection only, as the JAX backward's
    unpad) and on bases of sizes its FFTs do not take: an n_fft that is no
    power of two from 64 to 1024, or more bins than n_fft. Fewer bins are
    taken (the first F, as ``stft_basis(n_fft, F)`` makes them)."""
    cos, sin = _bases()
    with pytest.raises(ValueError, match="T > n_fft / 2 \\+ 1"):
        stft_logmag._plan(torch.zeros(1, 129), cos, HOP, True)
    stft_logmag._plan(torch.zeros(1, 130), cos, HOP, True)
    stft_logmag._plan(torch.zeros(1, 600), cos[:100], HOP, True)
    with pytest.raises(ValueError, match="power-of-two"):
        stft_logmag._plan(torch.zeros(1, 600), cos[:, :192], HOP, True)
    with pytest.raises(ValueError, match="F <= n_fft"):
        stft_logmag._plan(torch.zeros(1, 600), torch.cat([cos, cos]), HOP,
                          True)


@pytest.mark.parametrize("n_fft,f,window", [
    (256, None, "hann"), (256, None, "hamming"), (64, 40, "hann"),
    (1024, None, "hann"), (512, 300, "hamming")])
def test_fourier_window_takes_stft_basis(n_fft, f, window):
    """``stft_basis``'s bases, Hann or Hamming, all bins or the first F:
    the window is their first row, bit for bit."""
    cos, sin = (torch.from_numpy(b) for b in stft.stft_basis(n_fft, f, window))
    got = stft_logmag.fourier_window(cos, sin)
    assert torch.equal(got, cos[0])
    assert stft_logmag.fourier_window(cos, sin) is got  # kept


@pytest.mark.parametrize("change", ["cos entry", "sin entry", "sin sign",
                                    "swapped", "random"])
def test_fourier_window_raises_on_other_bases(change):
    """Bases the kernels would not reproduce: one entry off by 1e-5 (tens
    of ulps), sin with the other sign, cos and sin swapped, a random pair."""
    cos, sin = (b.clone() for b in _bases())
    if change == "cos entry":
        cos[3, 5] += 1e-5
    elif change == "sin entry":
        sin[200, 100] -= 1e-5
    elif change == "sin sign":
        sin = -sin
    elif change == "swapped":
        cos, sin = sin, cos
    else:
        gen = torch.Generator().manual_seed(0)
        cos, sin = (torch.randn(N_FFT, N_FFT, generator=gen)
                    for _ in range(2))
    with pytest.raises(ValueError, match="Fourier bases"):
        stft_logmag.fourier_window(cos, sin)


def test_fourier_window_raises_on_n_fft_192():
    cos, sin = (torch.from_numpy(b) for b in stft.stft_basis(192))
    with pytest.raises(ValueError, match="power-of-two"):
        stft_logmag.fourier_window(cos, sin)


def test_fourier_window_checks_bases_written_in_place():
    """A bases tensor written in place after its check is checked again
    (the check is kept by the tensor's version)."""
    cos, sin = (b.clone() for b in _bases())
    stft_logmag.fourier_window(cos, sin)
    cos[7, 9] += 1e-3
    with pytest.raises(ValueError, match="Fourier bases"):
        stft_logmag.fourier_window(cos, sin)


def test_twiddles_are_rounded_once_from_float64():
    got = stft_logmag.twiddles(256, torch.device("cpu"))
    e = np.arange(256) * (2 * np.pi / 256)
    np.testing.assert_array_equal(
        got.numpy(), np.stack([np.cos(e), np.sin(e)], 1).astype(np.float32))


def test_cpu_wrapper_counts_no_launch():
    fwd = tracing.counters()["launch.stft_fwd"]
    bwd = tracing.counters()["launch.stft_bwd"]
    re, im = (torch.tensor(a, requires_grad=True) for a in _signal(1, 600))
    stft_logmag.stft_logmag(re, im, HOP, *_bases()).sum().backward()
    assert re.grad is not None
    assert tracing.counters()["launch.stft_fwd"] == fwd
    assert tracing.counters()["launch.stft_bwd"] == bwd
