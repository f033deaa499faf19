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

from skeleton_action_recognition_tpu_torch import tracing
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
BAND_MASS = 2.0 ** -31  # of a row's L1 norm, each side of its band


def ragged_operator(t_out=9000, t_in=200, seed=5):
    """A narrow operator whose band wanders across ``T_in``: row t holds
    1-12 positive weights (summing to 1) near ``t * T_in / t_out``; ~1% of
    the rows and the whole block of rows 128-191 are zero, a 4,096-row
    split's band is wider than 64 columns, and ``t_out`` is no multiple of
    64 or 4,096."""
    rng = np.random.default_rng(seed)
    w = np.zeros((t_out, t_in), np.float32)
    for t in range(t_out):
        if 128 <= t < 192 or rng.random() < 0.01:
            continue
        width = int(rng.integers(1, 13))
        lo = min(t_in - width, max(0, t * t_in // t_out
                                   + int(rng.integers(-4, 5))))
        row = rng.random(width) + 0.1
        w[t, lo:lo + width] = row / row.sum()
    return w


def dense_operator(t_out=700, t_in=70, seed=6):
    """Positive weights on every column, rows summing to 1: every band is
    the full width."""
    w = np.random.default_rng(seed).random((t_out, t_in)) + 0.05
    return (w / w.sum(1, keepdims=True)).astype(np.float32)


def check_band(w, tiles, splits):
    """Assert that ``radar.dense_band``'s ``(tiles, splits)`` of the numpy
    operator ``w`` hold its criterion: each row's mass left of its block's
    band, and right of it, at most ``BAND_MASS`` of the row's L1 norm (f64
    sums), and each split's band the union of its blocks'."""
    t_out, t_in = w.shape
    tiles, splits = tiles.cpu(), splits.cpu()
    assert tiles.dtype == splits.dtype == torch.int32
    assert tiles.shape == (-(-t_out // 64), 2)
    assert splits.shape == (-(-t_out // 4096), 2)
    lo, hi = tiles.long().repeat_interleave(64, 0)[:t_out].T.numpy()
    assert ((0 <= lo) & (lo <= hi) & (hi <= t_in)).all()
    a = np.abs(w).astype(np.float64)
    cols = np.arange(t_in)
    left = np.where(cols < lo[:, None], a, 0.0).sum(1)
    right = np.where(cols >= hi[:, None], a, 0.0).sum(1)
    assert (left <= BAND_MASS * a.sum(1)).all()
    assert (right <= BAND_MASS * a.sum(1)).all()
    for s, (s_lo, s_hi) in enumerate(splits.tolist()):
        block = tiles[s * 64:(s + 1) * 64]
        block = block[block[:, 1] > block[:, 0]]
        if len(block):
            assert [s_lo, s_hi] == [block[:, 0].min(), block[:, 1].max()]
        else:
            assert s_lo == s_hi


def operator_inputs(w, lam, device, n=2, seed=0):
    """The dense kernels' inputs for seeded clips of ``T_in`` frames
    against the numpy operator ``w (t_out, T_in)``: ``(w, src, dst, c,
    loc, lam, t_out)``."""
    x = clips(n, w.shape[1], device, seed)
    w = torch.from_numpy(w).to(device)
    src, dst = radar.gather_features(x, radar.RADAR_EDGES)
    c = radar.bone_length_mean_sq(x, w)
    loc = torch.tensor([0.1, -0.2, 0.3], device=device)
    return w, src, dst, c, loc, torch.tensor(lam, device=device), w.shape[0]


@pytest.mark.gpu
@pytest.mark.parametrize("lam", [5e-4, 10.0])
@pytest.mark.parametrize("t_in,up,tile", SHAPES)
def test_forward_kernel_matches_plain_version(cuda, t_in, up, tile, lam):
    args = kernel_inputs(2, t_in, up, lam, cuda, tile)
    before = tracing.counters()["launch.radar_dense_fwd"]
    re, im = radar.dense_radar(*args)
    torch.cuda.synchronize()
    assert tracing.counters()["launch.radar_dense_fwd"] == before + 1
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
    before = tracing.counters()["launch.radar_dense_bwd"]
    got = radar.dense_radar_backward(*args[:6], g[0], g[1], args[6])
    torch.cuda.synchronize()
    assert tracing.counters()["launch.radar_dense_bwd"] == before + 1
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
    fwd = tracing.counters()["launch.radar_dense_fwd"]
    bwd = tracing.counters()["launch.radar_dense_bwd"]
    re, im = radar.radar_return_fused(x, w, torch.zeros(3, device=cuda), lam,
                                      tile=128)
    (re.sum() + im.sum()).backward()
    torch.cuda.synchronize()
    assert tracing.counters()["launch.radar_dense_fwd"] == fwd + 1
    assert tracing.counters()["launch.radar_dense_bwd"] == bwd + 1
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


@pytest.mark.gpu
@pytest.mark.parametrize("lam", [5e-4, 10.0])
@pytest.mark.parametrize("name", ["dense", "ragged"])
def test_kernels_match_plain_version_on_any_band(cuda, name, lam):
    """Both kernels against their plain versions on a dense operator (every
    band the full width; two 64-row tiles of T_in in the transposed
    products) and on a narrow ragged one (bands of 1-12 columns wandering
    across T_in, an empty block, zero rows, splits wider than 64
    columns)."""
    w_np = {"dense": dense_operator, "ragged": ragged_operator}[name]()
    args = operator_inputs(w_np, lam, cuda)
    t_out = args[6]
    tiles, splits = radar.dense_band(args[0], t_out)
    width = splits[:, 1] - splits[:, 0]
    if name == "dense":
        assert (tiles[:, 0] == 0).all() and (width == w_np.shape[1]).all()
    else:
        assert (tiles[:, 0] == tiles[:, 1]).any() and (width > 64).any()
    fwd = tracing.counters()["launch.radar_dense_fwd"]
    bwd = tracing.counters()["launch.radar_dense_bwd"]
    out = radar.dense_radar(*args)
    g = torch.randn(2, 2, t_out, device=cuda,
                    generator=torch.Generator(cuda).manual_seed(3))
    got = radar.dense_radar_backward(*args[:6], g[0], g[1], t_out)
    torch.cuda.synchronize()
    assert tracing.counters()["launch.radar_dense_fwd"] == fwd + 1
    assert tracing.counters()["launch.radar_dense_bwd"] == bwd + 1
    for p, q in zip(out, radar.dense_radar_reference(*args)):
        assert _rel(p, q) <= TOL[lam][0]
    want = radar.dense_radar_backward_reference(*args[:6], g[0], g[1], t_out)
    for name, p, q in zip(("dsrc", "ddst", "dc", "dloc", "dlam"), got, want):
        assert torch.isfinite(p).all(), name
        assert _rel(p, q) <= TOL[lam][1], (name, _rel(p, q))


@pytest.mark.gpu
def test_band_on_the_card_meets_its_criterion(cuda):
    """The band of the trainer's operator, found on the card (f64 sums in
    the card's order), holds the criterion and is ~39 columns a block."""
    w = resample.pad_frames_operator(300, 250)
    tiles, splits = radar.dense_band(torch.from_numpy(w).to(cuda), w.shape[0])
    assert tiles.is_cuda and splits.is_cuda
    check_band(w, tiles, splits)
    assert (tiles[:, 1] - tiles[:, 0]).double().mean() <= 40
