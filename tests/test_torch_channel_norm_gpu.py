"""The channels-first BatchNorm kernels (``csrc/channel_norm.cu``) against
``F.batch_norm`` on the card: at the 86 BatchNorms of a CTR-GCN training
step at the 64-frame cell's shapes (B = 128) in bf16, at a few of them in
f32, and at the edges; outputs, running statistics, gradients, repeats bit
for bit, the launches of a training step, and the refusal of a type the
kernels do not take.

Marked ``gpu``: each test skips where there is no CUDA device. The file
imports neither jax nor the test configuration's jax setup (the step's
BatchNorm shapes come from ``chip_smoke.py``, whose ``channel_norm_kernel``
phase times the same kernels), so on a machine with a card and no jax it
runs as

    python -m pytest --noconftest -p no:cacheprovider -m gpu \\
        tests/test_torch_channel_norm_gpu.py
"""

import pytest
import torch
import torch.nn.functional as F

from skeleton_action_recognition_tpu_torch import tracing
from skeleton_action_recognition_tpu_torch.models import ctrgcn, layers
from skeleton_action_recognition_tpu_torch.ops import channel_norm

DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}
EPS, MOMENTUM = 1e-5, 0.1
# kernel vs F.batch_norm (both in f32, the statistics summed in other
# orders): y and dx over the largest |reference| of the tensor, an f32
# rounding or one bf16 ulp (2^-7) where the two round on either side of a
# tie; the running statistics relative. The weight gradients against f64,
# over the sum of their terms' magnitudes (f32 sums of up to 409,600
# terms), and against F.batch_norm's within its own distance from f64 and
# that: its bf16 NCHW backward rounds its partial sums to bf16 (2e-5 to
# 3e-4 of the terms' magnitudes from f64 on the card)
TOL = {"f32": 1e-5, "bf16": 2**-7}
STAT_TOL = 1e-5
SUM_TOL = 1e-5


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def operands(shape, dtype, device, seed=0):
    g = torch.Generator(device=device).manual_seed(seed)
    c = shape[1]
    x = (torch.randn(shape, generator=g, device=device) * 2 + 3).to(dtype)
    w = torch.rand(c, generator=g, device=device) + 0.5
    b = torch.randn(c, generator=g, device=device)
    rm = torch.randn(c, generator=g, device=device) * 0.1
    rv = torch.rand(c, generator=g, device=device) + 0.5
    return x, w, b, rm, rv


def rel(got, want):
    want = want.float()
    return ((got.float() - want).abs().max()
            / want.abs().max().clamp_min(1e-30)).item()


def check_against_batch_norm(shape, x_dtype, y_dtype, device, dy_slice=False,
                             dy_expanded=False, x_transposed=False):
    """The kernels and ``F.batch_norm`` (in x's dtype, then cast) on the
    same operands: y, the running statistics, dx, grad_weight, grad_bias;
    then the kernels again on the same inputs, bit for bit. ``dy`` a slice
    of a wider tensor or expanded over the frames, ``x`` (N, C, T, V) as a
    transposed view of (N, C, V, T), where asked."""
    x, w, b, rm, rv = operands(shape, x_dtype, device)
    if x_transposed:
        x = x.transpose(2, 3).contiguous().transpose(2, 3)
        assert not x[0].is_contiguous()
    rm0, rv0 = rm.clone(), rv.clone()
    rm_ref, rv_ref = rm.clone(), rv.clone()
    xk = x.clone().requires_grad_(True)
    wk, bk = w.clone().requires_grad_(True), b.clone().requires_grad_(True)
    xr = x.clone().requires_grad_(True)
    wr, br = w.clone().requires_grad_(True), b.clone().requires_grad_(True)
    before = tracing.counters()
    y = channel_norm.channel_norm(xk, wk, bk, rm, rv, MOMENTUM, EPS,
                                  out_dtype=y_dtype)
    # the parent route: x in its dtype, float32 for a float32 y
    want = F.batch_norm(xr.float() if y_dtype == torch.float32 else xr,
                        rm_ref, rv_ref, wr, br, True, MOMENTUM,
                        EPS).to(y_dtype)
    assert y.dtype == y_dtype
    g = torch.Generator(device=device).manual_seed(7)
    if dy_slice:
        # a slice of a concatenation's gradient, as the branches get it
        wide = list(shape)
        wide[1] *= 3
        dy = torch.randn(wide, generator=g, device=device).to(
            y_dtype)[:, shape[1]:2 * shape[1]]
        assert shape[0] == 1 or not dy.is_contiguous()
    elif dy_expanded:
        # every frame's gradient the same: stride 0 over T, as the
        # backward of a broadcast gives it
        one = (shape[0], shape[1], 1) + tuple(shape[3:])
        dy = torch.randn(one, generator=g, device=device).to(
            y_dtype).expand(shape)
        assert not dy[0].is_contiguous()
    else:
        dy = torch.randn(shape, generator=g, device=device).to(y_dtype)
    got = torch.autograd.grad(y, (xk, wk, bk), dy)
    ref = torch.autograd.grad(want, (xr, wr, br), dy)
    after = tracing.counters()
    assert after["launch.channel_norm_fwd"] - before.get(
        "launch.channel_norm_fwd", 0) == 1
    assert after["launch.channel_norm_bwd"] - before.get(
        "launch.channel_norm_bwd", 0) == 1
    axes = (0,) + tuple(range(2, x.ndim))
    xd, dyd = x.double(), dy.double()
    xhat = (xd - xd.mean(axes, keepdim=True)) * torch.rsqrt(
        xd.var(axes, unbiased=False, keepdim=True) + EPS)
    terms = {"grad_weight": dyd * xhat, "grad_bias": dyd}
    errs = {
        "y": rel(y, want),
        "running_mean": ((rm - rm_ref).abs() / rm_ref.abs()).max().item(),
        "running_var": ((rv - rv_ref).abs() / rv_ref).max().item(),
        "dx": rel(got[0], ref[0]),
    }
    tol = {"y": TOL[_name(y_dtype)], "dx": TOL[_name(x_dtype)],
           "running_mean": STAT_TOL, "running_var": STAT_TOL}
    for i, name in ((1, "grad_weight"), (2, "grad_bias")):
        scale, exact = terms[name].abs().sum(axes), terms[name].sum(axes)
        errs[name] = ((got[i] - exact).abs() / scale).max().item()
        errs[f"{name}_vs_batch_norm"] = (
            (got[i] - ref[i]).abs() / scale).max().item()
        tol[name] = SUM_TOL
        tol[f"{name}_vs_batch_norm"] = SUM_TOL + (
            (ref[i] - exact).abs() / scale).max().item()
    assert all(errs[k] <= tol[k] for k in errs), (errs, tol)
    # repeats are bit-identical
    rm_again, rv_again = rm0.clone(), rv0.clone()
    xk2 = x.clone().requires_grad_(True)
    y2 = channel_norm.channel_norm(xk2, wk, bk, rm_again, rv_again,
                                   MOMENTUM, EPS, out_dtype=y_dtype)
    got2 = torch.autograd.grad(y2, (xk2, wk, bk), dy)
    assert torch.equal(y2, y)
    assert torch.equal(rm_again, rm) and torch.equal(rv_again, rv)
    assert all(torch.equal(a, b) for a, b in zip(got2, got))


def _name(dtype):
    return {v: k for k, v in DTYPES.items()}[dtype]


@pytest.mark.gpu
def test_kernels_match_batch_norm_at_the_cells_86_norms(cuda):
    """Every BatchNorm of the bf16 cell's step: its shape and types, each
    distinct one checked once (the 86 fall into eleven)."""
    # imported here: on a machine without a card the file is collected,
    # and chip_smoke.py pulls in most of the package
    from chip_smoke import channel_norm_cells

    norms = channel_norm_cells(cuda)
    assert sum(norms.values()) == 86
    for (shape, x_dtype, y_dtype), _ in sorted(norms.items(),
                                              key=lambda kv: str(kv[0])):
        check_against_batch_norm(shape, x_dtype, y_dtype, cuda)


F32_SHAPES = [(256, 64, 1600), (256, 32, 800), (256, 256, 400),
              (128, 150, 64)]
EDGE_SHAPES = [(3, 5, 7, 25), (1, 3, 36), (300, 2, 8), (8, 3),
               (256, 16, 64, 25), (2, 64, 300, 25)]


@pytest.mark.gpu
@pytest.mark.parametrize("shape", F32_SHAPES + EDGE_SHAPES,
                         ids=lambda s: "x".join(map(str, s)))
def test_kernels_match_batch_norm_in_f32_and_at_the_edges(cuda, shape):
    check_against_batch_norm(shape, torch.float32, torch.float32, cuda)
    if len(shape) > 2:
        check_against_batch_norm(shape, torch.bfloat16, torch.bfloat16,
                                 cuda, dy_slice=True)
        check_against_batch_norm(shape, torch.float32, torch.bfloat16, cuda)
        check_against_batch_norm(shape, torch.bfloat16, torch.float32, cuda)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(1, 16, 64, 25), (1, 5, 7, 25),
                                   (3, 5, 7, 25)],
                         ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("layout", ["dy_expanded", "x_transposed"])
def test_kernels_copy_what_they_cannot_read_in_place(cuda, shape, layout):
    """One sample or many, a ``dy`` expanded over the frames or an ``x``
    whose samples are not contiguous reaches the kernels as a contiguous
    copy: the outputs are ``F.batch_norm``'s."""
    for dtype in DTYPES.values():
        check_against_batch_norm(shape, dtype, dtype, cuda,
                                 **{layout: True})


@pytest.mark.gpu
def test_model_step_launches_86_each_way(cuda):
    """A bf16 training step of the full model at remat off: one forward and
    one backward launch a BatchNorm, and no torch BatchNorm kernel."""
    model = ctrgcn.Model(num_classes=60, dtype=torch.bfloat16, remat=False,
                         device=cuda,
                         generator=torch.Generator().manual_seed(0))
    x = torch.randn(2, 3, 64, 25, 2, device=cuda)
    before = tracing.counters()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        model(x).sum().backward()
    after = tracing.counters()
    for name in ("launch.channel_norm_fwd", "launch.channel_norm_bwd"):
        assert after[name] - before.get(name, 0) == 86
    ops = {e.key for e in prof.key_averages()}
    assert not any("batch_norm" in k for k in ops), sorted(
        k for k in ops if "batch_norm" in k)


@pytest.mark.gpu
def test_eval_and_frozen_statistics(cuda):
    """In eval the layer keeps ``F.batch_norm`` with the running
    statistics (no launch); with ``update_stats`` off the kernels leave the
    running statistics as they are."""
    bn = layers.BatchNorm(6, torch.bfloat16, epsilon=EPS,
                          momentum=layers.TORCH_MOMENTUM, axis=1).to(cuda)
    x = torch.randn(4, 6, 8, 25, device=cuda).bfloat16()
    with layers.frozen_stats(bn):
        before = tracing.counters()
        y = bn(x)
        assert tracing.counters()["launch.channel_norm_fwd"] - before.get(
            "launch.channel_norm_fwd", 0) == 1
    assert y.dtype == torch.bfloat16
    assert torch.equal(bn.running_mean, torch.zeros(6, device=cuda))
    assert torch.equal(bn.running_var, torch.ones(6, device=cuda))
    bn(x)
    assert not torch.equal(bn.running_mean, torch.zeros(6, device=cuda))
    bn.eval()
    before = tracing.counters()
    got = bn(x)
    assert tracing.counters() == before
    want = F.batch_norm(x, bn.running_mean, bn.running_var, bn.weight,
                        bn.bias, False, eps=EPS)
    assert torch.equal(got, want)


@pytest.mark.gpu
def test_process_group_keeps_the_moments_route(cuda, monkeypatch):
    """In a process group the layer takes the global batch's moments
    (``stats_from_moments``) as before, and no kernel: here ``active``
    stands in for a group of one rank, whose global means are its own."""
    monkeypatch.setattr(layers, "active", lambda: True)
    bn = layers.BatchNorm(6, torch.bfloat16, epsilon=EPS,
                          momentum=layers.TORCH_MOMENTUM, axis=1).to(cuda)
    x = torch.randn(4, 6, 8, 25, device=cuda).bfloat16()
    before = tracing.counters()
    got = bn(x)
    assert tracing.counters() == before
    xf, axes, shape = x.float(), (0, 2, 3), (-1, 1, 1)
    mean, sq = layers.moments(xf, axes)
    var = torch.clamp(sq - mean * mean, min=0.0)
    scale = torch.rsqrt(var + EPS) * bn.weight
    want = ((xf - mean.view(shape)) * scale.view(shape)
            + bn.bias.view(shape)).to(torch.bfloat16)
    assert torch.equal(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float16, torch.float64])
def test_refuses_other_types_on_the_card(cuda, dtype):
    """A CUDA input of a type the kernels do not take raises in training;
    it does not fall back to ``F.batch_norm``."""
    bn = layers.BatchNorm(3, torch.bfloat16, epsilon=EPS,
                          momentum=layers.TORCH_MOMENTUM, axis=1).to(cuda)
    x = torch.randn(4, 3, 10, device=cuda).to(dtype)
    with pytest.raises(TypeError):
        bn(x)
