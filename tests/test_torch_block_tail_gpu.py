"""The CUDA kernels of a fused ST-GCN block's tail (``csrc/block_tail.cu``:
BN2's normalize, the residual and the ReLU, their backward, and the fold
of BN2's statistics' cotangents that the temporal chain's backward reads)
against their plain versions, on the card.

Marked ``gpu``: each test skips where there is no CUDA device. The file
imports neither jax nor the test configuration's jax setup, so on a
machine with a card and no jax it runs as

    python -m pytest --noconftest -p no:cacheprovider -m gpu \
        tests/test_torch_block_tail_gpu.py
"""

import pytest
import torch

from skeleton_action_recognition_tpu_torch import tracing
from skeleton_action_recognition_tpu_torch.models import stgcn
from skeleton_action_recognition_tpu_torch.ops import tconv

NM = 256  # the 128-clip training batch x 2 bodies
# (T, C) of the stride-1 blocks
MODEL_SHAPES = [(300, 64), (150, 128), (75, 256)]
DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}
RESIDUALS = {"none": None, "f32": torch.float32, "bf16": torch.bfloat16}
# g_scale2 and g_shift2: f32 sums over every row in another order than the
# plain version's, |kernel - plain| <= SUM_TOL * max |plain|
SUM_TOL = 1e-4
# one train step of a block, as tests/test_torch_fused_train.py holds the
# fused model to the JAX one
MODEL_TOL = dict(rtol=5e-2, atol=5e-3)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _inputs(t, c, dtype, res_dtype, device, nm=NM):
    g = torch.Generator(device=device).manual_seed(t + c)
    shape = (nm, t, 25, c)
    u = torch.randn(shape, generator=g, device=device).to(dtype)
    scale2 = torch.randn(c, generator=g, device=device)
    shift2 = 0.1 * torch.randn(c, generator=g, device=device)
    res = (None if res_dtype is None else
           torch.randn(shape, generator=g, device=device).to(res_dtype))
    g_out = torch.randn(shape, generator=g, device=device)
    g_u = torch.randn(shape, generator=g, device=device).to(dtype)
    g_sum = torch.randn(c, generator=g, device=device)
    g_sumsq = 0.1 * torch.randn(c, generator=g, device=device)
    return u, scale2, shift2, res, g_out, g_u, g_sum, g_sumsq


def _launches(*names):
    counts = tracing.counters()
    return [counts[f"launch.{n}"] for n in names]


def _run(u, scale2, shift2, res, g_out, g_u, g_sum, g_sumsq):
    """The three kernels through their wrappers: out, then g_u, g_scale2,
    g_shift2, g_res, then gue."""
    out = tconv._tail_forward(u, scale2, shift2, res)
    grads = tconv._tail_backward(g_out, out, u, scale2,
                                 None if res is None else res.dtype)
    return (out, *grads, tconv.tconv_gue(g_u, u, g_sum, g_sumsq))


@pytest.mark.gpu
@pytest.mark.parametrize("res_name", list(RESIDUALS))
@pytest.mark.parametrize("name", list(DTYPES))
@pytest.mark.parametrize("t,c", MODEL_SHAPES)
def test_kernels_match_plain_versions(cuda, t, c, name, res_name):
    """At the stride-1 blocks' shapes: out, g_u, g_res and gue bit for bit
    (the sign of a zero aside), the two channel sums within SUM_TOL, one
    launch of each entry point, and a repeat bit for bit."""
    args = _inputs(t, c, DTYPES[name], RESIDUALS[res_name], cuda)
    u, scale2, shift2, res, g_out, g_u, g_sum, g_sumsq = args
    before = _launches("block_tail_fwd", "block_tail_bwd", "tconv_gue")
    got = _run(*args)
    torch.cuda.synchronize()
    assert _launches("block_tail_fwd", "block_tail_bwd", "tconv_gue") == [
        n + 1 for n in before]
    out, gu, g_scale2, g_shift2, g_res, gue = got
    want_out = tconv.block_tail_reference(u, scale2, shift2, res)
    want = tconv.block_tail_backward_reference(
        g_out, out, u, scale2, None if res is None else res.dtype)
    assert out.dtype == torch.float32 and torch.equal(out, want_out)
    assert gu.dtype == u.dtype and torch.equal(gu, want[0])
    if res is None:
        assert g_res is None
    else:
        assert g_res.dtype == res.dtype and torch.equal(g_res, want[3])
    for p, q in ((g_scale2, want[1]), (g_shift2, want[2])):
        assert p.dtype == torch.float32 and p.shape == q.shape
        assert (p - q).abs().max() <= SUM_TOL * q.abs().max()
    assert gue.dtype == u.dtype and torch.equal(
        gue, tconv.tconv_gue_reference(g_u, u, g_sum, g_sumsq))
    again = _run(*args)
    for p, q in zip(got, again):
        assert (p is None and q is None) or torch.equal(p, q)


@pytest.mark.gpu
@pytest.mark.parametrize("c,vec", [(20, 4), (6, 2), (5, 1), (300, 4)])
def test_kernels_at_narrow_and_odd_widths(cuda, c, vec):
    """The widths that take 4, 2 or 1 channels a thread, and 75 lanes a
    row: against the plain versions as above."""
    args = _inputs(7, c, torch.float32, torch.bfloat16, cuda, nm=3)
    u, scale2, shift2, res, g_out, g_u, g_sum, g_sumsq = args
    assert tconv._tail_vec(c, u=u, res=res, g_out=g_out) == vec
    out, gu, g_scale2, g_shift2, g_res, gue = _run(*args)
    want = tconv.block_tail_backward_reference(g_out, out, u, scale2,
                                               res.dtype)
    assert torch.equal(out, tconv.block_tail_reference(u, scale2, shift2,
                                                       res))
    assert torch.equal(gu, want[0]) and torch.equal(g_res, want[3])
    for p, q in ((g_scale2, want[1]), (g_shift2, want[2])):
        assert (p - q).abs().max() <= SUM_TOL * q.abs().max()
    assert torch.equal(gue, tconv.tconv_gue_reference(g_u, u, g_sum,
                                                      g_sumsq))


@pytest.mark.gpu
def test_kernels_refuse_an_unaligned_input(cuda):
    """A contiguous view 4 bytes into its storage: each wrapper raises
    before it launches, as it does for a non-contiguous input."""
    args = _inputs(9, 64, torch.float32, torch.float32, cuda, nm=2)
    u, scale2, shift2, res, g_out, g_u, g_sum, g_sumsq = args
    flat = torch.empty(u.numel() + 1, device=cuda)
    view = flat[1:].view(u.shape)
    view.copy_(u)
    out = tconv._tail_forward(u, scale2, shift2, res)
    names = ("block_tail_fwd", "block_tail_bwd", "tconv_gue")
    before = _launches(*names)
    for call in (lambda: tconv._tail_forward(view, scale2, shift2, res),
                 lambda: tconv._tail_forward(u, scale2, shift2, view),
                 lambda: tconv._tail_backward(view, out, u, scale2,
                                              res.dtype),
                 lambda: tconv.tconv_gue(view, u, g_sum, g_sumsq)):
        with pytest.raises(ValueError, match="16-byte boundary"):
            call()
    assert _launches(*names) == before


@pytest.mark.gpu
def test_cuda_tensors_never_reach_the_plain_versions(cuda, monkeypatch):
    """The tail's forward and backward, and the chain's backward with its
    fold, on CUDA tensors through autograd: the plain versions are not
    called."""
    refs = {name: getattr(tconv, name) for name in (
        "block_tail_reference", "block_tail_backward_reference",
        "tconv_gue_reference", "affine_relu_tconv_reference",
        "affine_relu_tconv_backward_reference")}

    def refuse(*args):
        raise AssertionError("a CUDA tensor reached a plain version")

    for name in refs:
        monkeypatch.setattr(tconv, name, refuse)
    g = torch.Generator(device=cuda).manual_seed(3)
    s = torch.randn(2, 12, 25, 16, generator=g, device=cuda)
    params = [torch.randn(16, generator=g, device=cuda),
              torch.rand(16, generator=g, device=cuda) + 0.5,
              torch.randn(16, 16, 9, 1, generator=g, device=cuda) / 12,
              torch.randn(16, generator=g, device=cuda)]
    leaves = [t.requires_grad_() for t in [s, *params]]
    u, s2, ss2 = tconv.affine_relu_tconv(*leaves)
    scale2, shift2 = 1.0 + 0.01 * ss2, 0.01 * s2
    res = s.detach().clone().requires_grad_()
    before = _launches("block_tail_fwd", "block_tail_bwd", "tconv_gue")
    out = tconv.block_tail(u, scale2, shift2, res)
    out.square().sum().backward()
    torch.cuda.synchronize()
    assert _launches("block_tail_fwd", "block_tail_bwd", "tconv_gue") == [
        n + 1 for n in before]
    assert all(t.grad is not None for t in leaves + [res])


def _block_step(device, eager, monkeypatch, dtype=torch.bfloat16):
    """One SGD step of a bf16 fused STConvBlock (64 -> 64, identity
    residual) in training: its loss, gradients and updated state. With
    ``eager``, the tail and the fold run as the eager expressions they
    replace (their plain versions, autograd through torch's passes)."""
    with monkeypatch.context() as m:
        if eager:
            m.setattr(stgcn, "block_tail",
                      lambda u, s, h, r=None: tconv.block_tail_reference(
                          u, s, h, r))
            m.setattr(tconv, "tconv_gue", tconv.tconv_gue_reference)
        block = stgcn.STConvBlock(
            64, 64, dtype=dtype, fused_sgcn=True, fused_tconv=True,
            generator=torch.Generator().manual_seed(5)).to(device).train()
        assert isinstance(block.tgcn, stgcn.FusedTemporalConv)
        g = torch.Generator(device=device).manual_seed(6)
        x = torch.randn(8, 40, 25, 64, generator=g, device=device)
        a = torch.from_numpy(stgcn.spatial_adjacency()).to(device)
        opt = torch.optim.SGD(block.parameters(), lr=0.1)
        loss = block(x, a).square().mean()
        loss.backward()
        grads = {n: p.grad.clone() for n, p in block.named_parameters()}
        opt.step()
        return loss.item(), grads, {
            n: v.clone() for n, v in block.state_dict().items()}


@pytest.mark.gpu
def test_bf16_block_step_matches_the_eager_tail(cuda, monkeypatch):
    """A bf16 STConvBlock's training step with the kernels against the
    same step with the eager tail: loss, gradients and updated state
    within test_torch_fused_train.py's tolerances."""
    kernels = _block_step(cuda, False, monkeypatch)
    eager = _block_step(cuda, True, monkeypatch)
    assert kernels[0] == pytest.approx(eager[0], rel=1e-4)
    for i in (1, 2):
        for name, want in eager[i].items():
            torch.testing.assert_close(kernels[i][name], want, **MODEL_TOL,
                                       msg=name)


def _cell_model(device, seed=0, dtype=torch.bfloat16):
    """The benchmark's training cell's model: bf16 (or ``dtype``), every
    spatial conv fused, fused_tconv, remat off."""
    return stgcn.Model(num_classes=60, dtype=dtype, fused_sgcn=True,
                       fused_tconv=True, remat=False, device=device,
                       generator=torch.Generator().manual_seed(seed))


def _cell_step_launches(device, names):
    """The launches of ``names`` in one train step of the cell's model at
    4 clips."""
    from skeleton_action_recognition_tpu_torch.train import optim, steps

    model = _cell_model(device)
    step = steps.make_train_step(
        model, optim.TFSGD(model.parameters(), 0.1, momentum=0.9,
                           nesterov=True), 4)
    g = torch.Generator(device=device).manual_seed(1)
    x = torch.randn(4, 3, 300, 25, 2, generator=g, device=device)
    y = torch.nn.functional.one_hot(
        torch.randint(0, 60, (4,), generator=g, device=device), 60).float()
    before = _launches(*names)
    step(x, y, False)
    torch.cuda.synchronize()
    return [a - b for a, b in zip(_launches(*names), before)]


@pytest.mark.gpu
def test_cell_step_launches_each_tail_kernel_eight_times(cuda):
    """The cell's model at 4 clips: one step launches each tail entry
    point and #4/#5 once for each of the 8 stride-1 blocks, and the fold
    twice (BN2's statistics' cotangents and BN1's, for #3)."""
    names = ("block_tail_fwd", "block_tail_bwd", "tconv_fwd", "tconv_bwd",
             "tconv_gue")
    assert _cell_step_launches(cuda, names) == [8] * 4 + [16]


# the cell's route in f32 on the card against its plain versions on the
# CPU: each leaf's |difference| over the larger of its |gradient| and the
# median leaf's (the benchmark's grad_diff), for the median leaf and for
# the worst. Three seeds read 0.8e-3 to 2.8e-3 and 3.9e-3 to 6.2e-3 on an
# H100; a fold or sum left out reads O(1). In bf16 both sides read ~0.2
# against either the CPU or the route with BN1's moments taken eagerly,
# on the card: rounding noise through ten BatchNorms, as the benchmark's
# sound runs read against f32
GRAD_DIFF_MEDIAN, GRAD_DIFF_MAX = 1e-2, 3e-2


@pytest.mark.gpu
def test_cell_step_takes_bn1_moments_from_the_spatial_epilogue(cuda):
    """The cell's model: one step launches #2 on the 8 stride-1 blocks,
    #1 on the 2 stride-2 ones, #3 on all ten and the fold 16 times; and,
    in f32, the gradients of a training forward on the card (the kernels)
    equal those of the same model on the CPU (every kernel's plain
    version) within GRAD_DIFF_*."""
    names = ("sgcn_fwd_stats", "sgcn_fwd", "sgcn_bwd", "tconv_gue")
    assert _cell_step_launches(cuda, names) == [8, 2, 10, 16]
    g = torch.Generator().manual_seed(2)
    x = torch.randn(2, 3, 64, 25, 2, generator=g)
    y = torch.randint(0, 60, (2,), generator=g)
    grads = []
    for device in (cuda, torch.device("cpu")):
        model = _cell_model(device, seed=3, dtype=None).train()
        loss = torch.nn.functional.cross_entropy(model(x.to(device)),
                                                 y.to(device))
        loss.backward()
        grads.append({n: p.grad.double().cpu()
                      for n, p in model.named_parameters()})
    norms = {n: q.norm().item() for n, q in grads[1].items()}
    median = sorted(norms.values())[len(norms) // 2]
    diffs = {n: (grads[0][n] - q).norm().item() / max(norms[n], median)
             for n, q in grads[1].items()}
    ranked = sorted(diffs.values())
    assert ranked[len(ranked) // 2] <= GRAD_DIFF_MEDIAN, diffs
    assert ranked[-1] <= GRAD_DIFF_MAX, diffs
