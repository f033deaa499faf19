"""The CUDA spatial graph-conv kernels, forward and backward, against their
plain versions, on the card.

Marked ``gpu``: each test skips where there is no CUDA device. The file
imports neither jax nor the test configuration's jax setup, so on a
machine with a card and no jax it runs as

    python -m pytest --noconftest -p no:cacheprovider -m gpu \
        tests/test_torch_sgcn_gpu.py
"""

import pytest
import torch

from skeleton_action_recognition_tpu_torch import tracing
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
    before = tracing.counters()["launch.sgcn_fwd"]
    got = sgcn.fused_graph_conv(x, w, b, a)
    torch.cuda.synchronize()
    assert tracing.counters()["launch.sgcn_fwd"] == before + 1
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


# max |kernel - plain| / max |plain| of dx, dW and db. f32: dx sums at most
# 3 * 256 terms, dW and db up to 1.9 M rows, in other orders (measured
# ~5e-6). bf16: dx is rounded to bf16 once from f32 sums taken in other
# orders, so an element may differ by a bf16 ulp; dW and db leave in f32
# from the same bf16 dz in both.
BWD_REL_TOL = {torch.float32: (1e-5, 1e-4, 1e-4),
               torch.bfloat16: (2e-2, 1e-4, 1e-4)}


def _bwd_inputs(t, c_in, c_out, dtype, device, nm=4):
    x, w, _, a = _inputs(t, c_in, c_out, dtype, device, nm)
    g = torch.Generator(device=device).manual_seed(t * c_in + c_out)
    gout = torch.randn(nm, t, 25, c_out, generator=g, device=device)
    return x, w, a, gout.to(dtype)


def _assert_close(got, want, tols):
    for name, p, q, tol in zip(("dx", "dW", "db"), got, want, tols):
        assert p.dtype == q.dtype and p.shape == q.shape, name
        err = (p.float() - q.float()).abs().max().item()
        assert err <= tol * q.float().abs().max().item(), (name, err)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("t,c_in,c_out", MODEL_SHAPES)
def test_backward_kernel_matches_plain_version(cuda, t, c_in, c_out, dtype):
    x, w, a, g = _bwd_inputs(t, c_in, c_out, dtype, cuda)
    before = tracing.counters()["launch.sgcn_bwd"]
    got = sgcn.fused_graph_conv_backward(x, w, a, g)
    torch.cuda.synchronize()
    assert tracing.counters()["launch.sgcn_bwd"] == before + 1
    want = sgcn.graph_conv_backward_reference(x, w, a, g)
    _assert_close(got, want, BWD_REL_TOL[dtype])


@pytest.mark.gpu
def test_backward_kernel_takes_a_partial_last_block(cuda):
    """An odd number of frames, C_in and C_out no multiples of the tiles,
    and more splits of dW than frames would fill."""
    x, w, a, g = _bwd_inputs(7, 20, 40, torch.float32, cuda, nm=3)
    got = sgcn.fused_graph_conv_backward(x, w, a, g)
    want = sgcn.graph_conv_backward_reference(x, w, a, g)
    _assert_close(got, want, BWD_REL_TOL[torch.float32])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_backward_kernel_repeats_bit_for_bit(cuda, dtype):
    """No float atomics: two launches on the same inputs agree exactly."""
    x, w, a, g = _bwd_inputs(150, 128, 128, dtype, cuda, nm=8)
    first = sgcn.fused_graph_conv_backward(x, w, a, g)
    second = sgcn.fused_graph_conv_backward(x, w, a, g)
    for p, q in zip(first, second):
        assert torch.equal(p, q)


@pytest.mark.gpu
def test_backward_kernel_rejects_a_strided_input(cuda):
    x, w, a, g = _bwd_inputs(8, 16, 16, torch.float32, cuda)
    with pytest.raises(ValueError):
        sgcn.fused_graph_conv_backward(x[:, ::2], w, a, g[:, ::2])
    with pytest.raises(ValueError):
        sgcn.fused_graph_conv_backward(x, w, a, g.transpose(0, 1))


@pytest.mark.gpu
def test_autograd_function_launches_both_kernels(cuda):
    """On CUDA tensors the op's gradient comes from the backward kernel
    and equals the plain backward's."""
    x, w, b, a = _inputs(12, 16, 32, torch.float32, cuda)
    x.requires_grad_()
    w.requires_grad_()
    b.requires_grad_()
    fwd = tracing.counters()["launch.sgcn_fwd"]
    bwd = tracing.counters()["launch.sgcn_bwd"]
    out = sgcn.fused_graph_conv(x, w, b, a)
    g = torch.randn_like(out)
    out.backward(g)
    torch.cuda.synchronize()
    assert tracing.counters()["launch.sgcn_fwd"] == fwd + 1
    assert tracing.counters()["launch.sgcn_bwd"] == bwd + 1
    want = sgcn.graph_conv_backward_reference(x.detach(), w.detach(), a, g)
    _assert_close((x.grad, w.grad, b.grad), want,
                  BWD_REL_TOL[torch.float32])


# the stats epilogue (kernel #2), as |error| / sum |terms| per channel.
# Against the sums of the kernel's own output, in f64: f32 sums of up to
# 1.9 M rows in other orders (1e-5). Against the plain version's sums: f32
# as before; in bf16 each output element may be a bf16 ulp (2^-8) away from
# the plain one, so a sum of outputs or of their squares may be up to two
# ulps away (1e-2).
STATS_OWN_TOL = 1e-5
STATS_PLAIN_TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}


def _assert_stats_close(got, want, dtype):
    out, ref = got[0], want[0]
    assert out.dtype == dtype and out.shape == ref.shape
    err = (out.float() - ref.float()).abs().max().item()
    assert err <= REL_TOL[dtype] * ref.float().abs().max().item()
    for own, src, tol in ((True, out, STATS_OWN_TOL),
                          (False, ref, STATS_PLAIN_TOL[dtype])):
        of = src.double()
        exact = (of.sum((0, 1, 2)), (of * of).sum((0, 1, 2)))
        scale = (of.abs().sum((0, 1, 2)), exact[1])
        for name, p, q, sc in zip(("s", "ss"), got[1:],
                                  exact if own else want[1:], scale):
            assert p.dtype == torch.float32, name
            rel = ((p.double() - q.double()).abs()
                   / sc.clamp_min(1e-30)).max().item()
            assert rel <= tol, (name, own, rel)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("t,c_in,c_out", MODEL_SHAPES + [(7, 20, 40)])
def test_stats_kernel_matches_plain_version(cuda, t, c_in, c_out, dtype):
    x, w, b, a = _inputs(t, c_in, c_out, dtype, cuda, nm=3)
    before = tracing.counters()["launch.sgcn_fwd_stats"]
    got = sgcn.fused_graph_conv_stats(x, w, b, a)
    torch.cuda.synchronize()
    assert tracing.counters()["launch.sgcn_fwd_stats"] == before + 1
    _assert_stats_close(got, sgcn.graph_conv_stats_reference(x, w, b, a),
                        dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_stats_kernel_repeats_bit_for_bit(cuda, dtype):
    """The sums leave through per-block partials and a fixed-order reduce:
    two launches agree exactly."""
    x, w, b, a = _inputs(150, 128, 128, dtype, cuda, nm=8)
    first = sgcn.fused_graph_conv_stats(x, w, b, a)
    second = sgcn.fused_graph_conv_stats(x, w, b, a)
    for p, q in zip(first, second):
        assert torch.equal(p, q)


@pytest.mark.gpu
def test_stats_function_launches_its_kernels_only(cuda, monkeypatch):
    """On CUDA tensors the stats op launches the stats kernel and, in the
    backward, the backward kernel with the sums' cotangents folded in;
    neither plain version is called."""
    x, w, b, a = _inputs(12, 16, 32, torch.float32, cuda)
    plain_bwd = sgcn.graph_conv_backward_reference

    def refuse(*args):
        raise AssertionError("a CUDA tensor reached a plain version")

    monkeypatch.setattr(sgcn, "graph_conv_stats_reference", refuse)
    monkeypatch.setattr(sgcn, "graph_conv_backward_reference", refuse)
    args = [t.clone().requires_grad_() for t in (x, w, b)]
    fwd = tracing.counters()["launch.sgcn_fwd_stats"]
    bwd = tracing.counters()["launch.sgcn_bwd"]
    out, s, ss = sgcn.fused_graph_conv_stats(*args, a)
    g = torch.randn_like(out)
    ((out * g).sum() + 0.1 * s.sum() + 0.01 * ss.sum()).backward()
    torch.cuda.synchronize()
    assert tracing.counters()["launch.sgcn_fwd_stats"] == fwd + 1
    assert tracing.counters()["launch.sgcn_bwd"] == bwd + 1
    gg = g + 0.1 + 0.02 * out.detach()
    want = plain_bwd(x, w, a, gg)
    _assert_close([t.grad for t in args], want, BWD_REL_TOL[torch.float32])


# The edges of the kernels' tiles (the bf16 kernels: 5-frame tiles of 125
# rows padded to 128, 32 output channels, 64 or 128 input channels, rows
# staged in 16-byte groups), as (NM, T, C_in, C_out): C_in = 3 (6-byte rows,
# staged element by element) with NM * T not a multiple of 5; one frame;
# C_in = 20 (unaligned) and C_out = 40 (a partial tile); C_in = 24 (aligned,
# depth zero-padded to 32); C_in = 136 (two input-channel tiles, a partial
# chunk) and C_out = 72; an odd C_out; the widest block at 18 frames.
# The edges of the f32 tiles (5 frames x 32 output channels, input in
# chunks of 16, in the forward; 5 frames x 64 input channels, output in
# chunks of 16, in dx; 64 x 64 channels over chunks of 2 frames in dW; a
# narrow path at C_in <= 4): C_in = 4 (the narrow path, 16-byte rows) and
# 5 (just past it, unaligned); C_in = 40 and C_out = 100 (partial chunks and
# tiles of every kernel) over 13 frames (a partial tile, a split ending on a
# partial chunk); and 1,600 frames of C_in = 300, C_out = 150 (more tiles
# than the persistent forward and dx run blocks, whose walk then wraps
# across the 5 channel tiles).
EDGE_SHAPES = [(3, 7, 3, 64), (1, 1, 16, 32), (3, 7, 20, 40), (2, 3, 24, 40),
               (3, 4, 136, 72), (1, 5, 16, 33), (2, 9, 256, 256),
               (4, 3, 4, 24), (2, 6, 5, 16), (1, 13, 40, 100),
               (8, 200, 300, 150)]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("nm,t,c_in,c_out", EDGE_SHAPES)
def test_kernels_at_the_edges_of_their_tiles(cuda, nm, t, c_in, c_out,
                                             dtype):
    """Forward (#1), stats (#2) and backward (#3) against their plain
    versions, each launched twice with bit-identical results."""
    x, w, b, a = _inputs(t, c_in, c_out, dtype, cuda, nm)
    g = torch.randn(nm, t, 25, c_out, device=cuda,
                    generator=torch.Generator(cuda).manual_seed(c_out))
    g = g.to(dtype)
    runs = {
        "forward": lambda: (sgcn.fused_graph_conv(x, w, b, a),),
        "stats": lambda: sgcn.fused_graph_conv_stats(x, w, b, a),
        "backward": lambda: sgcn.fused_graph_conv_backward(x, w, a, g),
    }
    got = {}
    for name, run in runs.items():
        first, second = run(), run()
        torch.cuda.synchronize()
        for p, q in zip(first, second):
            assert torch.equal(p, q), name
        got[name] = first
    want = sgcn.graph_conv_reference(x, w, b, a)
    out = got["forward"][0]
    assert out.dtype == dtype and out.shape == want.shape
    err = (out.float() - want.float()).abs().max().item()
    assert err <= REL_TOL[dtype] * want.float().abs().max().item()
    _assert_stats_close(got["stats"],
                        sgcn.graph_conv_stats_reference(x, w, b, a), dtype)
    _assert_close(got["backward"],
                  sgcn.graph_conv_backward_reference(x, w, a, g),
                  BWD_REL_TOL[dtype])


@pytest.mark.gpu
def test_f32_kernels_ignore_the_tf32_switch(cuda):
    """The f32 kernels compute on the CUDA cores whatever
    ``torch.backends.cuda.matmul.allow_tf32`` says (``main_gnn``'s default
    ``--precision`` turns it on): forward, stats and backward give
    bit-identical results with it on and off."""
    x, w, b, a = _inputs(30, 64, 128, torch.float32, cuda, nm=4)
    g = torch.randn(4, 30, 25, 128, device=cuda,
                    generator=torch.Generator(cuda).manual_seed(5))
    runs = {}
    try:
        for allow in (True, False):
            torch.backends.cuda.matmul.allow_tf32 = allow
            torch.backends.cudnn.allow_tf32 = allow
            runs[allow] = ((sgcn.fused_graph_conv(x, w, b, a),)
                           + sgcn.fused_graph_conv_stats(x, w, b, a)
                           + sgcn.fused_graph_conv_backward(x, w, a, g))
            torch.cuda.synchronize()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    for p, q in zip(runs[True], runs[False]):
        assert torch.equal(p, q)
