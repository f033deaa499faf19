"""The CUDA kernels of the fused temporal chain (#4 forward, #5 backward)
against their plain versions, on the card.

Marked ``gpu``: each test skips where there is no CUDA device. The file
imports neither jax nor the test configuration's jax setup, so on a
machine with a card and no jax it runs as

    python -m pytest --noconftest -p no:cacheprovider -m gpu \
        tests/test_torch_tconv_gpu.py
"""

import pytest
import torch

from skeleton_action_recognition_tpu_torch.ops import tconv

# (T, C) of the stride-1 blocks' temporal chains
MODEL_SHAPES = [(300, 64), (150, 128), (75, 256)]
DTYPES = [torch.float32, torch.bfloat16]
# u and g_s: max |kernel - plain| / max |plain|. f32: both sum 9 * C
# products in f32 in other orders. bf16: both round h and the weight to
# bf16 (exact products) and the result to bf16 once from f32 sums taken in
# other orders, so an element may differ by a bf16 ulp (2^-8).
OUT_TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
# the channel sums, as |error| / sum |terms| per channel. Against the f64
# sums of the kernel's own u: f32 sums of many rows in other orders (1e-5).
# Against the plain version's sums: f32 as before; in bf16 each element of
# u may be a bf16 ulp (2^-8) away from the plain one, so a sum of u or of
# u^2 may be up to two ulps away (1e-2).
SUM_OWN_TOL = 1e-5
SUM_PLAIN_TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}
# dscale, dshift, dW, dbias: max |kernel - plain| / max |plain|, f32 sums
# over every row of the same rounded operands in other orders
GRAD_TOL = 1e-4


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _inputs(t, c, dtype, device, nm=4):
    """A positive shift: the padded frames' relu(shift) is far from 0."""
    g = torch.Generator(device=device).manual_seed(t + c)
    s = torch.randn(nm, t, 25, c, generator=g, device=device).to(dtype)
    scale = torch.randn(c, generator=g, device=device)
    shift = 0.5 + torch.rand(c, generator=g, device=device)
    w = torch.randn(c, c, 9, 1, generator=g, device=device) / (3 * c**0.5)
    b = 0.1 * torch.randn(c, generator=g, device=device)
    gue = torch.randn(nm, t, 25, c, generator=g, device=device).to(dtype)
    return s, scale, shift, w, b, gue


def _rel(p, q):
    return ((p.float() - q.float()).abs().max()
            / q.float().abs().max().clamp_min(1e-30)).item()


def _check_forward(got, want, dtype):
    u, u_ref = got[0], want[0]
    assert u.dtype == dtype and u.shape == u_ref.shape
    assert _rel(u, u_ref) <= OUT_TOL[dtype]
    for own, src, tol in ((True, u, SUM_OWN_TOL),
                          (False, u_ref, SUM_PLAIN_TOL[dtype])):
        uf = src.double()
        exact = (uf.sum((0, 1, 2)), (uf * uf).sum((0, 1, 2)))
        scale = (uf.abs().sum((0, 1, 2)), exact[1])
        for p, q, sc in zip(got[1:], exact if own else want[1:], scale):
            rel = ((p.double() - q.double()).abs()
                   / sc.clamp_min(1e-30)).max().item()
            assert rel <= tol, (own, rel)


def _check_backward(got, want, dtype):
    assert got[0].dtype == dtype
    assert _rel(got[0], want[0]) <= OUT_TOL[dtype]
    for name, p, q in zip(("dscale", "dshift", "dW", "dbias"), got[1:],
                          want[1:]):
        assert p.dtype == torch.float32 and p.shape == q.shape, name
        assert _rel(p, q) <= GRAD_TOL, (name, _rel(p, q))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("t,c", MODEL_SHAPES + [(7, 20), (16, 8)])
def test_kernels_match_plain_versions(cuda, t, c, dtype):
    """At the model's shapes, and at a T that is no multiple of the tile
    and a C that is no multiple of the channel tiles."""
    s, scale, shift, w, b, gue = _inputs(t, c, dtype, cuda)
    fwd = tconv.affine_relu_tconv.launches
    bwd = tconv.affine_relu_tconv_backward.launches
    got = tconv.affine_relu_tconv(s, scale, shift, w, b)
    got_bwd = tconv.affine_relu_tconv_backward(s, scale, shift, w, gue)
    torch.cuda.synchronize()
    assert tconv.affine_relu_tconv.launches == fwd + 1
    assert tconv.affine_relu_tconv_backward.launches == bwd + 1
    _check_forward(got, tconv.affine_relu_tconv_reference(
        s, scale, shift, w, b), dtype)
    _check_backward(got_bwd, tconv.affine_relu_tconv_backward_reference(
        s, scale, shift, w, gue), dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
def test_kernels_repeat_bit_for_bit(cuda, dtype):
    """No float atomics: two launches on the same inputs agree exactly,
    the sums included."""
    s, scale, shift, w, b, gue = _inputs(150, 128, dtype, cuda, nm=8)
    for fn, args in ((tconv.affine_relu_tconv, (s, scale, shift, w, b)),
                     (tconv.affine_relu_tconv_backward,
                      (s, scale, shift, w, gue))):
        first, second = fn(*args), fn(*args)
        for p, q in zip(first, second):
            assert torch.equal(p, q)


@pytest.mark.gpu
def test_cuda_tensors_never_reach_the_plain_versions(cuda, monkeypatch):
    """Forward and backward of the op on CUDA tensors launch the kernels;
    the plain versions are not called, and the gradients equal theirs."""
    s, scale, shift, w, b, _ = _inputs(12, 16, torch.float32, cuda)
    refs = {name: getattr(tconv, name) for name in (
        "affine_relu_tconv_reference",
        "affine_relu_tconv_backward_reference")}

    def refuse(*args):
        raise AssertionError("a CUDA tensor reached a plain version")

    for name in refs:
        monkeypatch.setattr(tconv, name, refuse)
    args = [a.clone().requires_grad_() for a in (s, scale, shift, w, b)]
    u, s2, ss2 = tconv.affine_relu_tconv(*args)
    g = torch.randn_like(u)
    ((u * g).sum() + 0.1 * s2.sum() + 0.01 * ss2.sum()).backward()
    torch.cuda.synchronize()
    gue = g + 0.1 + 0.02 * u.detach()
    want = refs["affine_relu_tconv_backward_reference"](s, scale, shift, w,
                                                        gue)
    got = [a.grad for a in args]
    assert _rel(got[0], want[0]) <= OUT_TOL[torch.float32]
    for p, q in zip(got[1:], want[1:]):
        assert _rel(p, q) <= GRAD_TOL


@pytest.mark.gpu
def test_kernels_reject_a_strided_input(cuda):
    s, scale, shift, w, b, gue = _inputs(8, 16, torch.float32, cuda)
    with pytest.raises(ValueError):
        tconv.affine_relu_tconv(s[:, ::2], scale, shift, w, b)
    with pytest.raises(ValueError):
        tconv.affine_relu_tconv_backward(s, scale, shift, w,
                                         gue.transpose(0, 1))


@pytest.mark.gpu
def test_bf16_kernels_reject_an_odd_channel_count(cuda):
    """The tensor-core kernels load channels in pairs."""
    s, scale, shift, w, b, gue = _inputs(8, 15, torch.bfloat16, cuda)
    with pytest.raises(ValueError):
        tconv.affine_relu_tconv(s, scale, shift, w, b)
    with pytest.raises(ValueError):
        tconv.affine_relu_tconv_backward(s, scale, shift, w, gue)
