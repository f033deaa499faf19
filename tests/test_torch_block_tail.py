"""The fused ST-GCN block's tail (``ops/tconv.py::block_tail``: BN2's
normalize, the residual and the ReLU) and the fold that feeds the temporal
chain's backward (``tconv_gue``), on the CPU, where their plain versions
run: against autograd of the eager expressions they replace, and through
``FusedTemporalConv`` and ``STConvBlock`` in training and in eval.
"""

import pytest
import torch

from skeleton_action_recognition_tpu_torch.models import stgcn
from skeleton_action_recognition_tpu_torch.ops import tconv

RESIDUALS = {"none": None, "f32": torch.float32, "bf16": torch.bfloat16}


def _tail_inputs(dtype, res_dtype, seed=0, shape=(2, 6, 25, 8)):
    g = torch.Generator().manual_seed(seed)
    u = torch.randn(shape, generator=g, dtype=torch.float64).to(dtype)
    scale2 = torch.randn(shape[-1], generator=g, dtype=torch.float64)
    shift2 = torch.randn(shape[-1], generator=g, dtype=torch.float64)
    res = (None if res_dtype is None else
           torch.randn(shape, generator=g, dtype=torch.float64).to(res_dtype))
    acc = torch.float64 if dtype == torch.float64 else torch.float32
    return u, scale2.to(acc), shift2.to(acc), res


@pytest.mark.parametrize("with_res", [False, True])
def test_backward_reference_matches_autograd_of_the_eager_tail(with_res):
    """In float64: the plain backward's four gradients equal autograd's of
    ``relu(u * scale2 + shift2 + res)`` to rounding."""
    u, scale2, shift2, res = _tail_inputs(
        torch.float64, torch.float64 if with_res else None, seed=1)
    leaves = [t.requires_grad_() for t in (u, scale2, shift2, res)
              if t is not None]
    out = torch.relu(u * scale2 + shift2 + (0.0 if res is None else res))
    g_out = torch.randn(out.shape, dtype=torch.float64,
                        generator=torch.Generator().manual_seed(2))
    want = torch.autograd.grad(out, leaves, g_out)
    got = tconv.block_tail_backward_reference(
        g_out, out.detach(), u.detach(), scale2.detach(),
        torch.float64 if with_res else None)
    assert (got[3] is None) == (not with_res)
    for p, q in zip([x for x in got if x is not None], want):
        torch.testing.assert_close(p, q, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("with_res", [False, True])
def test_block_tail_passes_gradcheck(with_res):
    """The autograd Function (plain versions on the CPU) in float64; no
    pre-activation lies within 1e-3 of the ReLU's kink."""
    u, scale2, shift2, res = _tail_inputs(
        torch.float64, torch.float64 if with_res else None, seed=3,
        shape=(1, 3, 25, 4))
    pre = u * scale2 + shift2 + (0.0 if res is None else res)
    assert pre.abs().min() > 1e-3
    args = [t.requires_grad_() if t is not None else None
            for t in (u, scale2, shift2, res)]
    assert torch.autograd.gradcheck(tconv.BlockTail.apply, args, eps=1e-6,
                                    atol=1e-6)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_gue_is_the_fold_it_replaces(dtype):
    """``tconv_gue`` equals the eager fold of ``AffineReluTconv.backward``,
    ``(g_u.float() + g_sum + 2.0 * u.float() * g_sumsq).to(dtype)``, bit
    for bit."""
    g = torch.Generator().manual_seed(4)
    u, g_u = (torch.randn(2, 5, 25, 8, generator=g).to(dtype)
              for _ in range(2))
    g_sum, g_sumsq = torch.randn(8, generator=g), torch.randn(8, generator=g)
    want = (g_u.float() + g_sum + 2.0 * u.float() * g_sumsq).to(dtype)
    got = tconv.tconv_gue(g_u, u, g_sum, g_sumsq)
    assert got.dtype == dtype and torch.equal(got, want)


def _block(res_name):
    """A bf16 fused STConvBlock and its input: no residual (3 -> 64, as
    block 0), or the identity one on an f32 input (blocks 1-3, 6, 9) or a
    bf16 input (blocks 5 and 8, after a stride-2 block)."""
    in_channels = 3 if res_name == "none" else 64
    block = stgcn.STConvBlock(
        in_channels, 64, residual=res_name != "none", dtype=torch.bfloat16,
        fused_tconv=True, generator=torch.Generator().manual_seed(5))
    assert isinstance(block.tgcn, stgcn.FusedTemporalConv)
    x = torch.randn(2, 8, 25, in_channels,
                    generator=torch.Generator().manual_seed(6))
    return block, x.to(RESIDUALS[res_name] or torch.float32)


@pytest.mark.parametrize("res_name", list(RESIDUALS))
def test_fused_block_in_training_equals_the_eager_tail(res_name,
                                                       monkeypatch):
    """A training step's forward of a fused block: its output equals
    ``relu(u.float() * scale2 + shift2 + res)`` of the tensors the block
    hands the tail, bit for bit, with the residual absent, f32 and bf16;
    and the block's gradients equal those of the same block running that
    eager expression."""
    seen = []

    def recording(u, scale2, shift2, res=None):
        seen.append((u, scale2, shift2, res))
        return tconv.block_tail(u, scale2, shift2, res)

    def eager(u, scale2, shift2, res=None):
        return torch.relu(u.float() * scale2 + shift2
                          + (0.0 if res is None else res))

    a = torch.from_numpy(stgcn.spatial_adjacency())
    grads = {}
    for name, tail in (("kernels", recording), ("eager", eager)):
        block, x = _block(res_name)
        x.requires_grad_()
        monkeypatch.setattr(stgcn, "block_tail", tail)
        out = block.train()(x, a)
        out.square().sum().backward()
        grads[name] = [x.grad] + [p.grad for p in block.parameters()]
        if name == "kernels":
            (u, scale2, shift2, res), = seen
            assert (res is None) == (res_name == "none")
            if res is not None:
                assert res.dtype == x.dtype
            assert out.dtype == torch.float32
            assert torch.equal(out, eager(u, scale2, shift2, res))
    for p, q in zip(grads["kernels"], grads["eager"]):
        torch.testing.assert_close(p, q)


@pytest.mark.parametrize("res_name", list(RESIDUALS))
def test_fused_block_in_eval_keeps_its_plain_route(res_name, monkeypatch):
    """In eval no tail kernel runs: the block's output is the plain folded
    chain plus the residual through the ReLU, as the stock block adds
    it."""
    def refuse(*args):
        raise AssertionError("eval reached the block tail")

    monkeypatch.setattr(stgcn, "block_tail", refuse)
    block, x = _block(res_name)
    a = torch.from_numpy(stgcn.spatial_adjacency())
    block.eval()
    with torch.no_grad():
        got = block(x, a)
        # the eval chain as FusedTemporalConv ran it before it took the
        # residual, and the stock block's relu(x + res) after it
        bn0, conv, bn1 = (block.tgcn.BatchNorm_0, block.tgcn.Conv_0,
                          block.tgcn.BatchNorm_1)
        scale1, shift1 = bn0.folded_affine(bn0.running_mean,
                                           bn0.running_var)
        h = torch.relu(block.sgcn(x, a).float() * scale1 + shift1).to(
            torch.bfloat16)
        h = torch.nn.functional.pad(h, (0, 0, 0, 0, 4, 4))
        u = torch.nn.functional.conv2d(
            h.permute(0, 3, 1, 2), conv.weight.to(torch.bfloat16))
        u = u.permute(0, 2, 3, 1).float() + conv.bias
        scale2, shift2 = bn1.folded_affine(bn1.running_mean,
                                           bn1.running_var)
        y = u * scale2 + shift2
    want = torch.relu(y + (x if block.residual else 0.0))
    assert torch.equal(got, want)


def test_block_tail_rejects_what_the_kernels_do_not_take():
    u, scale2, shift2, res = _tail_inputs(torch.float32, torch.float32)
    with pytest.raises(TypeError):
        tconv.block_tail(u.double(), scale2, shift2, res)
    with pytest.raises(ValueError):
        tconv.block_tail(u, scale2[:3], shift2, res)
    with pytest.raises(ValueError):
        tconv.block_tail(u, scale2, shift2.double(), res)
    with pytest.raises(ValueError):
        tconv.block_tail(u, scale2, shift2, res[:1])
    with pytest.raises(ValueError):
        tconv.block_tail(u, scale2, shift2, res.half())
