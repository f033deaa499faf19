"""The channels-first BatchNorm op (``ops/channel_norm.py``) on the CPU: its
plain version against ``F.batch_norm`` in training, the shape rule that
sizes the kernels' grid, the layout and access width the wrapper hands the
kernels, the checks that refuse what they do not take, and the route
``BatchNorm(axis=1)`` keeps on the CPU. The kernels themselves run in the
CUDA emulation (``test_torch_channel_norm_emulated.py``) and on the card
(``test_torch_channel_norm_gpu.py``)."""

import pytest
import torch
import torch.nn.functional as F

from skeleton_action_recognition_tpu_torch import tracing
from skeleton_action_recognition_tpu_torch.models import ctrgcn, layers
from skeleton_action_recognition_tpu_torch.ops import channel_norm

# the cell's (N*M, C, T*V) BatchNorm shapes at B = 128, T = 64, and the
# data BatchNorm's (N, M*V*C, T)
CELL_SHAPES = [(256, c, length) for c in (16, 32, 64, 128, 256)
               for length in (1600, 800, 400)] + [(128, 150, 64)]


def operands(shape, seed=0, dtype=torch.float32):
    g = torch.Generator().manual_seed(seed)
    c = shape[1]
    x = (torch.randn(shape, generator=g) * 2 + 3).to(dtype)
    w = torch.rand(c, generator=g) + 0.5
    b = torch.randn(c, generator=g)
    rm = torch.randn(c, generator=g) * 0.1
    rv = torch.rand(c, generator=g) + 0.5
    return x, w, b, rm, rv


@pytest.mark.parametrize("shape", [(4, 6, 5, 3), (3, 150, 2), (8, 3)])
def test_plain_version_is_batch_norm_in_training(shape):
    """On CPU tensors the op is the plain version: ``F.batch_norm``'s
    output, running statistics and gradients, and no launch."""
    x, w, b, rm, rv = operands(shape)
    x.requires_grad_(True)
    w.requires_grad_(True)
    b.requires_grad_(True)
    rm2, rv2 = rm.clone(), rv.clone()
    before = tracing.counters()
    y = channel_norm.channel_norm(x, w, b, rm, rv, 0.1, 1e-5)
    assert tracing.counters() == before
    want = F.batch_norm(x, rm2, rv2, w, b, True, 0.1, 1e-5)
    torch.testing.assert_close(y, want, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(rm, rm2)
    torch.testing.assert_close(rv, rv2)
    dy = torch.randn(y.shape, generator=torch.Generator().manual_seed(5))
    got = torch.autograd.grad(y, (x, w, b), dy)
    ref = torch.autograd.grad(want, (x, w, b), dy)
    for g, r in zip(got, ref):
        torch.testing.assert_close(g, r, rtol=1e-4, atol=1e-5)
    frozen = rm.clone()
    y16 = channel_norm.channel_norm(x.detach(), w, b, rm, rv, 0.1, 1e-5,
                                    update=False, out_dtype=torch.bfloat16)
    assert y16.dtype == torch.bfloat16 and torch.equal(rm, frozen)


@pytest.mark.parametrize("shape", CELL_SHAPES,
                         ids=lambda s: "x".join(map(str, s)))
def test_grid_fills_the_card_at_the_cell_shapes(shape):
    """Every launch of the cell spreads over the card, a few blocks on
    each of its 132 SMs, each block at least ``MIN_BLOCK_ELEMENTS``
    elements, and the chunks cover every plane."""
    n, c, length = shape
    ppc = channel_norm.planes_per_block(n, c, length)
    chunks = -(-n // ppc)
    assert 1 <= ppc <= n and (chunks - 1) * ppc < n <= chunks * ppc
    assert ppc * length >= channel_norm.MIN_BLOCK_ELEMENTS
    assert 2 * 132 <= chunks * c <= 2 * channel_norm.TARGET_BLOCKS


@pytest.mark.parametrize("n,c,length", [(1, 7, 3), (5, 1, 1), (300, 1, 2),
                                        (7, 70000, 1), (2, 3, 10**6)])
def test_grid_rule_at_the_edges(n, c, length):
    ppc = channel_norm.planes_per_block(n, c, length)
    assert 1 <= ppc <= n


def test_planes_keep_a_concatenation_slice_and_copy_the_rest():
    """A slice of a concatenation's gradient (each sample's channels
    contiguous) reaches the kernels as it is, with its samples' stride; a
    transposed tensor as a contiguous copy."""
    cat = torch.randn(4, 12, 5, 3)
    part = cat[:, 3:6]
    t, stride = channel_norm._planes(part)
    assert t.data_ptr() == part.data_ptr() and stride == 12 * 15
    swapped = torch.randn(4, 5, 3, 3).transpose(1, 2)
    t, stride = channel_norm._planes(swapped)
    assert t.is_contiguous() and stride == 45
    one = torch.randn(1, 3, 4)
    assert channel_norm._planes(one)[1] == 12


@pytest.mark.parametrize("make", [
    lambda: torch.randn(1, 5, 3).transpose(1, 2),
    lambda: torch.randn(1, 3, 5, 2).transpose(2, 3),
    lambda: torch.ones(()).expand(1, 3, 4),
    lambda: torch.randn(1, 3, 1, 5).expand(1, 3, 4, 5),
    lambda: torch.randn(2, 3, 1, 5).expand(2, 3, 4, 5),
], ids=["permuted", "transposed", "scalar_expanded", "frames_expanded",
        "two_expanded"])
def test_planes_copy_samples_that_are_not_contiguous(make):
    """One sample or many: where a sample's ``(C, ...)`` is not contiguous
    (a permuted view, the expanded gradient of a sum) the kernels get a
    contiguous copy with the samples' stride, and the values unchanged."""
    t = make()
    got, stride = channel_norm._planes(t)
    assert got.is_contiguous() and stride == t[0].numel()
    assert torch.equal(got, t)


def test_access_width_follows_length_strides_and_alignment():
    x = torch.empty(4, 16, 1600, dtype=torch.bfloat16)
    assert channel_norm._vec(1600, (x,), (x.stride(0),)) == 8
    assert channel_norm._vec(175, (x,), (16 * 175,)) == 1
    f = torch.empty(2, 3, 7500)
    assert channel_norm._vec(7500, (f,), (f.stride(0),)) == 4
    # a view that starts 4 bytes past the allocation's 16-byte boundary
    off = torch.empty(2 * 3 * 8 + 1)[1:].view(2, 3, 8)
    assert channel_norm._vec(8, (off,), (24,)) == 1


@pytest.mark.parametrize("bad", ["half", "double", "out", "weight",
                                 "shape", "one"])
def test_refuses_what_the_kernels_do_not_take(bad):
    """Off the CPU the op raises for what the kernels do not take (a meta
    tensor stands in for a CUDA one here), and never falls back."""
    x, w, b, rm, rv = (t.to("meta") for t in operands((4, 3, 5)))
    out = torch.float32
    if bad == "half":
        x = x.half()
    elif bad == "double":
        x = x.double()
    elif bad == "out":
        out = torch.float16
    elif bad == "weight":
        w = w.double()
    elif bad == "shape":
        x = x[0, 0]
    else:
        x = x[:1, :, :1]
    err = TypeError if bad in ("half", "double", "out") else ValueError
    with pytest.raises(err):
        channel_norm.channel_norm(x, w, b, rm, rv, 0.1, 1e-5,
                                  out_dtype=out)


def test_cpu_model_step_launches_nothing():
    """A CTR-GCN training step on the CPU keeps ``F.batch_norm``: no
    channel_norm launch."""
    model = ctrgcn.Model(num_classes=5, remat=False,
                         generator=torch.Generator().manual_seed(0),
                         block_plan=((8, 1, False), (16, 2, True)))
    x = torch.randn(2, 3, 6, 25, 2)
    before = tracing.counters()
    model(x).sum().backward()
    after = tracing.counters()
    assert after.get("launch.channel_norm_fwd", 0) == before.get(
        "launch.channel_norm_fwd", 0)
    assert after.get("launch.channel_norm_bwd", 0) == before.get(
        "launch.channel_norm_bwd", 0)
    bn = layers.BatchNorm(3, epsilon=layers.TORCH_EPSILON,
                          momentum=layers.TORCH_MOMENTUM, axis=1)
    xb = torch.randn(4, 3, 7)
    want = F.batch_norm(xb, torch.zeros(3), torch.ones(3), bn.weight,
                        bn.bias, True, 0.1, layers.TORCH_EPSILON)
    assert torch.equal(bn(xb), want)


def test_process_group_keeps_the_moments_route(monkeypatch):
    """In a process group ``BatchNorm(axis=1)`` takes the global batch's
    moments, as before this route existed: here ``active`` stands in for a
    group of one rank, whose global means are its own."""
    monkeypatch.setattr(layers, "active", lambda: True)
    bn = layers.BatchNorm(3, torch.bfloat16, epsilon=layers.TORCH_EPSILON,
                          momentum=layers.TORCH_MOMENTUM, axis=1)
    x = torch.randn(4, 3, 7, 5, generator=torch.Generator().manual_seed(2))
    xf, axes, shape = x.float(), (0, 2, 3), (-1, 1, 1)
    mean, sq = layers.moments(xf, axes)
    var = torch.clamp(sq - mean * mean, min=0.0)
    scale = torch.rsqrt(var + layers.TORCH_EPSILON) * bn.weight
    want = ((xf - mean.view(shape)) * scale.view(shape)
            + bn.bias.view(shape)).to(torch.bfloat16)
    assert torch.equal(bn(x), want)
    torch.testing.assert_close(bn.running_mean, 0.1 * mean)
