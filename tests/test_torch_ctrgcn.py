"""The port's CTR-GCN (``models/ctrgcn.py``) against the benchmark's plain
reference of the published model (``benchmark/reference/ctrgcn_ntu60.py``,
loaded by path with the benchmark's seeded weights) on the CPU, at a small
size that has every kind of block: no residual, an identity residual, a
projected one at stride 2, and a graph conv with and without ``down``.
Also the aggregation op's plain version, the channel-axis BatchNorm, remat
and serving."""

import pathlib
import statistics
import sys

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from skeleton_action_recognition_tpu_torch import tracing
from skeleton_action_recognition_tpu_torch.models import ctrgcn, layers
from skeleton_action_recognition_tpu_torch.ops import ctrgc
from skeleton_action_recognition_tpu_torch.serving import Predictor

BENCH_DIR = pathlib.Path(__file__).resolve().parent.parent / "benchmark"
if str(BENCH_DIR) not in sys.path:
    sys.path.insert(0, str(BENCH_DIR))

from harness import compare, inputs, manifest  # noqa: E402

REFERENCE = manifest.module("reference", "ctrgcn_ntu60")
BUILDER = manifest.module("models", "ctrgcn_ntu60")
CLASSES = 10
PLAN = [[16, 1, False], [16, 1, True], [32, 2, True], [32, 1, True],
        [32, 2, True]]
CONFIG = {"name": "ctrgcn_ntu60", **manifest.config("ctrgcn_ntu60"),
          "frames": 16, "num_classes": CLASSES, "blocks": PLAN}
# f32 against the reference in float64: the port's float32 rounding,
# amplified by BatchNorm over two clips through five blocks; the gradients
# of leaves whose sum cancels (alpha, a bias under BatchNorm) differ by
# ~1e-4 of their own norm and ~2e-5 of the median leaf's.
F32_TOL = {"logits": 1e-5, "loss": 1e-6, "grad": 1e-3}
# bf16: each block rounds its activations to bfloat16 (2^-8) several
# times; the logits move by ~4e-3 of their scale, the loss by ~1e-3, and
# over two clips the ReLU and max-pool boundaries that flip move single
# leaves' gradients by O(1) of their norm: the median leaf's difference
# (the benchmark's grad_diff) reads 0.20, its norm's gap 0.03.
BF16_TOL = {"logits": 2e-2, "loss": 1e-2, "grad_diff": 0.35, "grad_gap": 0.1}


def weights(seed=5, **zeroed):
    w = BUILDER.make_weights(CONFIG, seed, "cpu")
    for suffix in zeroed:
        for k in w:
            if k.endswith(f".{suffix}"):
                w[k] = torch.zeros_like(w[k])
    return w


def clips(n=2, seed=5):
    g = inputs.generator(seed, inputs.DATA_STREAM, "cpu")
    return (BUILDER.make_clips(CONFIG, n, g, "cpu"),
            inputs.one_hot_labels(n, CLASSES, g, "cpu"))


def port(w, dtype=None, remat=False):
    m = ctrgcn.Model(num_classes=CLASSES, dtype=dtype, remat=remat,
                     block_plan=[tuple(b) for b in PLAN])
    m.load_state_dict(w, strict=True)
    return m


def port_step(m, x, y):
    m.train()
    logits = m(x)
    loss = REFERENCE.cross_entropy(logits, y)
    names = [n for n, _ in m.named_parameters()]
    grads = torch.autograd.grad(loss, list(m.parameters()))
    return logits, loss, dict(zip(names, grads))


def reference_step(w, x, y):
    """The reference's logits, loss and gradients, computed in float64 and
    returned in float32 (in float32 its BatchNorm variance of a channel
    that is nearly constant over two clips moves a scale's gradient by 1%
    of the median leaf, where the port's is within 2e-5 of float64)."""
    keys = REFERENCE.trainable(REFERENCE.parameter_spec(CONFIG))
    wr = {k: v.double().requires_grad_(k in keys) for k, v in w.items()}
    logits = REFERENCE.forward(CONFIG, wr, x.double(), True)
    loss = REFERENCE.cross_entropy(logits, y.double())
    grads = torch.autograd.grad(loss, [wr[k] for k in keys])
    return (logits.float(), loss.float(),
            {k: g.float() for k, g in zip(keys, grads)})


def scaled(got, want):
    return ((got.float() - want).abs().max() / want.abs().max()).item()


def worst_grad(got, want):
    """The largest leaf's ``|port - reference|`` over the larger of its
    reference norm and the median leaf's."""
    norms = {k: g.norm().item() for k, g in want.items()}
    median = statistics.median(norms.values())
    return max((got[k] - want[k]).norm().item() / max(norms[k], median)
               for k in want)


def test_parameters_are_the_published_modules():
    """Every parameter and statistic of the port is the reference's, by
    name and shape, and the full model has CTR-GCN's 1.45 M parameters."""
    m = port(weights())
    spec = REFERENCE.parameter_spec(CONFIG)
    assert {k: tuple(v.shape) for k, v in m.state_dict().items()} == {
        k: tuple(shape) for k, (shape, _) in spec.items()}
    full = ctrgcn.Model(num_classes=60)
    full_spec = REFERENCE.parameter_spec(
        {**manifest.config("ctrgcn_ntu60")})
    n = sum(p.numel() for p in full.parameters())
    assert n == sum(int(np.prod(s)) for k, (s, kind) in full_spec.items()
                    if kind not in ("bn_mean", "bn_var"))
    assert 1.40e6 < n < 1.50e6


@pytest.mark.parametrize("zeroed", [(), ("alpha",), ("PA",)],
                         ids=["both", "alpha_zero", "pa_zero"])
def test_f32_matches_reference(zeroed):
    """Logits, loss and every leaf's gradient in f32, with the refinement
    and the static topology both on, and each alone (``alpha`` 0: ``S`` is
    ``PA``; ``PA`` 0: ``S`` is ``alpha Q``)."""
    w = weights(**dict.fromkeys(zeroed))
    x, y = clips()
    logits, loss, grads = port_step(port(w), x, y)
    want_logits, want_loss, want = reference_step(w, x, y)
    assert set(grads) == set(want)
    assert scaled(logits, want_logits) < F32_TOL["logits"]
    assert abs(loss.item() - want_loss.item()) < F32_TOL["loss"] * abs(
        want_loss.item())
    assert worst_grad(grads, want) < F32_TOL["grad"]
    # each half of S reaches the loss
    alphas = [k for k in want if k.endswith(".alpha")]
    conv4 = [k for k in want if k.endswith("conv4.weight")]
    if "alpha" in zeroed:
        assert all(want[k].norm() == 0 for k in conv4)
        assert any(want[k].abs().sum() > 0 for k in alphas)
    else:
        assert all(want[k].norm() > 0 for k in conv4)
    pa = [k for k in want if k.endswith(".PA")]
    assert all(want[k].norm() > 0 for k in pa)


def test_bf16_route_matches_reference():
    """The bf16 route (blocks in bfloat16, parameters, statistics and S in
    float32) against the f32 reference."""
    w = weights()
    x, y = clips()
    logits, loss, grads = port_step(port(w, torch.bfloat16), x, y)
    assert logits.dtype == torch.float32
    want_logits, want_loss, want = reference_step(w, x, y)
    assert scaled(logits, want_logits) < BF16_TOL["logits"]
    assert abs(loss.item() - want_loss.item()) < BF16_TOL["loss"] * abs(
        want_loss.item())
    norms = {k: v.norm().item() for k, v in want.items()}
    moved = compare.moved_leaves(norms)
    grad_diff = compare.median_of(compare.leaf_diffs(grads, want, norms,
                                                     moved))
    grad_gap = compare.median_gap({k: v.norm().item() for k, v in
                                   grads.items()}, norms, moved)
    assert grad_diff < BF16_TOL["grad_diff"]
    assert grad_gap < BF16_TOL["grad_gap"]


def test_eval_logits_match_reference():
    """Eval mode normalizes with the running statistics, as the
    reference's ``train=False``."""
    w = weights(seed=8)
    x, _ = clips(3, seed=8)
    m = port(w).eval()
    with torch.no_grad():
        got = m(x)
        want = REFERENCE.forward(
            CONFIG, {k: v.double() for k, v in w.items()}, x.double(),
            False).float()
    assert scaled(got, want) < F32_TOL["logits"]


def test_remat_keeps_gradients_and_statistics():
    """``remat`` recomputes each block from its input: the same gradients,
    and the running statistics updated once."""
    w = weights()
    x, y = clips()
    plain, rematted = port(w), port(w, remat=True)
    _, _, g1 = port_step(plain, x, y)
    _, _, g2 = port_step(rematted, x, y)
    for k in g1:
        torch.testing.assert_close(g2[k], g1[k], rtol=1e-5, atol=1e-7)
    s1, s2 = plain.state_dict(), rematted.state_dict()
    for k in s1:
        if "running" in k:
            torch.testing.assert_close(s2[k], s1[k])


def test_channel_aggregate_plain_version():
    """The op on CPU tensors is the published einsums' sum, its backward
    autograd's, in f32, and counts no launch."""
    g = torch.Generator().manual_seed(0)
    x3 = torch.randn(2, 3, 4, 7, 25, generator=g, requires_grad=True)
    s = torch.randn(2, 3, 4, 25, 25, generator=g, requires_grad=True)
    before = tracing.counters()
    z = ctrgc.channel_aggregate(x3, s)
    want = sum(torch.einsum("ncuv,nctv->nctu", s[:, k], x3[:, k])
               for k in range(3))
    torch.testing.assert_close(z, want)
    dz = torch.randn(z.shape, generator=g)
    dx3, ds = torch.autograd.grad(z, (x3, s), dz)
    want_dx3, want_ds = torch.autograd.grad(want, (x3, s), dz)
    torch.testing.assert_close(dx3, want_dx3)
    torch.testing.assert_close(ds, want_ds)
    assert tracing.counters() == before
    zb = ctrgc.channel_aggregate(x3.detach().bfloat16(), s.detach())
    assert zb.dtype == torch.bfloat16


@pytest.mark.parametrize("bad", ["dtype", "shape", "joints"])
def test_channel_aggregate_refuses(bad):
    x3 = torch.zeros(1, 3, 2, 4, 25)
    s = torch.zeros(1, 3, 2, 25, 25)
    if bad == "dtype":
        s = s.double()
    elif bad == "shape":
        s = s[:, :2]
    else:
        x3, s = torch.zeros(1, 3, 2, 4, 33), torch.zeros(1, 3, 2, 33, 33)
    with pytest.raises(ValueError):
        ctrgc.channel_aggregate(x3, s)


@pytest.mark.parametrize("shape", [(4, 6, 5), (3, 150, 2)])
def test_channels_first_batch_norm(shape):
    """``axis=1`` normalizes over every axis but the channels', as
    ``F.batch_norm`` in training, updates the running statistics with
    torch's momentum 0.1 (the unbiased variance, as ``nn.BatchNorm2d``),
    keeps them under ``frozen_stats`` and normalizes by them in eval; in
    ``dtype`` it returns that dtype. ``axis=-1`` is the channels-last
    layer it was."""
    g = torch.Generator().manual_seed(1)
    x = torch.randn(*shape, generator=g) * 3 + 1
    bn = layers.BatchNorm(shape[1], epsilon=layers.TORCH_EPSILON,
                          momentum=layers.TORCH_MOMENTUM, axis=1)
    with torch.no_grad():
        bn.weight.uniform_(0.5, 1.5, generator=g)
        bn.bias.normal_(generator=g)
    want = F.batch_norm(x, None, None, bn.weight, bn.bias, True,
                        eps=layers.TORCH_EPSILON)
    torch.testing.assert_close(bn(x), want, rtol=1e-5, atol=1e-5)
    axes = (0,) + tuple(range(2, x.ndim))
    torch.testing.assert_close(bn.running_mean, 0.1 * x.mean(axes))
    torch.testing.assert_close(
        bn.running_var, 0.9 + 0.1 * x.var(axes, unbiased=True))
    before = bn.running_mean.clone()
    with layers.frozen_stats(bn):
        bn(x + 1)
    torch.testing.assert_close(bn.running_mean, before)
    bn.eval()
    torch.testing.assert_close(
        bn(x), F.batch_norm(x, bn.running_mean, bn.running_var, bn.weight,
                            bn.bias, False, eps=layers.TORCH_EPSILON))
    bn.dtype = torch.bfloat16
    assert bn(x).dtype == torch.bfloat16
    last = layers.BatchNorm(shape[1], axis=-1)
    xl = x.movedim(1, -1)
    torch.testing.assert_close(
        last(xl), F.batch_norm(xl.reshape(-1, shape[1]), None, None,
                               last.weight, last.bias, True,
                               eps=layers.EPSILON).reshape(xl.shape),
        rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError):
        layers.BatchNorm(4, axis=0)


def test_predictor_serves_ctrgcn():
    """``Predictor``'s stock route serves the model: probabilities whose
    rows sum to 1, equal to the model's softmax in eval."""
    w = weights(seed=9)
    m = port(w)
    pred = Predictor(m, max_batch=4, device="cpu")
    x, _ = clips(3, seed=9)
    probs = pred(x.numpy())
    assert probs.shape == (3, CLASSES)
    np.testing.assert_allclose(probs.sum(-1), 1.0, rtol=1e-5)
    with torch.no_grad():
        want = torch.softmax(port(w).eval()(x), -1).numpy()
    np.testing.assert_allclose(probs, want, rtol=0, atol=1e-5)


def test_refinement_dropped_fault_moves_the_gradients():
    """The benchmark's fault ``no_refinement`` (``S = PA``) leaves conv4
    without a gradient and moves the others, which the comparison then
    sees."""
    w = weights()
    x, y = clips()
    m = port(w)
    BUILDER.drop_refinement(m)
    m.train()
    loss = REFERENCE.cross_entropy(m(x), y)
    loss.backward()
    assert all(p.grad is None for n, p in m.named_parameters()
               if n.endswith("conv4.weight"))
    _, want_loss, _ = reference_step(w, x, y)
    assert abs(loss.item() - want_loss.item()) > 1e-3 * want_loss.item()
