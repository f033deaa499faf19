"""The port's folded serving predictors (``models/export.py``) against the
JAX package's, on one seeded set of variables of the full-width NTU-60
ST-GCN (the fold is written for its block plan), with short clips: T=16,
N=2, M=2. The JAX package's own ``tests/test_export.py`` trains on the
reference data, which this image lacks; here every BatchNorm's statistics
are drawn from a seed (variances in [0.5, 1.5]) in place of training steps,
bridged into the port with ``interop.flax_to_state_dict``.

Tolerances:

* folded weights: within ``WEIGHT_TOL`` of each tensor's largest entry
  (both fold the same float64 numbers in the same order; measured equal);
  the W8 weights byte for byte and their scales bit for bit;
* row quantization and the W8A8 int32 accumulators: equal;
* float32 logits: within ``F32_TOL`` of the largest |logit| of JAX's
  folded predictor (f32 sums in other orders; measured 4.9e-7), and within
  JAX's ``test_export.py`` bound ``STOCK_ATOL`` of the port's stock eval
  forward;
* bfloat16, W8 and W8A8 logits: within ``LOW_TOL`` of scale of JAX's same
  predictor (measured 3.0-4.9e-4), argmax equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skeleton_action_recognition_tpu.models import export as jax_export
from skeleton_action_recognition_tpu.models import stgcn as jax_stgcn
from skeleton_action_recognition_tpu_torch import interop, serving
from skeleton_action_recognition_tpu_torch.models import (
    export,
    stgcn,
    stgin,
    stpgcn,
)
from torch_parity_helpers import randomized_variables

N, T, M = 2, 16, 2
WEIGHT_TOL = 1e-6
F32_TOL = 1e-4
STOCK_ATOL = 2e-3
LOW_TOL = 2e-2
KINDS = {
    "f32": (lambda m: export.fused_stgcn_predictor(m, torch.float32, "cpu"),
            lambda v: jax_export.FusedSTGCNPredictor(
                v["params"], v["batch_stats"], jnp.float32)),
    "bf16": (lambda m: export.fused_stgcn_predictor(m, device="cpu"),
             lambda v: jax_export.FusedSTGCNPredictor(
                 v["params"], v["batch_stats"], jnp.bfloat16)),
    "w8": (lambda m: export.quantized_stgcn_predictor(m, "cpu"),
           lambda v: jax_export.QuantizedSTGCNPredictor(
               v["params"], v["batch_stats"])),
    "w8a8": (lambda m: export.int8_stgcn_predictor(m, "cpu"),
             lambda v: jax_export.Int8STGCNPredictor(
                 v["params"], v["batch_stats"])),
}


@pytest.fixture(scope="module")
def run():
    """Seeded clips, the JAX variables, the port's model holding them, and
    a cache of ``(port, jax, port logits, jax logits)`` per predictor kind,
    each built once."""
    x = np.random.default_rng(0).normal(size=(N, 3, T, 25, M)).astype(
        np.float32)
    variables = randomized_variables(jax_stgcn.Model(num_classes=60), x,
                                     seed=1)
    model = stgcn.Model(num_classes=60)
    model.load_state_dict(interop.flax_to_state_dict(variables))
    model.eval()
    with torch.no_grad():
        stock = model(torch.from_numpy(x)).numpy()
    return dict(x=x, variables=variables, model=model, stock=stock,
                built={})


def predictors(run, kind):
    if kind not in run["built"]:
        port_factory, jax_factory = KINDS[kind]
        port = port_factory(run["model"])
        jax_pred = jax_factory(run["variables"])
        run["built"][kind] = (
            port, jax_pred, port(run["x"]).numpy(),
            np.asarray(jax_pred(jnp.asarray(run["x"]))))
    return run["built"][kind]


def rel(got, want):
    want = np.asarray(want, np.float32)
    return np.abs(np.asarray(got, np.float32) - want).max() / np.abs(
        want).max()


@pytest.mark.parametrize("block", range(10))
def test_folded_f32_weights_equal_jax(run, block):
    port, jax_pred = predictors(run, "f32")[:2]
    got, want = port.weights[block], jax_pred.weights[block]
    assert rel(got["wf"].numpy(), want["wf"]) <= WEIGHT_TOL
    assert rel(got["bf"].numpy(), want["bf"]) <= WEIGHT_TOL
    # the port's conv kernel is OIHW, JAX's HWIO
    assert rel(got["ck"].permute(2, 3, 1, 0).numpy(), want["ck"]) \
        <= WEIGHT_TOL
    assert rel(got["cb"].numpy(), want["cb"]) <= WEIGHT_TOL
    assert (got["res"] is None) == (want["res"] is None)
    if got["res"] is not None:
        for g, w in zip(got["res"], want["res"]):
            assert rel(g.numpy(), w) <= WEIGHT_TOL
    assert port.static[block] == jax_pred.static[block]


def test_folded_bf16_weights_equal_jax(run):
    """bfloat16 rounds through float32 as ``jnp.asarray`` does: equal bit
    for bit, and the dtypes JAX keeps (f32 biases and head)."""
    port, jax_pred = predictors(run, "bf16")[:2]
    for got, want in zip(port.weights, jax_pred.weights):
        assert got["wf"].dtype == got["ck"].dtype == torch.bfloat16
        assert got["bf"].dtype == got["cb"].dtype == torch.float32
        np.testing.assert_array_equal(got["wf"].float().numpy(),
                                      np.asarray(want["wf"], np.float32))
        np.testing.assert_array_equal(
            got["ck"].float().permute(2, 3, 1, 0).numpy(),
            np.asarray(want["ck"], np.float32))
    np.testing.assert_array_equal(port.head[0].numpy().T,
                                  np.asarray(jax_pred.head[0]))


@pytest.mark.parametrize("block", range(10))
def test_w8_weights_equal_jax(run, block):
    """int8 weights byte for byte, their float32 scales bit for bit; the
    device holds no bfloat16 ``wf``."""
    port, jax_pred = predictors(run, "w8")[:2]
    got, want = port.weights[block], jax_pred.weights[block]
    assert "wf" not in got and got["wf_q"].dtype == torch.int8
    np.testing.assert_array_equal(got["wf_q"].numpy(),
                                  np.asarray(want["wf_q"]))
    assert got["wf_scale"].dtype == torch.float32
    np.testing.assert_array_equal(got["wf_scale"].numpy(),
                                  np.asarray(want["wf_scale"]))


def test_w8a8_weights_are_w8s_padded_column_major(run):
    """The W8A8 weights are W8's with zero rows up to a multiple of 8,
    column-major (cuBLASLt's int8 GEMM takes no row-major B)."""
    w8 = predictors(run, "w8")[0]
    w8a8 = predictors(run, "w8a8")[0]
    for got, want in zip(w8a8.weights, w8.weights):
        q, k = got["wf_q"], want["wf_q"].shape[0]
        assert q.shape[0] % 8 == 0 and q.shape[0] - k < 8
        assert q.t().is_contiguous()
        np.testing.assert_array_equal(q[:k].numpy(), want["wf_q"].numpy())
        assert not q[k:].any()
        np.testing.assert_array_equal(got["wf_scale"].numpy(),
                                      want["wf_scale"].numpy())
    assert w8a8.weights[0]["wf_q"].shape == (80, 1600)


def test_quantize_rows_equals_jax():
    rng = np.random.default_rng(3)
    x = (rng.normal(size=(4, 7, 33)) * 8).astype(np.float32)
    x[1, 2] = 0.0  # an all-zero row
    x[2, 3, :5] = [0.5, -0.5, 1.5, 2.5, -2.5]  # halves: round to even
    x[2, 3, 5] = 127.0  # its row's scale is 1
    q, scale = export.quantize_rows(torch.from_numpy(x))
    want_q, want_scale = jax_export._quantize_rows(jnp.asarray(x))
    assert q.dtype == torch.int8
    np.testing.assert_array_equal(q.numpy(), np.asarray(want_q))
    np.testing.assert_array_equal(scale.numpy(), np.asarray(want_scale))
    assert scale[1, 2] == 1.0 and not q[1, 2].any()
    assert q[2, 3, :5].tolist() == [0, 0, 2, 2, -2]
    # symmetric 8-bit: within half an LSB (tests/test_export.py's bound)
    deq = q.float().numpy() * scale.numpy()[..., None]
    assert np.abs(deq - x).max() <= scale.numpy().max() * 0.51
    qz, sz = export.quantize_rows(torch.zeros(2, 5))
    assert not qz.any() and (sz == 1.0).all()


@pytest.mark.parametrize("block", [0, 7])
def test_w8a8_accumulators_equal_jax(run, block):
    """Block 0 on its real input (K = 75, padded to 80 here), block 7 (K =
    3,200) on seeded int8 rows of 20 rows (padded to 24): the int32 sums
    equal JAX's ``dot_general`` of the same operands."""
    port, jax_pred = predictors(run, "w8a8")[:2]
    if block == 0:
        x = run["x"]
        flat = np.transpose(x, (0, 4, 2, 3, 1)).reshape(N * M * T, -1)
        qa, _ = export.quantize_rows(torch.from_numpy(flat))
    else:
        k = jax_pred.weights[block]["wf_q"].shape[0]
        qa = torch.from_numpy(np.random.default_rng(4).integers(
            -127, 128, size=(20, k)).astype(np.int8))
    got = export.int8_product(qa, port.weights[block]["wf_q"])
    want = jax.lax.dot_general(
        jnp.asarray(qa.numpy()), jax_pred.weights[block]["wf_q"],
        (((1,), (0,)), ((), ())), preferred_element_type=jnp.int32)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_folded_f32_logits(run):
    got, want = predictors(run, "f32")[2:]
    assert got.shape == (N, 60) and got.dtype == np.float32
    assert rel(got, want) <= F32_TOL
    np.testing.assert_allclose(got, run["stock"], rtol=0, atol=STOCK_ATOL)
    np.testing.assert_array_equal(got.argmax(-1), run["stock"].argmax(-1))


@pytest.mark.parametrize("kind", ["bf16", "w8", "w8a8"])
def test_low_precision_logits(run, kind):
    got, want = predictors(run, kind)[2:]
    assert got.dtype == np.float32 and np.isfinite(got).all()
    assert rel(got, want) <= LOW_TOL
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))


@pytest.mark.parametrize("kind", ["bf16", "w8", "w8a8"])
def test_predictor_serves_the_folded_routes(run, kind, monkeypatch):
    """``Predictor(fused=True, quantize=...)`` serves the softmax of the
    matching factory's predictor, built on the model and the predictor's
    device (the factories stand in, returning the predictors built above);
    the stock ``Predictor`` serves the model."""
    quantize = {"bf16": None, "w8": "w8", "w8a8": "w8a8"}[kind]
    calls = []
    for name in ("fused_stgcn_predictor", "quantized_stgcn_predictor",
                 "int8_stgcn_predictor"):
        monkeypatch.setattr(export, name, lambda model, device, name=name: (
            calls.append((name, model, device))
            or predictors(run, kind)[0]))
    pred = serving.Predictor(run["model"], max_batch=4, device="cpu",
                             fused=True, quantize=quantize)
    factory = {"bf16": "fused_stgcn_predictor",
               "w8": "quantized_stgcn_predictor",
               "w8a8": "int8_stgcn_predictor"}[kind]
    assert calls == [(factory, run["model"], torch.device("cpu"))]
    probs = pred(run["x"])
    want = torch.softmax(torch.from_numpy(predictors(run, kind)[2]), -1)
    np.testing.assert_allclose(probs, want.numpy(), rtol=0, atol=1e-6)
    assert serving.Predictor(run["model"], device="cpu")._forward is \
        run["model"]


@pytest.mark.parametrize("kwargs,match", [
    (dict(quantize="w8"), "quantize requires fused=True"),
    (dict(fused=True, quantize="int4"), "quantize must be None, 'w8'"),
], ids=["quantize_unfused", "unknown_quantize"])
def test_predictor_refuses_options(kwargs, match):
    model = stgcn.Model(num_classes=10)
    with pytest.raises(ValueError, match=match):
        serving.Predictor(model, device="cpu", **kwargs)


@pytest.mark.parametrize("build,match", [
    (lambda: stgin.Model(num_classes=10), "stock ST-GCN .* not .*stgin"),
    (lambda: stpgcn.Model(num_classes=10), "stock ST-GCN .* not .*stpgcn"),
    (lambda: stgcn.Model(num_classes=10, trainable_adjacency=True),
     "trainable_adjacency"),
], ids=["stgin", "stpgcn", "trainable_adjacency"])
@pytest.mark.parametrize("factory", [
    export.fused_stgcn_predictor, export.quantized_stgcn_predictor,
    export.int8_stgcn_predictor,
], ids=["folded", "w8", "w8a8"])
def test_only_the_stock_model_folds(build, match, factory):
    with pytest.raises(ValueError, match=match):
        factory(build(), device="cpu")


def test_another_block_plan_does_not_fold(monkeypatch):
    plan = list(stgcn.BLOCK_PLAN)
    plan[4] = (128, 1, True)
    monkeypatch.setattr(stgcn, "BLOCK_PLAN", tuple(plan))
    with pytest.raises(ValueError, match="block plan"):
        export.fused_stgcn_predictor(stgcn.Model(num_classes=10),
                                     device="cpu")


def test_the_folded_predictors_run_on_the_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    model = stgcn.Model(num_classes=10)
    for factory in (export.fused_stgcn_predictor,
                    export.quantized_stgcn_predictor,
                    export.int8_stgcn_predictor):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            factory(model)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serving.Predictor(model, fused=True, quantize="w8a8")
