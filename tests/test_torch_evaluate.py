"""The port's checkpoint evaluation against the JAX package's, on the same
bridged weights: ``Predictor.from_checkpoint`` (stock and folded), and
``cli/evaluate.py``'s reports for ST-GCN on TFRecords (every ``--stream``,
and the folded and int8 predictors) and for the spectrogram model on
``.npy`` + pickled labels, and its refusals. The JAX side restores from its
own checkpoint (Orbax), the port from its own (``torch.save``), both
written from one seeded set of variables."""

import inspect
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from skeleton_action_recognition_tpu import serving as jax_serving
from skeleton_action_recognition_tpu.cli import evaluate as jax_evaluate
from skeleton_action_recognition_tpu.models import spectrogram as jax_spec
from skeleton_action_recognition_tpu.models import stgcn as jax_stgcn
from skeleton_action_recognition_tpu.train import (
    TrainState,
    checkpoint as jax_ckpt,
)
from skeleton_action_recognition_tpu_torch import interop, serving
from skeleton_action_recognition_tpu_torch.cli import evaluate
from skeleton_action_recognition_tpu_torch.data import tfrecord
from skeleton_action_recognition_tpu_torch.data.pipeline import (
    stream_transform,
)
from skeleton_action_recognition_tpu_torch.models import spectrogram, stgcn
from skeleton_action_recognition_tpu_torch.train import checkpoint
from torch_parity_helpers import randomized_variables

NUM_CLASSES = 10
STEP = 3
# how far one framework's logits may lie from the other's, of their scale:
# ST-GCN's f32 sums in other orders (measured 3.6e-7); the spectrogram
# model's at its wavelength, 5e-4, where f32 rounding of a ~1e4 rad phase
# moves the return (tests/test_torch_spectrogram.py's LOGIT_TOL)
STGCN_LOGIT_TOL = 1e-5
SPEC_LOGIT_TOL = 5e-3
# how far the folded predictors' logits (bf16, W8, W8A8; either framework)
# may lie from the stock ones, of their scale (measured 2.7e-3 to 7.4e-3 in
# JAX): the reports' tie tolerance; and how far the port's folded
# probabilities may lie from JAX's
EXPORT_LOGIT_TOL = 2e-2
EXPORT_PROB_ATOL = 1e-3
SPEC = dict(num_filters=8, num_pad_frames=4)


def save_checkpoints(directory, jax_model, variables, port_model):
    """The variables as a JAX checkpoint (``<directory>/jax``, the whole
    train state, as the JAX trainers save it) and, bridged, as the port's
    (``<directory>/port``), both at step ``STEP``."""
    state = TrainState.create(
        apply_fn=jax_model.apply, params=variables["params"],
        batch_stats=variables["batch_stats"], tx=optax.sgd(0.1))
    manager = jax_ckpt.CheckpointManager(os.path.join(directory, "jax"))
    manager.save(STEP, jax.device_get(state), {"epoch": 0})
    manager.close()
    port_model.load_state_dict(interop.flax_to_state_dict(variables))
    checkpoint.CheckpointManager(os.path.join(directory, "port")).save(
        STEP, port_model)
    return os.path.join(directory, "jax"), os.path.join(directory, "port")


def ranked_labels(logits):
    """Labels at rank 0, 3 and 7 of ``logits`` in turn: top-1 1/3 and
    top-5 2/3 of the clips, so neither report is trivially 0 or 1."""
    order = np.argsort(-logits, axis=-1)
    ranks = np.asarray([0, 3, 7])[np.arange(len(logits)) % 3]
    return order[np.arange(len(logits)), ranks]


def assert_reports_agree(got, want, scores, err):
    """Equal reports. ``err`` bounds how far each of ``scores`` may lie on
    one side from the other (a scalar, or one bound a score). A clip whose
    k-th and (k+1)-th scores lie within their two bounds could count on one
    side and not the other, as rounding flips a near-tie; there is none in
    these seeded sets, which the first assertion shows, so the reports are
    held equal."""
    assert {k: v for k, v in got.items() if k not in ("top1", "top5")} == {
        k: v for k, v in want.items() if k not in ("top1", "top5")}
    order = np.argsort(-scores, axis=-1)
    ranked = np.take_along_axis(scores, order, -1)
    bound = np.take_along_axis(np.broadcast_to(err, scores.shape), order, -1)
    for key, k in (("top1", 1), ("top5", 5)):
        near = int((ranked[:, k - 1] - ranked[:, k]
                    <= bound[:, k - 1] + bound[:, k]).sum())
        assert near == 0, f"{near} clips near a {key} tie"
        assert got[key] == want[key], key


@pytest.fixture(scope="module")
def stgcn_run(tmp_path_factory):
    """Seeded clips (T=16) as TFRecords, labels ranked off the joint
    stream's logits, and the two checkpoints of one set of variables."""
    tmp = str(tmp_path_factory.mktemp("stgcn"))
    x = np.random.default_rng(0).normal(size=(9, 3, 16, 25, 2)).astype(
        np.float32)
    jax_model = jax_stgcn.Model(num_classes=NUM_CLASSES)
    variables = randomized_variables(jax_model, x, seed=1)
    apply = jax.jit(lambda v, xs: jax_model.apply(v, xs, train=False))
    logits = {
        stream: np.asarray(apply(variables,
                                 jnp.asarray(stream_transform(stream)(x))))
        for stream in ("joint", "bone", "joint_motion", "bone_motion")
    }
    labels = ranked_labels(logits["joint"])
    data = os.path.join(tmp, "val")
    tfrecord.write_dataset(x, labels, data, "val_data_joint", num_shards=2)
    ckpts = save_checkpoints(tmp, jax_model, variables,
                             stgcn.Model(num_classes=NUM_CLASSES))
    return dict(x=x, variables=variables, logits=logits, labels=labels,
                data=data, jax_ckpt=ckpts[0], port_ckpt=ckpts[1])


def _flags(parser):
    return {
        opt: (action.default, action.required, tuple(action.choices or ()))
        for action in parser._actions for opt in action.option_strings
        if opt not in ("-h", "--help")
    }


def test_parser_has_the_jax_flags_and_defaults():
    assert _flags(evaluate.get_parser()) == _flags(jax_evaluate.get_parser())


@pytest.mark.parametrize("stream", ["joint", "bone", "joint_motion",
                                    "bone_motion"])
def test_stgcn_report_equals_jax(stgcn_run, stream):
    argv = ["--model", "stgcn", "--test-data-path", stgcn_run["data"],
            "--num-classes", str(NUM_CLASSES), "--batch-size", "4",
            "--stream", stream]
    want = jax_evaluate.main(argv + ["--checkpoint", stgcn_run["jax_ckpt"]])
    got = evaluate.main(argv + ["--checkpoint", stgcn_run["port_ckpt"]],
                        device="cpu")
    assert got["samples"] == 9 and got["checkpoint_step"] == STEP
    logits = stgcn_run["logits"][stream]
    assert_reports_agree(got, want, logits,
                         STGCN_LOGIT_TOL * np.abs(logits).max())
    if stream == "joint":  # the labels were ranked off these logits
        assert (got["top1"], got["top5"]) == (round(3 / 9, 4),
                                              round(6 / 9, 4))


@pytest.mark.parametrize("fused", [False, True], ids=["stock", "fused"])
def test_predictor_from_checkpoint_matches_jax(stgcn_run, fused):
    x = stgcn_run["x"]
    want = jax_serving.Predictor.from_checkpoint(
        jax_stgcn.Model(num_classes=NUM_CLASSES), stgcn_run["jax_ckpt"],
        x[:1], max_batch=4)(x[:3])
    pred = serving.Predictor.from_checkpoint(
        stgcn.Model(num_classes=NUM_CLASSES, fused_sgcn=fused),
        stgcn_run["port_ckpt"], max_batch=4, device="cpu")
    got = pred(x[:3])
    assert got.shape == (3, NUM_CLASSES) and not pred.model.training
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    with pytest.raises(ValueError, match="exceeds max_batch"):
        pred(x[:5])


@pytest.mark.parametrize("predictor", ["folded", "int8"])
def test_stgcn_report_with_a_folded_predictor_equals_jax(stgcn_run,
                                                         predictor):
    """``--predictor folded`` (bfloat16) and ``int8`` (W8), as in JAX."""
    argv = ["--model", "stgcn", "--test-data-path", stgcn_run["data"],
            "--num-classes", str(NUM_CLASSES), "--batch-size", "4",
            "--predictor", predictor]
    want = jax_evaluate.main(argv + ["--checkpoint", stgcn_run["jax_ckpt"]])
    got = evaluate.main(argv + ["--checkpoint", stgcn_run["port_ckpt"]],
                        device="cpu")
    assert got["samples"] == 9 and got["predictor"] == predictor
    assert set(got) == set(want)
    logits = stgcn_run["logits"]["joint"]
    assert_reports_agree(got, want, logits,
                         EXPORT_LOGIT_TOL * np.abs(logits).max())
    assert (got["top1"], got["top5"]) == (round(3 / 9, 4), round(6 / 9, 4))


@pytest.mark.parametrize("quantize", [None, "w8", "w8a8"])
def test_folded_predictor_from_checkpoint_matches_jax(stgcn_run, quantize):
    """``Predictor.from_checkpoint(..., fused=True, quantize=...)`` against
    the JAX ``Predictor(fused=True, quantize=...)`` on the same
    variables."""
    x = stgcn_run["x"]
    variables = stgcn_run["variables"]
    want = jax_serving.Predictor(
        jax_stgcn.Model(num_classes=NUM_CLASSES), variables["params"],
        variables["batch_stats"], max_batch=4, fused=True,
        quantize=quantize)(x[:3])
    pred = serving.Predictor.from_checkpoint(
        stgcn.Model(num_classes=NUM_CLASSES), stgcn_run["port_ckpt"],
        max_batch=4, device="cpu", fused=True, quantize=quantize)
    got = pred(x[:3])
    assert got.shape == (3, NUM_CLASSES)
    np.testing.assert_allclose(got, want, rtol=0, atol=EXPORT_PROB_ATOL)
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))


def test_predictor_from_checkpoint_refuses_an_empty_directory(tmp_path):
    with pytest.raises(FileNotFoundError, match="no checkpoint"):
        serving.Predictor.from_checkpoint(
            stgcn.Model(num_classes=NUM_CLASSES), str(tmp_path / "none"),
            device="cpu")
    with pytest.raises(FileNotFoundError, match="no checkpoint"):
        jax_serving.Predictor.from_checkpoint(
            jax_stgcn.Model(num_classes=NUM_CLASSES), str(tmp_path / "jax"),
            np.zeros((1, 3, 16, 25, 2), np.float32))


def test_spectrogram_report_equals_jax(tmp_path):
    """``--data-path`` + ``--label-path``, 8 filters, 4 frames padded
    between each two (T=32), a partial last batch. The JAX model runs its
    radar kernel in interpret mode and its STFT in XLA; the port, on the
    CPU, the plain versions of both kernels."""
    x = (np.random.default_rng(2).normal(size=(5, 3, 32, 25, 2))
         * 0.3).astype(np.float32)
    x[-1, ..., 1] = 0.0
    jax_model = jax_spec.Model(num_classes=NUM_CLASSES, use_pallas=True,
                               **SPEC)
    variables = randomized_variables(jax_model, x, seed=3)
    port_model = spectrogram.Model(num_classes=NUM_CLASSES, **SPEC)
    ckpts = save_checkpoints(str(tmp_path), jax_model, variables,
                             port_model)
    with torch.no_grad():
        logits = port_model.eval()(torch.from_numpy(x)).numpy()
    labels = ranked_labels(logits)
    np.save(tmp_path / "val_data_joint.npy", x)
    with open(tmp_path / "val_label.pkl", "wb") as f:
        pickle.dump(([f"clip{i}" for i in range(5)],
                     [int(v) for v in labels]), f)
    argv = ["--model", "spectrogram", "--num-classes", str(NUM_CLASSES),
            "--num-filters", "8", "--num-pad-frames", "4",
            "--batch-size", "2",
            "--data-path", str(tmp_path / "val_data_joint.npy"),
            "--label-path", str(tmp_path / "val_label.pkl")]
    want = jax_evaluate.main(argv + ["--checkpoint", ckpts[0]])
    got = evaluate.main(argv + ["--checkpoint", ckpts[1]], device="cpu")
    assert got["samples"] == 5 and got["checkpoint_step"] == STEP
    assert_reports_agree(got, want, logits,
                         SPEC_LOGIT_TOL * np.abs(logits).max())
    assert (got["top1"], got["top5"]) == (0.4, 0.8)


def test_spectrogram_model_runs_the_kernel_routes(monkeypatch):
    """The evaluated spectrogram model takes both kernel routes (on the
    card the CUDA kernels; here their plain versions); an ST-GCN is the
    stock model."""
    built = evaluate.build_model(evaluate.model_class("spectrogram"), "cpu",
                                 NUM_CLASSES, 8, 4)
    assert built.virtual_radar.use_pallas
    assert built.virtual_radar.use_pallas_stft
    assert not torch.backends.cuda.matmul.allow_tf32
    gnn = evaluate.build_model(evaluate.model_class("stgcn"), "cpu",
                               NUM_CLASSES, 8, 4)
    assert isinstance(gnn, stgcn.Model)
    assert not any(getattr(m, "fused", False) for m in gnn.modules())


@pytest.mark.parametrize("argv,error,match", [
    ([], SystemExit, "exactly one of"),
    (["--test-data-path", "d", "--data-path", "x.npy", "--label-path",
      "y.pkl"], SystemExit, "exactly one of"),
    (["--data-path", "x.npy"], SystemExit, "requires --label-path"),
    (["--test-data-path", "d", "--model", "nosuch"], ValueError,
     "'nosuch' names no model: the models are experimental"),
    (["--test-data-path", "d", "--model", "gcn"], ValueError,
     "'gcn' names no model: .*stgcn, stgin, stpgcn, stpgcnp"),
    (["--data-path", "x.npy", "--label-path", "y.pkl", "--model",
      "spectrogram", "--predictor", "int8"], SystemExit, "predictor stock"),
    (["--test-data-path", "d", "--model", "stgin", "--predictor", "folded"],
     ValueError, "stock ST-GCN .* not .*stgin"),
    (["--test-data-path", "d", "--model", "stpgcn", "--predictor", "int8"],
     ValueError, "stock ST-GCN .* not .*stpgcn"),
], ids=["no_data", "both_data", "no_labels", "unported_model",
        "module_without_model", "spectrogram_int8", "stgin_folded",
        "stpgcn_int8"])
def test_evaluate_refuses(tmp_path, argv, error, match):
    with pytest.raises(error, match=match):
        evaluate.main(argv + ["--checkpoint", str(tmp_path)], device="cpu")
    if error is SystemExit:  # the JAX CLI's own refusals
        with pytest.raises(SystemExit, match=match):
            jax_evaluate.main(argv + ["--checkpoint", str(tmp_path)])


def test_evaluate_refuses_an_empty_checkpoint_directory(stgcn_run,
                                                        tmp_path):
    with pytest.raises(FileNotFoundError, match="no checkpoint"):
        evaluate.main(["--test-data-path", stgcn_run["data"],
                       "--num-classes", str(NUM_CLASSES),
                       "--checkpoint", str(tmp_path / "none")],
                      device="cpu")


def test_evaluate_raises_without_a_card(monkeypatch, stgcn_run):
    """The default device is the card; without one, ``main`` raises
    before it reads any data."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert inspect.signature(evaluate.main).parameters[
        "device"].default == "cuda"
    assert inspect.signature(
        serving.Predictor.from_checkpoint).parameters[
        "device"].default == "cuda"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        evaluate.main(["--test-data-path", "missing", "--checkpoint",
                       stgcn_run["port_ckpt"]])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serving.Predictor.from_checkpoint(
            stgcn.Model(num_classes=NUM_CLASSES), stgcn_run["port_ckpt"])


def test_inference_mode_leaves_the_constants_usable_in_training():
    """The ops keep device constants (the spline plan, index tensors,
    operators) per shape. Made first under ``torch.inference_mode`` (the
    CLI's and the predictor's), they must still serve a training step in
    the same process: an inference tensor cannot be saved for the backward
    (and, on the card, has no version for the monomials' check)."""
    x = (np.random.default_rng(6).normal(size=(2, 3, 13, 25, 2))
         * 0.3).astype(np.float32)  # a T no other test uses: fresh caches
    for kw in (dict(use_pallas=True, use_pallas_stft=True), {}):
        model = spectrogram.Model(num_classes=NUM_CLASSES, **SPEC, **kw)
        with torch.inference_mode():
            model.eval()(torch.from_numpy(x))
        model.train()
        xs = torch.from_numpy(x).requires_grad_()
        model(xs).sum().backward()
        assert torch.isfinite(xs.grad).all()
        assert model.virtual_radar.radar_lambda.grad is not None
