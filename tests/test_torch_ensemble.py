"""The port's multi-stream ensemble against the JAX package's, on the same
bridged weights: per-stream softmax scores, the report over joint, bone
and spectrogram streams with unequal weights, and the refusals."""

import inspect
import os

import numpy as np
import pytest
import torch

from skeleton_action_recognition_tpu.cli import ensemble as jax_ensemble
from skeleton_action_recognition_tpu.data.pipeline import (
    TFRecordDataset as JaxTFRecordDataset,
    stream_transform as jax_stream_transform,
)
from skeleton_action_recognition_tpu.models import spectrogram as jax_spec
from skeleton_action_recognition_tpu.models import stgcn as jax_stgcn
from skeleton_action_recognition_tpu_torch.cli import ensemble, evaluate
from skeleton_action_recognition_tpu_torch.data import tfrecord
from skeleton_action_recognition_tpu_torch.data.pipeline import (
    TFRecordDataset,
    stream_transform,
)
from skeleton_action_recognition_tpu_torch.models import spectrogram, stgcn
from test_torch_evaluate import (
    NUM_CLASSES,
    SPEC,
    STGCN_LOGIT_TOL,
    assert_reports_agree,
    ranked_labels,
    save_checkpoints,
)
from torch_parity_helpers import randomized_variables

STREAMS = ("joint", "bone", "spectrogram")
WEIGHTS = ("1.0", "0.6", "0.3")
# The spectrogram checkpoint's wavelength: at the model's 5e-4 the two
# frameworks' spectrogram logits agree only to 5e-3 of their scale (f32
# rounding of a ~1e4 rad phase; test_torch_evaluate.py holds the CLI there);
# at a damped one they agree, as ST-GCN's do, to f32 rounding (measured
# 2.6e-6 and 3.6e-7 of their scale), so that every stream's probabilities
# are held to 1e-5 (measured <= 7e-7).
RADAR_LAMBDA = 0.1
SCORE_TOL = 1e-5


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """Seeded clips (T=16) as joint TFRecords; an ST-GCN checkpoint for
    each of the joint and bone streams and a spectrogram one (8 filters, 4
    frames padded between each two), each from its own seed; labels ranked
    off the weighted sum of the streams' probabilities, with each score's
    bound (``STGCN_LOGIT_TOL`` of each stream's logits)."""
    tmp = str(tmp_path_factory.mktemp("ensemble"))
    rng = np.random.default_rng(5)
    x = (rng.normal(size=(9, 3, 16, 25, 2)) * 0.3).astype(np.float32)
    x[-1, ..., 1] = 0.0
    ckpts, combined, err = {}, 0.0, 0.0
    for seed, (stream, weight) in enumerate(zip(STREAMS, WEIGHTS)):
        if stream == "spectrogram":
            # the JAX ensemble builds the spectrogram model without kernels
            jax_model = jax_spec.Model(num_classes=NUM_CLASSES, **SPEC)
            port_model = spectrogram.Model(num_classes=NUM_CLASSES, **SPEC)
            xs = x
        else:
            jax_model = jax_stgcn.Model(num_classes=NUM_CLASSES)
            port_model = stgcn.Model(num_classes=NUM_CLASSES)
            xs = stream_transform(stream)(x)
        variables = randomized_variables(jax_model, x, seed=10 + seed)
        if stream == "spectrogram":
            variables["params"]["virtual_radar"]["radar_lambda"] = (
                np.float32(RADAR_LAMBDA))
        ckpts[stream] = save_checkpoints(
            os.path.join(tmp, stream), jax_model, variables, port_model)
        with torch.no_grad():
            logits = port_model.eval()(torch.from_numpy(xs))
        probs = torch.softmax(logits, -1).numpy()
        combined = combined + float(weight) * probs
        # a softmax moves by at most exp(2 max |d logits|) - 1 of itself
        err = err + float(weight) * probs * np.expm1(
            2 * STGCN_LOGIT_TOL * logits.abs().max().item())
    labels = ranked_labels(combined)
    data = os.path.join(tmp, "val")
    tfrecord.write_dataset(x, labels, data, "val_data_joint", num_shards=2)
    return dict(ckpts=ckpts, combined=combined, err=err, data=data)


def _flags(parser):
    return {
        opt: (action.default, action.required, tuple(action.choices or ()))
        for action in parser._actions for opt in action.option_strings
        if opt not in ("-h", "--help")
    }


def test_parser_has_the_jax_flags_and_defaults():
    want = _flags(jax_ensemble.get_parser())
    assert _flags(ensemble.get_parser()) == want


def _argv(run, side):
    return ["--model", "stgcn", "--streams", *STREAMS,
            "--checkpoints", *(run["ckpts"][s][side] for s in STREAMS),
            "--weights", *WEIGHTS, "--num-classes", str(NUM_CLASSES),
            "--batch-size", "4", "--num-filters", "8",
            "--num-pad-frames", "4", "--test-data-path", run["data"]]


def test_report_equals_jax(run):
    want = jax_ensemble.main(_argv(run, 0))
    got = ensemble.main(_argv(run, 1), device="cpu")
    assert sorted(got) == sorted(want) == sorted(
        [f"{s}_top1" for s in STREAMS] + ["ensemble_top1", "ensemble_top5"])
    for stream in STREAMS:
        assert got[f"{stream}_top1"] == want[f"{stream}_top1"], stream
    ens = {k: v for k, v in got.items() if k.startswith("ensemble")}
    ref = {k: v for k, v in want.items() if k.startswith("ensemble")}
    assert_reports_agree(
        {"top1": ens["ensemble_top1"], "top5": ens["ensemble_top5"]},
        {"top1": ref["ensemble_top1"], "top5": ref["ensemble_top5"]},
        run["combined"], run["err"])
    # the labels were ranked off the combined scores
    assert (got["ensemble_top1"], got["ensemble_top5"]) == (
        round(3 / 9, 4), round(6 / 9, 4))


@pytest.mark.parametrize("stream", STREAMS)
def test_stream_scores_match_jax(run, stream):
    jax_ckpt, port_ckpt = run["ckpts"][stream]
    if stream == "spectrogram":
        jax_model = jax_spec.Model(num_classes=NUM_CLASSES, **SPEC)
        cls = spectrogram.Model
        transforms = (None, None)
    else:
        jax_model = jax_stgcn.Model(num_classes=NUM_CLASSES)
        cls = stgcn.Model
        transforms = (jax_stream_transform(stream), stream_transform(stream))
    jax_data = JaxTFRecordDataset(run["data"], batch_size=4,
                                  num_classes=NUM_CLASSES,
                                  transform=transforms[0])
    sample = jax_data._load_all()[0][:1]
    if transforms[0] is not None:
        sample = transforms[0](sample)
    want = jax_ensemble.stream_scores(jax_model, jax_ckpt, jax_data, sample)
    model = evaluate.build_model(cls, "cpu", NUM_CLASSES, 8, 4)
    got = ensemble.stream_scores(
        model, port_ckpt,
        TFRecordDataset(run["data"], batch_size=4, num_classes=NUM_CLASSES,
                        transform=transforms[1]),
        "cpu")
    assert got.shape == (9, NUM_CLASSES) and got.dtype == np.float32
    np.testing.assert_allclose(got.sum(-1), 1.0, atol=1e-6)
    np.testing.assert_allclose(got, want, rtol=0, atol=SCORE_TOL)


def test_unequal_lists_are_refused(run):
    argv = _argv(run, 1)
    argv[argv.index("--weights") + 1: argv.index("--weights") + 4] = ["1"]
    for main in (ensemble.main, jax_ensemble.main):
        with pytest.raises(ValueError, match="equal length"):
            main(argv)


def test_missing_checkpoint_is_refused(run, tmp_path):
    with pytest.raises(FileNotFoundError, match="no checkpoint"):
        ensemble.main(["--streams", "joint", "--checkpoints",
                       str(tmp_path / "none"), "--num-classes",
                       str(NUM_CLASSES), "--test-data-path", run["data"]],
                      device="cpu")


def test_ensemble_raises_without_a_card(monkeypatch, run):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert inspect.signature(ensemble.main).parameters[
        "device"].default == "cuda"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ensemble.main(_argv(run, 1))
