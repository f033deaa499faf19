"""CTR-GCN through the port's trainer and evaluator CLIs: ``main_gnn --model
ctrgcn`` for one short epoch on a tiny TFRecord set, then ``evaluate`` on
its checkpoint and ``Predictor.from_checkpoint``, and the options the
model is built with."""

import argparse
import os

import numpy as np
import torch

from skeleton_action_recognition_tpu_torch.cli import evaluate, main_gnn
from skeleton_action_recognition_tpu_torch.data import tfrecord
from skeleton_action_recognition_tpu_torch.data.pipeline import (
    TFRecordDataset,
)
from skeleton_action_recognition_tpu_torch.models import (
    ctrgcn,
    model_class,
    model_names,
)
from skeleton_action_recognition_tpu_torch.serving import Predictor

CLASSES = 4


def test_main_gnn_trains_and_evaluate_scores_ctrgcn(tmp_path):
    """One epoch of 2 steps (T=32, B=2) of the full-width model, its
    checkpoint scored by ``evaluate`` (a finite report over the 3 clips,
    equal to the one recomputed from ``Predictor.from_checkpoint``)."""
    rng = np.random.default_rng(0)
    for part, n in (("train", 4), ("val", 3)):
        x = rng.normal(size=(n, 3, 32, 25, 2)).astype(np.float32)
        tfrecord.write_dataset(x, np.arange(n) % CLASSES,
                               str(tmp_path / part), part, num_shards=2)
    log_dir = tmp_path / "logs"
    history = main_gnn.main([
        "--model", "ctrgcn", "--batch-size", "2", "--num-epochs", "1",
        "--num-classes", str(CLASSES), "--base-lr", "0.01",
        "--train-data-path", str(tmp_path / "train"),
        "--test-data-path", str(tmp_path / "val"), "--log-dir", str(log_dir),
    ], device="cpu")
    (run,) = os.listdir(log_dir)
    assert "ctrgcn.py" in os.listdir(log_dir / run)
    assert len(history) == 1 and np.isfinite(history[0]["train_loss"])
    ckpt = log_dir / run / "checkpoints"

    report = evaluate.main([
        "--model", "ctrgcn", "--checkpoint", str(ckpt), "--batch-size", "2",
        "--num-classes", str(CLASSES),
        "--test-data-path", str(tmp_path / "val"),
    ], device="cpu")
    assert report["samples"] == 3 and report["checkpoint_step"] == 1
    assert np.isfinite([report["top1"], report["top5"]]).all()

    x, labels = TFRecordDataset(str(tmp_path / "val"), 3,
                                num_classes=CLASSES)._load_all()
    predictor = Predictor.from_checkpoint(
        ctrgcn.Model(num_classes=CLASSES), str(ckpt), device="cpu")
    probs = predictor(x)
    assert probs.shape == (3, CLASSES) and np.isfinite(probs).all()
    np.testing.assert_allclose(probs.sum(-1), 1.0, rtol=1e-5)
    top1 = round(float((probs.argmax(-1) == np.asarray(labels)).mean()), 4)
    assert report["top1"] == top1


def test_ctrgcn_is_a_model_and_takes_only_its_options():
    """``--model ctrgcn`` names the class; of the trainer's model flags
    only ``--dtype`` reaches it (no fused spatial conv, no trainable
    adjacency option: ``PA`` always trains)."""
    assert "ctrgcn" in model_names()
    assert model_class("ctrgcn") is ctrgcn.Model
    arg = argparse.Namespace(
        num_classes=CLASSES, dtype="bfloat16", trainable_adjacency=True,
        fused_sgcn=True, fused_sgcn_min_channels=128)
    got = main_gnn.model_options(ctrgcn.Model, arg)
    assert got == {"num_classes": CLASSES, "dtype": torch.bfloat16}
    model = ctrgcn.Model(**got)
    assert model.l1.gcn1.PA.requires_grad
