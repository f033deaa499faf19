"""The GNN zoo through the port's trainer and evaluator CLIs: ``main_gnn
--model stgin|stpgcnp`` for one short epoch on a tiny TFRecord set, then
``evaluate`` on its checkpoint, and the options each model is built with."""

import argparse
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skeleton_action_recognition_tpu.models import (
    experimental as jax_experimental,
    stgcn as jax_stgcn,
    stgin as jax_stgin,
    stpgcn as jax_stpgcn,
    stpgcnp as jax_stpgcnp,
)
from skeleton_action_recognition_tpu_torch import interop
from skeleton_action_recognition_tpu_torch.cli import evaluate, main_gnn
from skeleton_action_recognition_tpu_torch.data import tfrecord
from skeleton_action_recognition_tpu_torch.models import model_class
from skeleton_action_recognition_tpu_torch.serving import Predictor

CLASSES = 4
# the port's probabilities against the JAX model's on the bridged
# checkpoint: f32 sums in other orders (ST-PGCN-P's pools are the least
# well-conditioned part, test_torch_zoo.py)
PROB_TOL = 1e-4


@pytest.fixture(scope="module")
def tiny_tfrecords(tmp_path_factory):
    root = tmp_path_factory.mktemp("data")
    rng = np.random.default_rng(0)
    for part, n in (("train", 4), ("val", 3)):
        x = rng.normal(size=(n, 3, 32, 25, 2)).astype(np.float32)
        tfrecord.write_dataset(x, np.arange(n) % CLASSES, str(root / part),
                               part, num_shards=2)
    return root / "train", root / "val"


@pytest.mark.parametrize("name,jax_model", [
    ("stgin", jax_stgin.Model(num_classes=CLASSES, remat=False)),
    ("stpgcnp", jax_stpgcnp.Model(num_classes=CLASSES)),
])
def test_main_gnn_trains_and_evaluate_scores_a_zoo_model(
        name, jax_model, tiny_tfrecords, tmp_path):
    """One epoch of 2 steps (T=32, B=2), its checkpoint scored by
    ``evaluate`` (a finite report over the 3 clips, equal to the one
    recomputed from ``Predictor.from_checkpoint``), and the checkpoint
    bridged to the JAX model, which gives the port's probabilities."""
    train_dir, test_dir = tiny_tfrecords
    log_dir = tmp_path / "logs"
    history = main_gnn.main([
        "--model", name, "--batch-size", "2", "--num-epochs", "1",
        "--num-classes", str(CLASSES), "--base-lr", "0.01",
        "--train-data-path", str(train_dir),
        "--test-data-path", str(test_dir), "--log-dir", str(log_dir),
    ], device="cpu")
    (run,) = os.listdir(log_dir)
    assert f"{name}.py" in os.listdir(log_dir / run)  # the chosen class
    assert len(history) == 1 and np.isfinite(history[0]["train_loss"])
    ckpt = log_dir / run / "checkpoints"

    report = evaluate.main([
        "--model", name, "--checkpoint", str(ckpt), "--batch-size", "2",
        "--num-classes", str(CLASSES), "--test-data-path", str(test_dir),
    ], device="cpu")
    assert report["samples"] == 3 and report["checkpoint_step"] == 1
    assert np.isfinite([report["top1"], report["top5"]]).all()

    x, labels = _load(test_dir)
    predictor = Predictor.from_checkpoint(
        model_class(name)(num_classes=CLASSES), str(ckpt), device="cpu")
    probs = predictor(x)
    assert probs.shape == (3, CLASSES) and np.isfinite(probs).all()
    top1 = round(float((probs.argmax(-1) == labels).mean()), 4)
    assert report["top1"] == top1

    variables = interop.state_dict_to_flax(predictor.model.state_dict())
    want = np.asarray(jax.nn.softmax(jax_model.apply(
        variables, jnp.asarray(x), False)))
    np.testing.assert_allclose(probs, want, rtol=0, atol=PROB_TOL)


def _load(test_dir):
    from skeleton_action_recognition_tpu_torch.data.pipeline import (
        TFRecordDataset,
    )

    x, y = TFRecordDataset(str(test_dir), 3, num_classes=CLASSES)._load_all()
    return x, np.asarray(y)


JAX_MODELS = {
    "stgcn": jax_stgcn.Model, "stgin": jax_stgin.Model,
    "stpgcn": jax_stpgcn.Model, "stpgcnp": jax_stpgcnp.Model,
    "experimental": jax_experimental.Model,
}


@pytest.mark.parametrize("name", list(JAX_MODELS))
def test_models_get_the_options_the_jax_trainer_passes(name):
    """``--dtype bfloat16 --trainable-adjacency --fused-sgcn`` reach a model
    only as options its signature takes, the same ones the JAX trainer
    passes from its dataclass fields; no zoo model gains a fused option."""
    arg = argparse.Namespace(
        num_classes=CLASSES, dtype="bfloat16", trainable_adjacency=True,
        fused_sgcn=True, fused_sgcn_min_channels=128)
    got = main_gnn.model_options(model_class(name), arg)
    fields = JAX_MODELS[name].__dataclass_fields__
    want = {"num_classes"} | {
        k for k in ("dtype", "trainable_adjacency", "fused_sgcn",
                    "fused_sgcn_min_channels") if k in fields}
    assert set(got) == want
    if "dtype" in got:
        assert got["dtype"] is torch.bfloat16
    if name == "stgcn":  # fused and trainable exclude each other there
        return
    assert "fused_sgcn" not in got
    model = model_class(name)(**got)
    if "trainable_adjacency" in got:
        assert model.adjacency_matrix.requires_grad
