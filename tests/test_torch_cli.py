"""The port's GNN trainer CLI: flags, an end-to-end run with resume, and
the run directory's files (config, events, confusion image)."""

import os
import struct
import zlib

import numpy as np
import pytest
import torch
import yaml

from skeleton_action_recognition_tpu.cli import main_gnn as jax_main_gnn
from skeleton_action_recognition_tpu_torch.cli import main_gnn
from skeleton_action_recognition_tpu_torch.data import tfrecord
from skeleton_action_recognition_tpu_torch.ops import sgcn
from skeleton_action_recognition_tpu_torch.utils import config, confusion


def _flags(parser):
    return {
        opt: (action.default, action.required, tuple(action.choices or ()))
        for action in parser._actions for opt in action.option_strings
        if opt not in ("-h", "--help")
    }


def test_parser_has_the_jax_flags_and_defaults():
    want = _flags(jax_main_gnn.get_parser())
    del want["--steps-per-dispatch"]  # a TPU dispatch knob, not ported
    assert _flags(main_gnn.get_parser()) == want


def test_run_name_matches_the_jax_trainer():
    argv = ["--model", "stgcn", "--fused-sgcn", "--dtype", "bfloat16",
            "--precision", "highest", "--notes", "x"]
    port = main_gnn.get_parser().parse_args(argv)
    ref = jax_main_gnn.get_parser().parse_args(argv)
    assert main_gnn.build_log_dir(port) == jax_main_gnn.build_log_dir(ref)


def test_other_models_are_refused(tmp_path):
    """A name with no ``models.<name>.Model`` raises before anything is set
    up, listing the models there are."""
    with pytest.raises(ValueError, match="names no model: the models are "
                       "experimental, .*stgcn, stgin, stpgcn, stpgcnp"):
        main_gnn.main(["--model", "nosuch", "--log-dir", str(tmp_path)],
                      device="cpu")
    assert os.listdir(tmp_path) == []


@pytest.mark.parametrize("precision,tf32", [
    ("default", True), ("high", True), ("highest", False),
])
def test_precision_sets_both_tf32_switches(precision, tf32):
    before = (torch.backends.cuda.matmul.allow_tf32,
              torch.backends.cudnn.allow_tf32)
    try:
        main_gnn.set_precision(precision)
        assert torch.backends.cuda.matmul.allow_tf32 is tf32
        assert torch.backends.cudnn.allow_tf32 is tf32
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = before


def test_config_yaml_loads_back():
    args = dict(model="stgcn", base_lr=0.1, l2_weight=1e-05, steps=[10, 50],
                notes="", log_dir="logs/a:b-c", resume=False, seed=0,
                profile_dir="it's")
    assert yaml.safe_load(config.to_yaml(args)) == args


def test_confusion_png_is_a_valid_image():
    png, h, w = confusion.confusion_matrix_png(np.eye(4, dtype=np.int64), 3)
    assert (h, w) == (12, 12)
    assert png[:8] == b"\x89PNG\r\n\x1a\n"
    width, height = struct.unpack(">II", png[16:24])
    assert (width, height) == (12, 12)
    idat = png.index(b"IDAT")
    (length,) = struct.unpack(">I", png[idat - 4: idat])
    raw = zlib.decompress(png[idat + 4: idat + 4 + length])
    assert len(raw) == h * (1 + 4 * w)


@pytest.fixture
def tiny_tfrecords(tmp_path):
    rng = np.random.default_rng(0)
    for part, n in (("train", 6), ("val", 3)):
        x = rng.normal(size=(n, 3, 32, 25, 2)).astype(np.float32)
        tfrecord.write_dataset(
            x, np.arange(n) % 4, str(tmp_path / part), part, num_shards=2
        )
    return tmp_path / "train", tmp_path / "val"


def _events(run_dir):
    """{tag: [(step, value)]} of the scalar events in a run directory."""
    from tensorboard.backend.event_processing.event_accumulator import (
        EventAccumulator,
    )

    acc = EventAccumulator(str(run_dir))
    acc.Reload()
    return {
        tag: [(e.step, e.value) for e in acc.Scalars(tag)]
        for tag in acc.Tags()["scalars"]
    }, acc.Tags()["images"]


def test_main_gnn_end_to_end_with_resume(tiny_tfrecords, tmp_path):
    """T=32, B=2, 2 epochs with a checkpoint each, through the fused
    spatial conv (its plain versions on the CPU), then --resume for a
    third epoch in the same run directory."""
    train_dir, test_dir = tiny_tfrecords
    log_dir = tmp_path / "logs"
    argv = [
        "--model", "stgcn", "--batch-size", "2", "--num-epochs", "2",
        "--save-freq", "1", "--num-classes", "4",
        "--train-data-path", str(train_dir),
        "--test-data-path", str(test_dir), "--log-dir", str(log_dir),
        "--base-lr", "0.01", "--fused-sgcn",
        "--fused-sgcn-min-channels", "0",
    ]
    main_gnn.main(argv, device="cpu")
    (run,) = os.listdir(log_dir)
    run_dir = log_dir / run
    files = os.listdir(run_dir)
    assert {"config.yaml", "checkpoints", "stgcn.py"} <= set(files)
    with open(run_dir / "config.yaml") as f:
        cfg = yaml.safe_load(f)
    assert cfg["fused_sgcn"] is True and cfg["num_epochs"] == 2
    assert cfg["steps"] == [10, 50]
    assert "remat_block" in (run_dir / "stgcn.py").read_text()
    ckpts = sorted(int(d) for d in os.listdir(run_dir / "checkpoints"))
    assert ckpts == [0, 1, 2]

    main_gnn.main(argv[:5] + ["3"] + argv[6:] + ["--resume"], device="cpu")
    assert os.listdir(log_dir) == [run]
    ckpts = sorted(int(d) for d in os.listdir(run_dir / "checkpoints"))
    assert ckpts == [0, 1, 2, 3]
    state = torch.load(run_dir / "checkpoints" / "3" / "state.pt",
                       weights_only=True)
    assert state["extra"] == {"epoch": 2}
    assert state["step"] == 9  # 3 steps an epoch, three epochs
    scalars, images = _events(run_dir)
    # three epochs of 3 steps: two runs, the resumed one counting anew
    assert len(scalars["cross_entropy_loss"]) == 9
    assert [s for s, _ in scalars["epoch_test_acc"]] == [0, 1, 2]
    assert all(np.isfinite(v) for _, v in scalars["cross_entropy_loss"])
    assert images == ["Test Confusion Matrix"]


def test_main_gnn_trains_through_the_fused_op(tiny_tfrecords, tmp_path,
                                              monkeypatch):
    """With --fused-sgcn and the default min-channels 128 the six blocks
    of 128 and 256 channels go through the fused op, in the forward (twice
    with remat: once more in the recompute) and the backward; counted on
    the CPU by wrapping the plain versions the op calls there."""
    calls = {"fwd": 0, "bwd": 0}
    fwd, bwd = sgcn.graph_conv_reference, sgcn.graph_conv_backward_reference

    def count(name, fn):
        def wrapped(*args):
            calls[name] += 1
            return fn(*args)
        return wrapped

    monkeypatch.setattr(sgcn, "graph_conv_reference", count("fwd", fwd))
    monkeypatch.setattr(
        sgcn, "graph_conv_backward_reference", count("bwd", bwd)
    )
    train_dir, test_dir = tiny_tfrecords
    main_gnn.main([
        "--model", "stgcn", "--batch-size", "3", "--num-epochs", "1",
        "--num-classes", "4", "--train-data-path", str(train_dir),
        "--test-data-path", str(test_dir), "--log-dir",
        str(tmp_path / "logs"), "--fused-sgcn",
    ], device="cpu")
    # 2 train steps x 6 fused blocks x (2 forwards + 1 backward), and 1
    # eval batch of 3 clips x 6 forwards; the four 64-wide blocks take the
    # stock path, which does not go through the op
    assert calls["bwd"] == 2 * 6
    assert calls["fwd"] == 2 * 6 * 2 + 6


def test_main_gnn_freezes_a_trainable_adjacency_and_profiles(
    tiny_tfrecords, tmp_path
):
    """--trainable-adjacency with --freeze-graph-until past the run: the
    adjacency in the checkpoint is still the spatial-partition stack.
    --profile-dir writes a trace of one step; --stream bone trains on
    bones."""
    from skeleton_action_recognition_tpu_torch.graphs.ntu_rgb_d import (
        spatial_adjacency,
    )

    train_dir, test_dir = tiny_tfrecords
    log_dir, profile_dir = tmp_path / "logs", tmp_path / "profile"
    history = main_gnn.main([
        "--model", "stgcn", "--trainable-adjacency",
        "--freeze-graph-until", "99", "--batch-size", "2",
        "--num-epochs", "1", "--num-classes", "4", "--stream", "bone",
        "--train-data-path", str(train_dir),
        "--test-data-path", str(test_dir), "--log-dir", str(log_dir),
        "--profile-dir", str(profile_dir), "--base-lr", "0.05",
    ], device="cpu")
    assert [h["epoch"] for h in history] == [0]
    assert os.listdir(profile_dir) == ["train_step.trace.json"]
    (run,) = os.listdir(log_dir)
    state = torch.load(log_dir / run / "checkpoints" / "1" / "state.pt",
                       weights_only=True)
    np.testing.assert_array_equal(
        state["model"]["adjacency_matrix"].numpy(), spatial_adjacency()
    )
    assert state["step"] == 4  # the profiled step, then 3 of the epoch
