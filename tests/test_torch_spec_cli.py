"""The port's spectrogram trainer CLI: flags, the run name, and an
end-to-end run on a seeded synthetic ``.npy`` + pickled-label set with
the staged unfreeze and ``--resume``."""

import os
import pickle

import numpy as np
import pytest
import torch
import yaml

from skeleton_action_recognition_tpu.cli import main_spectrogram as jax_cli
from skeleton_action_recognition_tpu_torch.cli import main_spectrogram
from skeleton_action_recognition_tpu_torch.data.pipeline import NumpyDataset
from skeleton_action_recognition_tpu_torch.train import checkpoint
import torch_parity_helpers  # noqa: F401  (caps torch's threads)

SIZES = {"train": 8, "val": 6}  # 2 train steps and 2 eval batches of 4


def _flags(parser):
    return {
        opt: (action.default, action.required, tuple(action.choices or ()))
        for action in parser._actions for opt in action.option_strings
        if opt not in ("-h", "--help")
    }


def test_parser_has_the_jax_flags_and_defaults():
    want = _flags(jax_cli.get_parser())
    del want["--steps-per-dispatch"]  # a TPU dispatch knob, not ported
    assert _flags(main_spectrogram.get_parser()) == want


def test_run_name_leaves_out_what_the_jax_trainer_leaves_out():
    """As the JAX trainer: paths, seed, resume, step sizes, epochs and
    the save frequency are not in the name, nor a freeze epoch past the
    last epoch; the rest is, in the flags' order."""
    args = main_spectrogram.get_parser().parse_args(
        ["--num-epochs", "5", "--lambda-train-epoch", "2", "--notes", "n",
         "--seed", "3", "--log-dir", "L"])
    assert main_spectrogram.build_log_dir(args) == os.path.join(
        "L", "base_lr:0.1-num_classes:60-batch_size:64-num_filters:64-"
        "notes:n-model_type:resnet-lr_cycle:10-lambda_train_epoch:2-"
        "wavelength:None-num_pad_frames:250-use_pallas:True-"
        "use_pallas_stft:True-profile_dir:-dtype:float32-n")


def write_dataset(directory, t=30, num_classes=4, seed=0):
    """Seeded skeleton-like clips ``(n, 3, t, 25, 2)`` (one empty second
    body in each part) and their labels, in the reference's files
    ``{part}_data_joint.npy`` and ``{part}_label.pkl``."""
    rng = np.random.default_rng(seed)
    for part, n in SIZES.items():
        x = (rng.normal(size=(n, 3, t, 25, 2)) * 0.3).astype(np.float32)
        x[0, ..., 1] = 0.0
        np.save(os.path.join(directory, f"{part}_data_joint.npy"), x)
        labels = [int(v) for v in rng.integers(0, num_classes, n)]
        with open(os.path.join(directory, f"{part}_label.pkl"), "wb") as f:
            pickle.dump(([f"clip{i}" for i in range(n)], labels), f)
    return (os.path.join(directory, "{}_data_joint.npy"),
            os.path.join(directory, "{}_label.pkl"))


def test_numpy_dataset_batches_like_the_jax_one(tmp_path):
    """Same seed, same batches: a permutation per epoch, sorted indices in
    a batch, drop_remainder."""
    from skeleton_action_recognition_tpu.data.pipeline import (
        NumpyDataset as JaxNumpyDataset,
    )

    data, labels = write_dataset(str(tmp_path))
    kw = dict(batch_size=3, num_classes=4, shuffle=True,
              drop_remainder=True, seed=5)
    port = NumpyDataset(data.format("train"), labels.format("train"), **kw)
    ref = JaxNumpyDataset(data.format("train"), labels.format("train"), **kw)
    assert len(port) == len(ref) == 2
    for _ in range(2):  # two epochs: two permutations
        got, want = list(port.batches()), list(ref.batches())
        assert len(got) == len(want) == 2
        for (gx, gy), (wx, wy) in zip(got, want):
            np.testing.assert_array_equal(gx, wx)
            np.testing.assert_array_equal(gy, wy)


@pytest.mark.parametrize("use_kernels", [True, False],
                         ids=["kernel-route", "plain-route"])
def test_two_epochs_unfreezing_lambda_then_resume(tmp_path, use_kernels):
    """Epoch 0 frozen, epochs 1 and 2 with ``radar_lambda`` and
    ``radar_loc`` training: lambda stays bit for bit through epoch 0 and
    moves after epoch 1; the resumed run starts at epoch 2 from the
    checkpoint of epoch 1; config, checkpoints and events are written and
    every metric is finite. On the CPU the kernel route runs the kernels'
    plain versions."""
    data, labels = write_dataset(str(tmp_path))
    argv = [
        "--data-path", data, "--label-path", labels,
        "--log-dir", str(tmp_path / "logs"), "--num-classes", "4",
        "--num-filters", "8", "--num-pad-frames", "20", "--batch-size", "4",
        "--num-epochs", "2", "--save-freq", "1", "--base-lr", "0.01",
        "--lambda-train-epoch", "0", "--loc-train-epoch", "0",
    ]
    if not use_kernels:
        argv += ["--no-use-pallas", "--no-use-pallas-stft"]
    history = main_spectrogram.main(argv, device="cpu")
    resumed = main_spectrogram.main(
        [a if a != "2" else "3" for a in argv] + ["--resume"],
        device="cpu")

    assert [h["epoch"] for h in history + resumed] == [0, 1, 2]
    assert all(np.isfinite(v) for h in history + resumed
               for v in h.values())
    assert history[0]["radar_lambda"] == np.float32(5e-4)
    assert history[1]["radar_lambda"] != history[0]["radar_lambda"]
    assert resumed[0]["radar_lambda"] != history[1]["radar_lambda"]

    (run,) = os.listdir(tmp_path / "logs")
    run_dir = tmp_path / "logs" / run
    with open(run_dir / "config.yaml") as f:
        config = yaml.safe_load(f)
    assert config["lambda_train_epoch"] == 0 and config["resume"] is True
    assert config["log_dir"] == str(run_dir)
    manager = checkpoint.CheckpointManager(str(run_dir / "checkpoints"))
    assert manager.all_steps() == [0, 1, 2]
    assert any(name.startswith("events.") for name in os.listdir(run_dir))
    state = torch.load(run_dir / "checkpoints" / "2" / "state.pt",
                       weights_only=True)
    assert state["extra"] == {"epoch": 2}
    assert state["step"] == 3 * SIZES["train"] // 4
    lam = state["model"]["virtual_radar.radar_lambda"].item()
    assert lam == resumed[0]["radar_lambda"]


def test_resume_falls_back_to_the_model_when_the_optimizer_differs(
        tmp_path, capsys):
    """A checkpoint whose optimizer state does not fit the trainer's (here
    written with plain Adam) restores the model alone, as the JAX
    trainer's fallback does, and training goes on."""
    data, labels = write_dataset(str(tmp_path))
    argv = [
        "--data-path", data, "--label-path", labels,
        "--log-dir", str(tmp_path / "logs"), "--num-classes", "4",
        "--num-filters", "8", "--num-pad-frames", "20", "--batch-size", "4",
        "--num-epochs", "2",
    ]
    args = main_spectrogram.get_parser().parse_args(argv)
    run_dir = main_spectrogram.build_log_dir(args)
    from skeleton_action_recognition_tpu_torch.models import spectrogram

    model = spectrogram.Model(num_classes=4, num_filters=8,
                              num_pad_frames=20, wavelength=7e-4)
    adam = torch.optim.Adam(model.parameters())
    checkpoint.CheckpointManager(os.path.join(run_dir, "checkpoints")).save(
        0, model, adam, {"epoch": 0})
    history = main_spectrogram.main(argv + ["--resume"], device="cpu")
    assert "optimizer state does not fit" in capsys.readouterr().out
    assert [h["epoch"] for h in history] == [1]
    assert history[0]["radar_lambda"] == np.float32(7e-4)  # frozen
