"""The port's entry points run on the CUDA card unless the caller asks for
the CPU: without a card they raise, before any work, instead of carrying
on on the CPU."""

import inspect

import numpy as np
import pytest
import torch

from skeleton_action_recognition_tpu_torch import serving
from skeleton_action_recognition_tpu_torch.cli import (
    main_gnn,
    main_spectrogram,
)
from skeleton_action_recognition_tpu_torch.models import stgcn


@pytest.fixture
def no_card(monkeypatch, tmp_path):
    """torch sees no CUDA device, and anything the trainers would write
    goes under ``tmp_path``."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.chdir(tmp_path)
    return tmp_path


@pytest.mark.parametrize("main,argv", [
    (main_gnn.main, ["--model", "stgcn", "--train-data-path", "missing",
                     "--test-data-path", "missing"]),
    (main_spectrogram.main, ["--data-path", "missing/{}.npy",
                             "--label-path", "missing/{}.pkl"]),
], ids=["main_gnn", "main_spectrogram"])
def test_trainer_raises_without_a_card(no_card, main, argv):
    """The default device is the card; asked for it without one, the
    trainer raises before it builds a model or writes a log directory."""
    assert inspect.signature(main).parameters["device"].default == "cuda"
    log_dir = no_card / "logs"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(argv + ["--log-dir", str(log_dir)])
    assert not log_dir.exists()


def test_predictor_raises_without_a_card(no_card):
    model = stgcn.Model(num_classes=4, remat=False)
    assert inspect.signature(serving.Predictor).parameters[
        "device"].default == "cuda"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serving.Predictor(model, max_batch=2)
    pred = serving.Predictor(model, max_batch=2, device="cpu")
    x = np.random.default_rng(0).normal(size=(1, 3, 8, 25, 2))
    probs = pred(x)
    assert probs.shape == (1, 4)
    np.testing.assert_allclose(probs.sum(-1), 1.0, rtol=1e-5)
