"""Data parallelism in the port against the JAX package: the spectrogram
step, the multi-host layout, the trainer on two ranks, and serving,
evaluation and ensembles on two devices.

As in ``test_torch_parallel.py``, two gloo ranks on the CPU
(``tests/test_torch_parallel_worker.py``, ``file://`` rendezvous under
``tmp_path``) train on their rows. ``tests/test_multihost.py``'s semantics: processes
that read disjoint shards with a local batch of global / processes equal
one process on the process-order concatenation.
"""

import os
import pickle
import subprocess
import sys

import flax.linen as flax_nn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from skeleton_action_recognition_tpu.models import spectrogram as jax_spec
from skeleton_action_recognition_tpu.train import make_train_step
from skeleton_action_recognition_tpu.train import steps as jax_steps
from skeleton_action_recognition_tpu.train.train_state import (
    create_train_state,
)
from skeleton_action_recognition_tpu_torch.cli import ensemble, evaluate
from skeleton_action_recognition_tpu_torch.data import tfrecord
from skeleton_action_recognition_tpu_torch.models import stgcn
from skeleton_action_recognition_tpu_torch.parallel.sharding import (
    DataParallel,
)
from skeleton_action_recognition_tpu_torch.serving import Predictor
from skeleton_action_recognition_tpu_torch.train.checkpoint import (
    CheckpointManager,
)
import test_torch_parallel_worker
from test_torch_spectrogram import skeletons
from torch_parity_helpers import (
    WORKER,
    Ranks,
    assert_ranks_equal,
    assert_state_close,
    jax_init,
    jax_one_device,
)

# tests/test_parallel.py's tolerance for the sharded against the one-device
# step; the port's loss against JAX's on one device
PARAM_ATOL = 3e-4
LOSS_RTOL = 1e-4


def test_two_ranks_spectrogram_step_match_jax_one_device(tmp_path):
    """tests/test_parallel.py's spectrogram step (its small model, 8 clips
    of T=30, SGD, the radar frozen) on two ranks of 4 clips against the
    JAX step on all 8, and against the port's own step on all 8 to 1e-5
    of each value.

    Two f32 spectrograms (XLA's FFT and torch's) give the first conv
    gradients that agree to ~1% (at a damped wavelength of 10; ~1e-3 of
    the logits' scale at the model's 5e-4, tests/test_torch_radar_train.py):
    at the JAX test's SGD 1e-2 that alone moves conv1 by 3.1e-4 against a
    2.8e-2 step, on one device as on two. So the step is SGD 1e-3, where
    the layout's faults (per-rank statistics, unsummed gradients: half a
    step) still show at the JAX test's atol."""
    small = dict(num_classes=4, num_filters=8, image_size=64,
                 num_pad_frames=4, wavelength=10.0)
    x = skeletons(n=8, t=30, seed=3)
    y = np.eye(4, dtype=np.float32)[np.arange(8) % 4]
    state, init = jax_init(jax_spec.Model(**small), x, optax.sgd(1e-3))
    job = dict(model="spectrogram", options=small, state=init, lr=1e-3,
               global_batch=8, xs=[x], ys=[y])
    ranks = Ranks(tmp_path, job)
    alone = test_torch_parallel_worker.run(job, DataParallel())
    loss, want = jax_one_device(
        state, x, y, jax_steps.make_radar_train_step(global_batch_size=8))
    results = ranks.wait()
    assert_ranks_equal(results)
    (m,) = results[0]["metrics"]
    assert m["count"] == 8
    np.testing.assert_allclose(m["loss"], loss, rtol=LOSS_RTOL)
    assert_state_close(results[0]["state"], want, PARAM_ATOL)
    # the same arithmetic but for the order of the f32 sums over the rows
    assert_state_close(results[0]["state"], alone["state"], 1e-6, 1e-5)


class JaxTinyModel(flax_nn.Module):
    """tests/test_multihost.py's ``TinyModel``."""

    num_classes: int = 4

    @flax_nn.compact
    def __call__(self, x, train: bool = False):
        x = x.reshape(x.shape[0], -1)
        x = flax_nn.Dense(16)(x)
        x = flax_nn.BatchNorm(use_running_average=not train)(x)
        return flax_nn.Dense(self.num_classes)(flax_nn.relu(x))


def tiny_state_dict(variables):
    """The flax TinyModel's variables as the port's TinyModel's state
    dict (a Dense kernel ``(in, out)`` is a Linear weight ``(out, in)``)."""
    p, s = variables["params"], variables["batch_stats"]
    t = lambda a: torch.from_numpy(np.array(a, np.float32))  # noqa: E731
    return {
        "Dense_0.weight": t(p["Dense_0"]["kernel"]).T.contiguous(),
        "Dense_0.bias": t(p["Dense_0"]["bias"]),
        "BatchNorm_0.weight": t(p["BatchNorm_0"]["scale"]),
        "BatchNorm_0.bias": t(p["BatchNorm_0"]["bias"]),
        "BatchNorm_0.running_mean": t(s["BatchNorm_0"]["mean"]),
        "BatchNorm_0.running_var": t(s["BatchNorm_0"]["var"]),
        "Dense_1.weight": t(p["Dense_1"]["kernel"]).T.contiguous(),
        "Dense_1.bias": t(p["Dense_1"]["bias"]),
    }


def test_two_ranks_on_disjoint_shards_match_jax_one_process(tmp_path):
    """tests/test_multihost.py's layout: 16 clips in 2 shards, each rank
    reading its shard (``process_index`` / ``process_count``) with a local
    batch of 4, two steps of SGD 0.1, against JAX's one process on the
    process-order concatenation of the ranks' rows; the running statistics
    equal on both ranks and within 1e-5 of JAX's."""
    rng = np.random.default_rng(0)
    data = rng.normal(size=(16, 3, 12, 25, 2)).astype(np.float32)
    labels = np.arange(16) % 4
    tfrecord.write_dataset(data, labels, str(tmp_path / "ds"), "t",
                           num_shards=2)

    model = JaxTinyModel()
    state = create_train_state(model, jax.random.key(0),
                               jnp.asarray(data[:1]), optax.sgd(0.1))
    init = jax.device_get({"params": state.params,
                           "batch_stats": state.batch_stats})
    step = jax.jit(make_train_step(global_batch_size=8), static_argnums=3)
    onehot = np.eye(4, dtype=np.float32)[labels]
    for i in range(2):
        idx = np.concatenate([np.arange(4 * i, 4 * i + 4),
                              np.arange(8 + 4 * i, 8 + 4 * i + 4)])
        state, metrics = step(state, jnp.asarray(data[idx]),
                              jnp.asarray(onehot[idx]), False)
    want = tiny_state_dict(jax.device_get(
        {"params": state.params, "batch_stats": state.batch_stats}))

    results = Ranks(tmp_path, dict(
        model="tiny", in_features=3 * 12 * 25 * 2, num_classes=4,
        state=tiny_state_dict(init), lr=0.1, global_batch=8,
        data_dir=str(tmp_path / "ds"))).wait()
    assert_ranks_equal(results)
    assert [r["rows"] for r in results] == [[4, 4], [4, 4]]
    np.testing.assert_allclose(results[0]["metrics"][-1]["loss"],
                               float(metrics["loss"]), rtol=1e-5)
    assert_state_close(results[0]["state"], want, 1e-5)


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    """A seeded small-class ST-GCN's checkpoint and 9 T=8 test clips."""
    root = tmp_path_factory.mktemp("devices")
    model = stgcn.Model(num_classes=10,
                        generator=torch.Generator().manual_seed(5))
    CheckpointManager(str(root / "ckpt")).save(3, model)
    rng = np.random.default_rng(5)
    x = rng.normal(size=(9, 3, 8, 25, 2)).astype(np.float32)
    tfrecord.write_dataset(x, rng.integers(0, 10, 9), str(root / "data"),
                           "val", num_shards=2)
    return root, x


@pytest.mark.parametrize("fused", [False, True], ids=["stock", "folded"])
def test_predictor_on_two_devices_equals_one(checkpoint, fused):
    root, x = checkpoint
    make = lambda **kw: Predictor.from_checkpoint(  # noqa: E731
        stgcn.Model(num_classes=10), str(root / "ckpt"), max_batch=8,
        device="cpu", fused=fused, **kw)
    one, two = make(), make(devices=["cpu", "cpu"])
    for n in (1, 5, 8):
        np.testing.assert_allclose(two(x[:n]), one(x[:n]), rtol=1e-5,
                                   atol=1e-6)
    with pytest.raises(ValueError, match="divide"):
        Predictor(stgcn.Model(num_classes=10), max_batch=5, device="cpu",
                  devices=["cpu", "cpu"])


def test_evaluate_and_ensemble_on_two_devices_equal_one(checkpoint):
    root, _ = checkpoint
    ckpt, data = str(root / "ckpt"), str(root / "data")
    argv = ["--model", "stgcn", "--num-classes", "10", "--checkpoint", ckpt,
            "--test-data-path", data, "--batch-size", "4"]
    want = evaluate.main(argv, device="cpu")
    assert evaluate.main(argv, device="cpu", devices=["cpu", "cpu"]) == want
    assert want["samples"] == 9
    argv = ["--model", "stgcn", "--num-classes", "10", "--streams", "joint",
            "bone", "--checkpoints", ckpt, ckpt, "--weights", "1", "0.5",
            "--test-data-path", data, "--batch-size", "4"]
    want = ensemble.main(argv, device="cpu")
    assert ensemble.main(argv, device="cpu", devices=["cpu", "cpu"]) == want


def test_eval_devices_takes_every_card_only_when_asked_for_cuda():
    assert evaluate.eval_devices("cpu") == [torch.device("cpu")]
    assert evaluate.eval_devices("cpu", ["cpu", "cpu"]) == [
        torch.device("cpu")] * 2


def test_the_trainer_runs_on_two_ranks(tmp_path):
    """``main_gnn`` under two gloo ranks (``torchrun``'s environment, one
    process each): each rank reads its shard, both report the same global
    history, and only rank 0 writes the run directory's checkpoints and
    summaries."""
    rng = np.random.default_rng(1)
    for part, n in (("train", 16), ("val", 6)):
        tfrecord.write_dataset(
            rng.normal(size=(n, 3, 8, 25, 2)).astype(np.float32),
            rng.integers(0, 60, n), str(tmp_path / part), part,
            num_shards=2)
    code = (
        "import pickle, sys\n"
        f"sys.path.insert(0, {str(WORKER.parent.parent)!r})\n"
        "import torch\n"
        "torch.set_num_threads(2)\n"
        "from skeleton_action_recognition_tpu_torch.parallel import "
        "distributed\n"
        "from skeleton_action_recognition_tpu_torch.cli import main_gnn\n"
        f"distributed.maybe_initialize_distributed('gloo', "
        f"init_method='file://{tmp_path}/rendezvous')\n"
        "history = main_gnn.main(sys.argv[2:], device='cpu')\n"
        "with open(sys.argv[1], 'wb') as f:\n"
        "    pickle.dump(history, f)\n"
    )
    argv = ["--model", "stgcn", "--batch-size", "4", "--num-epochs", "1",
            "--save-freq", "1", "--base-lr", "0.01",
            "--train-data-path", str(tmp_path / "train"),
            "--test-data-path", str(tmp_path / "val"),
            "--log-dir", str(tmp_path / "logs")]
    env = {k: v for k, v in os.environ.items() if k != "MASTER_PORT"}
    procs = [
        subprocess.Popen(
            [sys.executable, "-c", code, str(tmp_path / f"h{r}.pkl"), *argv],
            env={**env, "RANK": str(r), "WORLD_SIZE": "2",
                 "LOCAL_RANK": str(r), "OMP_NUM_THREADS": "2"},
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for r in range(2)
    ]
    try:
        logs = [p.communicate(timeout=240)[0].decode() for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-3000:]
    histories = [pickle.loads((tmp_path / f"h{r}.pkl").read_bytes())
                 for r in range(2)]
    clip_rates = [h[0].pop("train_clips_per_s") for h in histories]
    assert histories[0] == histories[1] and len(histories[0]) == 1
    assert all(r > 0 for r in clip_rates)
    assert "Epoch: 1" in logs[0] and "Epoch: 1" not in logs[1]
    (run,) = os.listdir(tmp_path / "logs")
    assert sorted(os.listdir(tmp_path / "logs" / run / "checkpoints")) == [
        "0", "1"]
