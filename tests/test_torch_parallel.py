"""Data parallelism in the port against the JAX package: the ST-GCN step
and the process group.

Two gloo ranks on the CPU, spawned with a ``file://`` rendezvous under
``tmp_path`` (no port to collide between test workers), each train on
their rows of a global batch (``tests/test_torch_parallel_worker.py``).
The JAX package's semantics to hold (``tests/test_parallel.py``): a
data-parallel step equals the one-device step on the global batch, the
BatchNorm statistics taken over the global batch, at the JAX test's atol
3e-4 on the parameters. Here the ranks are held against the JAX
one-device step, and each against the other bit for bit.
``test_torch_parallel_paths.py`` holds the spectrogram step, the
multi-host layout, the trainer and serving on two devices.
"""

import numpy as np
import optax
import pytest
import torch

from skeleton_action_recognition_tpu.models import stgcn as jax_stgcn
from skeleton_action_recognition_tpu.train import make_train_step
from skeleton_action_recognition_tpu_torch.models import stgcn
from skeleton_action_recognition_tpu_torch.parallel import distributed
from skeleton_action_recognition_tpu_torch.parallel.sharding import (
    DataParallel,
)
import test_torch_parallel_worker
from torch_parity_helpers import (
    Ranks,
    assert_ranks_equal,
    assert_state_close,
    jax_init,
    jax_one_device,
)

# tests/test_parallel.py's tolerance for the sharded against the one-device
# step: f32 sums (BatchNorm moments, gradients) taken in another order
PARAM_ATOL = 3e-4
# the port's loss against JAX's on one device (tests/test_torch_train_step)
LOSS_RTOL = 1e-4
# remat (the models' default) on the stock model; off with the fused
# options, whose Pallas kernels JAX compiles in interpret mode twice over
# under remat
STGCN_OPTIONS = {
    "stock": {},
    "stock_l2": dict(remat=False),
    "fused_sgcn": dict(fused_sgcn=True, remat=False),
    "sgcn_stats": dict(fused_sgcn=True, sgcn_stats=True, remat=False),
    "fused_tconv": dict(fused_tconv=True, remat=False),
    # the fused chain fed BN1's sums by the fused spatial conv's epilogue
    "fused_sgcn_tconv": dict(fused_sgcn=True, fused_tconv=True,
                             remat=False),
}


def stgcn_batch():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(8, 3, 16, 25, 2)).astype(np.float32)
    y = np.eye(60, dtype=np.float32)[np.arange(8) % 60]
    return x, y


@pytest.mark.parametrize("option", list(STGCN_OPTIONS))
def test_two_ranks_stgcn_step_match_jax_one_device(tmp_path, option):
    """tests/test_parallel.py's step (8 clips, T=16, Nesterov SGD 1e-2)
    on two ranks of 4 clips against the JAX step on all 8; the
    fused options on their plain routes here, the Pallas kernels in
    interpret mode in JAX. ``stock_l2`` adds the L2 penalty: a rank that
    carried all of it would double it in the summed loss."""
    l2 = 1e-4 if option == "stock_l2" else 0.0
    x, y = stgcn_batch()
    options = STGCN_OPTIONS[option]
    state, init = jax_init(jax_stgcn.Model(num_classes=60, **options), x,
                           optax.sgd(1e-2, momentum=0.9, nesterov=True))
    ranks = Ranks(tmp_path, dict(
        model="stgcn", num_classes=60, options=options, state=init,
        lr=1e-2, momentum=0.9, nesterov=True, l2_weight=l2, global_batch=8,
        xs=[x], ys=[y]))
    loss, want = jax_one_device(
        state, x, y, make_train_step(global_batch_size=8, l2_weight=l2),
        False)
    results = ranks.wait()
    assert_ranks_equal(results)
    (m,) = results[0]["metrics"]
    assert m["count"] == 8 and results[0]["rows"] == [4]
    np.testing.assert_allclose(m["loss"], loss, rtol=LOSS_RTOL)
    assert_state_close(results[0]["state"], want, PARAM_ATOL)


@pytest.mark.parametrize("option", ["stock", "sgcn_stats", "fused_tconv",
                                    "fused_sgcn_tconv"])
def test_world_size_one_is_the_step_without_a_group(tmp_path, option):
    """One rank in a process group (the global moments, the gradient and
    metric sums all taken) gives the step without a group bit for bit:
    ``global_means`` packs ``mean * count`` in float64, exact for a
    float32 mean."""
    x, y = stgcn_batch()
    model = stgcn.Model(num_classes=60, **STGCN_OPTIONS[option],
                        generator=torch.Generator().manual_seed(0))
    job = dict(model="stgcn", num_classes=60,
               options=STGCN_OPTIONS[option], state=model.state_dict(),
               lr=1e-2, momentum=0.9, nesterov=True, l2_weight=1e-4,
               global_batch=8, xs=[x, x[::-1].copy()], ys=[y, y])
    ranks = Ranks(tmp_path, job, world=1)
    alone = test_torch_parallel_worker.run(job, DataParallel())
    (grouped,) = ranks.wait()
    assert grouped["metrics"] == alone["metrics"]
    for name, t in alone["state"].items():
        assert torch.equal(grouped["state"][name], t), name


def test_without_world_size_there_is_no_group(monkeypatch):
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    assert distributed.maybe_initialize_distributed() is False
    assert not distributed.active()
    dp = DataParallel()
    assert (dp.rank, dp.world_size) == (0, 1)
    x = torch.arange(6.0).reshape(3, 2)
    assert torch.equal(dp.local_rows(x), x)
    assert dp.gather_rows(x) is x
    assert dp.min_over_ranks(7) == 7
    mean = torch.tensor([1.5])
    assert distributed.global_means(mean, count=3)[0] is mean
    assert distributed.local_device("cuda") == torch.device("cuda", 0)


@pytest.mark.parametrize("env,backend,match", [
    ({"WORLD_SIZE": "2"}, "gloo", "RANK"),
    ({"WORLD_SIZE": "2", "RANK": "2"}, "gloo", "do not name"),
    # this torch has no CUDA and no NCCL
    ({"WORLD_SIZE": "1", "RANK": "0"}, "nccl", "could not join"),
], ids=["no_rank", "rank_out_of_range", "backend_missing"])
def test_a_failed_init_raises(monkeypatch, tmp_path, env, backend, match):
    """A set ``WORLD_SIZE`` whose group cannot be joined raises, where the
    JAX package returns False and trains alone."""
    for k in ("RANK", "LOCAL_RANK"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    with pytest.raises(RuntimeError, match=match):
        distributed.maybe_initialize_distributed(
            backend, init_method=f"file://{tmp_path}/store")
    assert not distributed.active()


def test_data_parallel_layout_helpers():
    """``local_rows`` refuses a batch that does not split; ``pad_rows``
    pads to a multiple of the world size (here 1: nothing)."""
    dp = DataParallel()
    dp.world_size, dp.rank = 4, 1
    x = np.arange(8)
    np.testing.assert_array_equal(dp.local_rows(x), [2, 3])
    with pytest.raises(ValueError, match="does not split"):
        dp.local_rows(np.arange(6))
    assert len(dp.pad_rows(np.ones((6, 2)))) == 8
    assert len(DataParallel().pad_rows(np.ones((6, 2)))) == 6


