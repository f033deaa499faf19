"""One rank of a data-parallel or sequence-parallel job on the CPU, for
the port's parallel tests (``test_torch_parallel.py``,
``test_torch_parallel_paths.py``, ``test_torch_seqpar_radar.py``). It
holds no test. Imports no jax: a rank runs the port alone, as on the
card's machine.

    python tests/test_torch_parallel_worker.py RANK WORLD INIT_FILE \
        JOB_FILE OUT_FILE

Joins a gloo process group of ``WORLD`` ranks through
``maybe_initialize_distributed`` (``file://INIT_FILE`` rendezvous), runs the
job that ``JOB_FILE`` (a ``torch.save``d dict written by the test) names on
this rank's rows, and saves the rank's results to ``OUT_FILE``.
"""

import os
import pathlib
import sys

import numpy as np
import torch
import torch.nn as nn

REPO_ROOT = pathlib.Path(__file__).resolve().parent.parent
if str(REPO_ROOT) not in sys.path:
    sys.path.insert(0, str(REPO_ROOT))

from skeleton_action_recognition_tpu_torch.models.layers import (  # noqa: E402
    BatchNorm,
)
from skeleton_action_recognition_tpu_torch.parallel import (  # noqa: E402
    distributed,
)
from skeleton_action_recognition_tpu_torch.parallel.sharding import (  # noqa
    DataParallel,
)
from skeleton_action_recognition_tpu_torch.train import (  # noqa: E402
    steps as steps_lib,
)


class TinyModel(nn.Module):
    """``Dense(16) -> BatchNorm -> ReLU -> Dense(classes)`` over the
    flattened clip: the JAX multi-host test's ``TinyModel`` (flax's
    BatchNorm defaults, epsilon 1e-5 and momentum 0.99)."""

    def __init__(self, in_features: int, num_classes: int = 4):
        super().__init__()
        self.Dense_0 = nn.Linear(in_features, 16)
        self.BatchNorm_0 = BatchNorm(16, epsilon=1e-5, momentum=0.99)
        self.Dense_1 = nn.Linear(16, num_classes)

    def forward(self, x):
        x = self.Dense_0(x.reshape(len(x), -1))
        return self.Dense_1(torch.relu(self.BatchNorm_0(x)))


def build(job):
    """The job's model with its weights, and its SGD optimizer."""
    kind = job["model"]
    if kind == "stgcn":
        from skeleton_action_recognition_tpu_torch.models import stgcn

        model = stgcn.Model(num_classes=job["num_classes"], **job["options"])
    elif kind == "spectrogram":
        from skeleton_action_recognition_tpu_torch.models import spectrogram

        model = spectrogram.Model(**job["options"])
    else:
        model = TinyModel(job["in_features"], job["num_classes"])
    model.load_state_dict(job["state"])
    opt = torch.optim.SGD(model.parameters(), lr=job["lr"],
                          momentum=job.get("momentum", 0.0),
                          nesterov=job.get("nesterov", False))
    return model, opt


def run(job, dp):
    """Train the job's steps on this rank's rows; returns the rank's
    results."""
    model, opt = build(job)
    dp.broadcast_module(model)
    dp_arg = dp if dp.active else None
    if job["model"] == "spectrogram":
        step = steps_lib.make_radar_train_step(
            model, opt, job["global_batch"], dp=dp_arg)
    else:
        step = steps_lib.make_train_step(
            model, opt, job["global_batch"], job.get("l2_weight", 0.0),
            dp=dp_arg)
    if "data_dir" in job:
        from skeleton_action_recognition_tpu_torch.data.pipeline import (
            TFRecordDataset,
        )

        ds = TFRecordDataset(
            job["data_dir"], batch_size=job["global_batch"] // dp.world_size,
            num_classes=job["num_classes"], drop_remainder=True,
            process_index=dp.rank, process_count=dp.world_size,
        )
        batches = list(ds.batches())
    else:
        batches = [(dp.local_rows(x), dp.local_rows(y))
                   for x, y in zip(job["xs"], job["ys"])]
    metrics = []
    for x, y in batches:
        args = (torch.from_numpy(np.ascontiguousarray(x)),
                torch.from_numpy(np.ascontiguousarray(y)))
        m = step(*args) if job["model"] == "spectrogram" else step(
            *args, False)
        metrics.append({k: v.item() for k, v in m.items()})
    return {"state": model.state_dict(), "metrics": metrics,
            "rows": [len(x) for x, _ in batches]}


def seqpar(job):
    """The sequence-parallel radar ops on this rank: for each of the job's
    ``cases``, the op's result and, where the case gives cotangents, the
    gradients of ``sum(out * cotangent)`` in the joints, the location and
    the wavelength; for each of its ``refused`` operators, the
    ``ValueError`` the spectrogram op raises."""
    from skeleton_action_recognition_tpu_torch import ops

    out = {}
    for name, case in job["cases"].items():
        x = torch.tensor(case["x"], requires_grad=True)
        loc = torch.tensor(case["loc"], requires_grad=True)
        lam = torch.tensor(case["lam"], requires_grad=True)
        w = torch.from_numpy(case["w"])
        if case["op"] == "return":
            result = ops.radar_return_sharded(x, w, loc, lam)
        else:
            result = (ops.radar_spectrogram_sharded(x, w, loc, lam),)
        out[name] = {"out": [r.detach().numpy() for r in result]}
        if "cotangents" in case:
            loss = sum((r * torch.from_numpy(g)).sum()
                       for r, g in zip(result, case["cotangents"]))
            loss.backward()
            out[name]["grads"] = [t.grad.numpy() for t in (x, loc, lam)]
    for name, w in job.get("refused", {}).items():
        try:
            ops.radar_spectrogram_sharded(
                torch.zeros(1, 3, w.shape[1], 25, 2), torch.from_numpy(w),
                torch.zeros(3), torch.tensor(5e-4))
            out[name] = None
        except ValueError as err:
            out[name] = str(err)
    return out


def main(rank, world, init_file, job_file, out_file):
    torch.set_num_threads(2)
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank))
    assert distributed.maybe_initialize_distributed(
        "gloo", init_method=f"file://{init_file}")
    dp = DataParallel()
    assert (dp.rank, dp.world_size) == (rank, world)
    job = torch.load(job_file, weights_only=False)
    torch.save(seqpar(job) if job.get("model") == "seqpar" else run(job, dp),
               out_file)
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), *sys.argv[3:6])
