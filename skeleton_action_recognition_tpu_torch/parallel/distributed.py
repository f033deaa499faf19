"""The process group of data-parallel training: one process per card.

Counterpart of ``skeleton_action_recognition_tpu/parallel/mesh.py``'s
``maybe_initialize_distributed``. The JAX package runs one process per host
over a mesh of its devices; the port runs one process per card, as
``torchrun --nproc_per_node=N`` starts them, and the collectives go over
NCCL between cards (gloo on the CPU). Without ``WORLD_SIZE`` in the
environment there is no process group, and every function here answers
for the one process: rank 0 of 1, sums that are their input.
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist


def maybe_initialize_distributed(backend=None, init_method=None) -> bool:
    """Join the process group that ``torchrun``'s environment describes
    (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, and ``MASTER_ADDR`` /
    ``MASTER_PORT`` for the default ``env://`` rendezvous); returns whether
    there is one. ``backend`` None is NCCL where torch sees a CUDA device,
    else gloo; with NCCL the process first takes card ``LOCAL_RANK`` as its
    current device. A set ``WORLD_SIZE`` whose group cannot be joined
    raises: training on one rank of N without saying so is no fallback.
    Where the group exists already, nothing is done."""
    if dist.is_available() and dist.is_initialized():
        return True
    if "WORLD_SIZE" not in os.environ:
        return False
    try:
        world = int(os.environ["WORLD_SIZE"])
        rank_ = int(os.environ["RANK"])
        local = int(os.environ.get("LOCAL_RANK", rank_))
    except (KeyError, ValueError) as err:
        raise RuntimeError(
            "WORLD_SIZE is set, but RANK or LOCAL_RANK is missing or not "
            "an integer; launch with torchrun or set all three"
        ) from err
    if not 0 <= rank_ < world or not 0 <= local:
        raise RuntimeError(
            f"RANK={rank_}, LOCAL_RANK={local} do not name a process of "
            f"WORLD_SIZE={world}"
        )
    if not dist.is_available():
        raise RuntimeError(
            f"WORLD_SIZE={world} asks for a process group, but this torch "
            "was built without torch.distributed"
        )
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    try:
        if backend == "nccl":
            torch.cuda.set_device(local)
        dist.init_process_group(
            backend, init_method=init_method, rank=rank_, world_size=world
        )
    except Exception as err:
        raise RuntimeError(
            f"rank {rank_} of {world} could not join the {backend} process "
            f"group: {err}"
        ) from err
    return True


def active() -> bool:
    """Whether this process is in a process group."""
    return dist.is_available() and dist.is_initialized()


def rank() -> int:
    return dist.get_rank() if active() else 0


def world_size() -> int:
    return dist.get_world_size() if active() else 1


def local_rank() -> int:
    return int(os.environ.get("LOCAL_RANK", rank())) if active() else 0


def local_device(device="cuda") -> torch.device:
    """``device`` for this process: a CUDA device without an index is card
    ``LOCAL_RANK`` in a process group (card 0 without one); anything else
    is kept as it is."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", local_rank())
    return device


def collective_device() -> torch.device:
    """Where small host values go for a collective: the current card under
    NCCL, which takes CUDA tensors only, else the CPU."""
    if active() and dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


class _AllReduceSum(torch.autograd.Function):
    """Sum over the ranks; the backward sums the cotangents over the ranks,
    since every rank's loss depends on every rank's input."""

    @staticmethod
    def forward(ctx, x):
        out = x.clone()
        dist.all_reduce(out)
        return out

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone()
        dist.all_reduce(grad)
        return grad


def all_reduce_sum(x: torch.Tensor) -> torch.Tensor:
    """``x`` summed over the ranks, differentiable (the identity without a
    process group)."""
    return _AllReduceSum.apply(x) if active() else x


def global_means(*means: torch.Tensor, count: int):
    """Each of ``means`` (this rank's means over its ``count`` rows) as the
    mean over every rank's rows: the BatchNorm moments of the global batch,
    as XLA takes them over a sharded batch. One collective carries them
    all, with the counts, in float64: ``mean * count`` is exact there for a
    float32 mean and any count below 2**29, so at world size 1 each mean
    comes back bit for bit. Differentiable; without a process group the
    means are returned as they are."""
    if not active():
        return means
    packed = torch.cat([torch.stack(means).double().flatten() * count,
                        means[0].new_full((1,), count, dtype=torch.float64)])
    packed = all_reduce_sum(packed)
    total = packed[-1]
    out = (packed[:-1] / total).to(means[0].dtype)
    return out.reshape(len(means), *means[0].shape).unbind(0)


def barrier() -> None:
    if active():
        dist.barrier()
