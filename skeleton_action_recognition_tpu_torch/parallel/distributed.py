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


def rank(group=None) -> int:
    """This process's rank in ``group`` (None: the default group); 0
    without a process group."""
    return dist.get_rank(group) if active() else 0


def world_size(group=None) -> int:
    """The ranks in ``group`` (None: the default group); 1 without a
    process group."""
    return dist.get_world_size(group) if active() else 1


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


# ---------------------------------------------------------------------------
# The collectives of the sequence-parallel ops (``ops/virtual_radar.py``'s
# ``radar_return_sharded`` and ``radar_spectrogram_sharded``). Every rank
# computes the same replicated loss from the gathered result, and ends with
# the gradient one process would compute. Each is built on ``all_reduce``
# alone: gloo takes only ``all_reduce`` and ``broadcast`` for CUDA tensors,
# and NCCL does not put two ranks on one card. Without a process group
# (``group`` None and none initialized) each is the identity, and the halo
# exchange finds no neighbour.


class _SumPartials(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        out = x.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def sum_partials(x: torch.Tensor, group=None) -> torch.Tensor:
    """The sum over the ranks of each rank's partial ``x`` (a sum over its
    own rows), the same on every rank. The backward is the identity: the
    replicated result's cotangent is each partial's. Where every rank uses
    the result for its own rows alone, pass it through
    :func:`replicated_input` as well, so that the cotangent it hands back
    is the sum of the ranks' uses."""
    return _SumPartials.apply(x, group) if active() else x


class _GatherSlices(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.rank, ctx.size = dim, rank(group), x.shape[dim]
        shape = list(x.shape)
        shape[dim] *= world_size(group)
        out = x.new_zeros(shape)
        out.narrow(dim, ctx.rank * x.shape[dim], x.shape[dim]).copy_(x)
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        own = grad.narrow(ctx.dim, ctx.rank * ctx.size, ctx.size)
        return own.contiguous(), None, None


def gather_slices(x: torch.Tensor, dim: int, group=None) -> torch.Tensor:
    """The ranks' equal slices ``x`` laid end to end along ``dim`` in rank
    order, on every rank: each rank writes its slice into a zeroed buffer,
    and one ``all_reduce`` sums them. The backward takes this rank's slice
    of the (replicated) cotangent."""
    return _GatherSlices.apply(x, dim, group) if active() else x


class _ReplicatedInput(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


def replicated_input(x: torch.Tensor, group=None) -> torch.Tensor:
    """``x``, held alike on every rank, which each rank uses for its own
    part of the work. The forward is the identity; the backward sums the
    ranks' cotangents, so that every rank gets the whole gradient."""
    return _ReplicatedInput.apply(x, group) if active() else x


class _HaloExchange(torch.autograd.Function):
    @staticmethod
    def forward(ctx, first, last, group):
        me, world = rank(group), world_size(group)
        ctx.group, ctx.rank, ctx.world = group, me, world
        slots = first.new_zeros((world, 2) + tuple(first.shape))
        slots[me, 0] = first
        slots[me, 1] = last
        dist.all_reduce(slots, group=group)
        from_left = slots[me - 1, 1] if me > 0 else torch.zeros_like(last)
        from_right = (slots[me + 1, 0] if me < world - 1
                      else torch.zeros_like(first))
        return from_left, from_right

    @staticmethod
    def backward(ctx, g_left, g_right):
        me, world = ctx.rank, ctx.world
        slots = g_left.new_zeros((world, 2) + tuple(g_left.shape))
        if me > 0:  # the left halo was the left neighbour's last samples
            slots[me - 1, 1] = g_left
        if me < world - 1:
            slots[me + 1, 0] = g_right
        dist.all_reduce(slots, group=ctx.group)
        return slots[me, 0], slots[me, 1], None


def halo_exchange(first: torch.Tensor, last: torch.Tensor, group=None):
    """``(from_left, from_right)``: the left neighbour's ``last`` and the
    right neighbour's ``first`` (this rank's first and last samples along
    a sharded axis, of one shape), zeros at the ends of the rank order and
    without a process group. One ``all_reduce`` of every rank's two edges;
    the backward sends the halos' cotangents back to their owners the same
    way."""
    if not active():
        return torch.zeros_like(last), torch.zeros_like(first)
    return _HaloExchange.apply(first, last, group)
