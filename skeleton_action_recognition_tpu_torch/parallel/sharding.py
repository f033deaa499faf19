"""Data parallelism across processes, and double-buffered host-to-device
copies.

Counterpart of ``skeleton_action_recognition_tpu/parallel/sharding.py``:
``DataParallel`` (the JAX class replicates the state over a mesh and lets
XLA insert the gradient ``psum``; here each process holds a replica on its
card and the gradients are summed explicitly after the backward) and
``prefetch_to_device``.
"""

from __future__ import annotations

from collections import deque

import numpy as np
import torch
import torch.distributed as dist
from torch._utils import _flatten_dense_tensors, _unflatten_dense_tensors

from skeleton_action_recognition_tpu_torch.parallel import distributed


def resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device``; a CUDA device where torch sees
    none raises, so that a caller never runs on the CPU unasked."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device} was asked for, but torch sees no CUDA "
            "device; pass device='cpu' to run on the CPU"
        )
    return device


def prefetch_to_device(iterator, device, depth: int = 2):
    """Yield each item of ``iterator`` (a tuple of numpy arrays) as a tuple
    of tensors on ``device``, with the next ``depth - 1`` items' copies
    already issued.

    On a CUDA device each array is copied from pinned host memory on a
    side stream, so batch ``i + 1``'s copy runs while step ``i`` computes;
    the current stream waits for a batch's copy (an event, not a host
    synchronisation) before the batch is handed out. On the CPU the arrays
    are wrapped as they are.
    """
    device = torch.device(device)
    if device.type != "cuda":
        for item in iterator:
            yield tuple(torch.from_numpy(np.asarray(a)) for a in item)
        return
    copy_stream = torch.cuda.Stream(device)
    pending: deque = deque()

    def ready(entry):
        tensors, event = entry
        current = torch.cuda.current_stream(device)
        current.wait_event(event)
        for t in tensors:
            # the caching allocator must not hand the memory to another
            # tensor before the current stream is done with it
            t.record_stream(current)
        return tensors

    for item in iterator:
        host = [
            torch.from_numpy(np.ascontiguousarray(a)).pin_memory()
            for a in item
        ]
        with torch.cuda.stream(copy_stream):
            tensors = tuple(h.to(device, non_blocking=True) for h in host)
            event = torch.cuda.Event()
            event.record(copy_stream)
        pending.append((tensors, event))
        if len(pending) >= depth:
            yield ready(pending.popleft())
    while pending:
        yield ready(pending.popleft())


class DataParallel:
    """Synchronous data parallelism over the process group, one replica a
    process: the JAX ``DataParallel``'s semantics, a layout and not a
    change of result. A step on each rank's rows of a global batch, with
    the gradients summed (:meth:`all_reduce_gradients`; the loss is each
    rank's cross-entropy sum over the global batch size) and the
    BatchNorm moments taken over the global batch
    (:func:`.distributed.global_means`), equals one process's step on the
    whole batch.

    The gradients are summed after the backward, not overlapped with it,
    and not through ``torch.nn.parallel.DistributedDataParallel``: the
    spectrogram step turns the radar parameters' ``requires_grad`` on and
    off between calls, which DDP's reducer does not allow after it is
    built, and DDP's buffer broadcast would overwrite the running
    statistics every rank already shares. Without a process group every
    method answers for one process."""

    def __init__(self):
        self.rank = distributed.rank()
        self.world_size = distributed.world_size()
        self.active = distributed.active()

    def broadcast_module(self, module: torch.nn.Module) -> None:
        """Give every rank rank 0's parameters and buffers."""
        if not self.active:
            return
        with torch.no_grad():
            for t in list(module.parameters()) + list(module.buffers()):
                dist.broadcast(t.data, src=0)

    def local_rows(self, x):
        """This rank's contiguous slice of the rows of a global batch ``x``
        (rank order: rank ``r`` takes the ``r``-th of ``world_size`` equal
        slices)."""
        n = len(x)
        if n % self.world_size:
            raise ValueError(
                f"a global batch of {n} rows does not split over "
                f"{self.world_size} ranks"
            )
        k = n // self.world_size
        return x[self.rank * k: (self.rank + 1) * k]

    def all_reduce_gradients(self, module: torch.nn.Module) -> None:
        """Sum every parameter's gradient over the ranks, as the JAX
        ``psum``: one flat buffer a dtype, one collective each. Parameters
        without a gradient (frozen) are skipped, alike on every rank."""
        if not self.active:
            return
        by_dtype: dict = {}
        for p in module.parameters():
            if p.grad is not None:
                by_dtype.setdefault(p.grad.dtype, []).append(p.grad)
        for grads in by_dtype.values():
            flat = _flatten_dense_tensors(grads)
            dist.all_reduce(flat)
            for g, summed in zip(grads, _unflatten_dense_tensors(flat, grads)):
                g.copy_(summed)

    def sum_metrics(self, metrics: dict) -> dict:
        """The metrics' sums over the ranks, every rank receiving them (the
        gloo backend has no ``reduce`` for CUDA tensors), in one float64
        collective: exact for counts, and a float32 loss comes back as it
        was at world size 1."""
        if not self.active:
            return metrics
        names = list(metrics)
        device = metrics[names[0]].device
        packed = torch.stack([metrics[k].double().to(device) for k in names])
        dist.all_reduce(packed)
        return {k: v.to(metrics[k].dtype)
                for k, v in zip(names, packed.unbind(0))}

    def gather_rows(self, x: torch.Tensor) -> torch.Tensor:
        """Every rank's rows ``x`` (the same count on each) concatenated in
        rank order, on every rank. Built from ``all_reduce`` (each rank
        adds its rows into zeros), which the NCCL and gloo backends both
        take for CUDA tensors."""
        if not self.active:
            return x
        out = x.new_zeros((self.world_size,) + tuple(x.shape))
        out[self.rank] = x
        dist.all_reduce(out)
        return out.reshape((-1,) + tuple(x.shape[1:]))

    def pad_rows(self, x: np.ndarray) -> np.ndarray:
        """``x`` with zero rows appended up to a multiple of the world
        size; callers slice the padding off the gathered result."""
        pad = -len(x) % self.world_size
        if not pad:
            return x
        return np.concatenate([x, np.zeros((pad,) + x.shape[1:], x.dtype)])

    def min_over_ranks(self, value: int) -> int:
        """The smallest ``value`` any rank holds (every rank must run the
        same number of steps: the collectives pair up)."""
        if not self.active:
            return value
        t = torch.tensor([value], dtype=torch.int64,
                         device=distributed.collective_device())
        dist.all_reduce(t, op=dist.ReduceOp.MIN)
        return int(t.item())
