"""Double-buffered host-to-device copies.

Counterpart of ``skeleton_action_recognition_tpu/parallel/sharding.py``'s
``prefetch_to_device``, for one device.
"""

from __future__ import annotations

from collections import deque

import numpy as np
import torch


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
