"""The traced run's reduction: one ``torch.profiler`` trace of the window
to the numbers the per-layer metrics read.

The device is busy where a kernel, a copy or a fill runs: the union of
those intervals. A ``record_function`` range shows on the device as one
span from its first kernel to its last, gaps and all, so ranges are never
counted as busy. Idle time is the traced window's wall time (the host's
clock, from one synchronize to the next) less the busy time.
"""

from __future__ import annotations

import bisect
import contextlib
import re

# kineto's activity types of device work
DEVICE_WORK = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_SPANS = ("cpu_op", "user_annotation")
TOP = 10
NAME_CHARS = 120


def profiler():
    """A profiler of the host's operators and the device's activity."""
    from torch.profiler import ProfilerActivity, profile

    return profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])


def span(name: str, on: bool):
    """A ``record_function`` range named ``name`` when ``on``, else
    nothing: the untraced window carries no annotation."""
    if not on:
        return contextlib.nullcontext()
    from torch.profiler import record_function

    return record_function(name)


def activity(event) -> str:
    """The kineto activity type of ``event`` (``kernel``, ``gpu_memcpy``,
    ``cpu_op``, ...). Builds of torch whose events do not name it (2.11)
    tell device work and annotations apart by device and annotation flag:
    there copies and fills count as kernels."""
    kind = getattr(event, "activity_type", None)
    if kind is not None:
        return str(kind())
    from torch.autograd import DeviceType

    on_device = event.device_type() == DeviceType.CUDA
    if event.is_user_annotation():
        return "gpu_user_annotation" if on_device else "user_annotation"
    return "kernel" if on_device else "cpu_op"


def union(intervals):
    """Merged, sorted ``(start, end)`` intervals."""
    merged = []
    for start, end in sorted(intervals):
        if merged and start <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], end)
        else:
            merged.append([start, end])
    return merged


def host_label(host, starts, t):
    """What the host was doing at time ``t``: the innermost benchmark span
    and the innermost operator that cover it, joined by ``>``."""
    covering = []
    i = bisect.bisect_right(starts, t)
    for j in range(i - 1, max(-1, i - 4000), -1):
        start, end, name = host[j]
        if end >= t:
            covering.append((start, -end, name))
    if not covering:
        return "host: none"
    covering.sort()
    spans = [n for _, _, n in covering if n.startswith("bench.")]
    inner = covering[-1][2]
    return f"{spans[-1]} > {inner}" if spans and spans[-1] != inner else inner


def reduce(events, window_s: float) -> dict:
    """The trace's numbers over ``events`` (kineto events): the busy
    seconds, the count of device work items, the device seconds by kernel
    name, the ten names that took most, and idle time by what the host
    was doing, the ten largest. ``after`` holds each kernel's seconds by
    the name of the kernel before it, for the small kernels several ops
    share (a reduction launched after its op's kernel)."""
    work, host, by_name, kernels = [], [], {}, []
    for e in events:
        kind = activity(e)
        if kind in DEVICE_WORK:
            start = e.start_ns()
            end = start + e.duration_ns()
            work.append((start, end))
            name = e.name()
            by_name[name] = by_name.get(name, 0.0) + (end - start) * 1e-9
            if kind == "kernel":
                kernels.append((start, end, name))
        elif kind in HOST_SPANS:
            start = e.start_ns()
            host.append((start, start + e.duration_ns(), e.name()))
    kernels.sort()
    after = {}  # (the previous kernel's name, the kernel's name): seconds
    for k in range(1, len(kernels)):
        key = (kernels[k - 1][2], kernels[k][2])
        after[key] = after.get(key, 0.0) + (
            kernels[k][1] - kernels[k][0]) * 1e-9
    merged = union(work)
    busy_s = sum(end - start for start, end in merged) * 1e-9
    host.sort()
    starts = [h[0] for h in host]
    gaps = sorted(((merged[k + 1][0] - merged[k][1], merged[k][1],
                    merged[k + 1][0]) for k in range(len(merged) - 1)),
                  reverse=True)
    idle = {}
    for length, start, end in gaps[:200]:
        label = host_label(host, starts, (start + end) // 2)[:NAME_CHARS]
        idle[label] = idle.get(label, 0.0) + length * 1e-9
    return {
        "busy_s": busy_s,
        "window_s": window_s,
        "device_work": len(work),
        "by_name": by_name,
        "after": after,
        "device_ops": [[n[:NAME_CHARS], s] for n, s in sorted(
            by_name.items(), key=lambda kv: -kv[1])[:TOP]],
        "idle_gaps": [[n, s] for n, s in sorted(
            idle.items(), key=lambda kv: -kv[1])[:TOP]],
    }


def read(prof, window_s: float) -> dict:
    """:func:`reduce` over a finished profiler's events."""
    return reduce(prof.profiler.kineto_results.events(), window_s)


def kernel_seconds(trace: dict, patterns, followers=()) -> float:
    """Device seconds of the kernels whose names match any of the regular
    expressions ``patterns``, and of those matching ``followers`` that
    run right after one of them."""
    own = sum(s for name, s in trace["by_name"].items()
              if any(re.search(p, name) for p in patterns))
    return own + sum(
        s for (prev, name), s in trace["after"].items()
        if any(re.search(p, name) for p in followers)
        and any(re.search(p, prev) for p in patterns))
