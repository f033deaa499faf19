"""The device's work put down to the program's own spans.

Under a profiler the port opens ``record_function`` ranges
(``skeleton_action_recognition_tpu_torch/tracing.py``): ``train.*`` and
``serve.*`` around the phases of a train step and of a request, ``op.*``
around each call of one of its kernel entry points. A device work item
(kernel, copy or fill) belongs to the spans that held the host when the
runtime call that launched it was made; the item's correlation id names
that call. The innermost phase span and the innermost op span whose host
interval holds the call are searched on every thread: autograd launches
the backward from its own thread while the main thread waits inside
``train.backward``.
"""

from __future__ import annotations

import bisect

from . import trace

PHASES = ("train.", "serve.")
OPS = ("op.",)
# kineto's activity types of the runtime's calls; builds whose events name
# no activity type (torch 2.11) show them as host operators named cu*
RUNTIME = ("cuda_runtime", "cuda_driver")
# how many earlier spans of a family to look through for one that holds a
# call: the port's spans of one family do not nest
LOOKBACK = 64


def runtime_call(kind: str, name: str) -> bool:
    return kind in RUNTIME or (kind == "cpu_op" and name.startswith("cu"))


class Family:
    """One family's spans, ``(start, end, name)``, by start."""

    def __init__(self, spans):
        self.spans = sorted(spans)
        self.starts = [s[0] for s in self.spans]

    def holding(self, t):
        """The name of the latest-starting span that holds ``t``, or
        None."""
        i = bisect.bisect_right(self.starts, t)
        for j in range(i - 1, max(-1, i - 1 - LOOKBACK), -1):
            if self.spans[j][1] >= t:
                return self.spans[j][2]
        return None


def assign(events):
    """``(items, spans)`` of ``events`` (kineto events): each device work
    item as ``(name, seconds, owners)``, ``owners`` the names of the
    innermost phase span and op span that hold its runtime call (none
    where no span does, or where the trace lacks the call: events without
    a correlation id lack every call), and each program span as ``(start,
    end, name)``, in ns on the host's clock."""
    work, calls, phases, ops = [], {}, [], []
    for e in events:
        kind = trace.activity(e)
        correlation = getattr(e, "correlation_id", None)
        if kind in trace.DEVICE_WORK:
            work.append((e.name(), e.duration_ns() * 1e-9,
                         correlation() if correlation else None))
            continue
        name = e.name()
        start = e.start_ns()
        if kind in trace.HOST_SPANS and name.startswith(PHASES + OPS):
            span = (start, start + e.duration_ns(), name)
            (phases if name.startswith(PHASES) else ops).append(span)
        elif correlation is not None and runtime_call(kind, name):
            calls[correlation()] = start
    families = (Family(phases), Family(ops))
    items = []
    for name, seconds, correlation in work:
        t = calls.get(correlation)
        owners = () if t is None else tuple(
            n for n in (f.holding(t) for f in families) if n is not None)
        items.append((name, seconds, owners))
    return items, phases + ops


def attribute(items, spans) -> dict:
    """:func:`assign`'s result summed: ``{"spans": {name: {"device_s",
    "work", "host_s", "count"}}, "unattributed_s", "unattributed_work"}``:
    for each program span name, the device seconds and count of the work
    items launched inside it, and its host seconds and count of spans;
    then the device seconds and count of the items no span holds."""
    out = {}
    for start, end, name in spans:
        s = out.setdefault(name, {"device_s": 0.0, "work": 0, "host_s": 0.0,
                                  "count": 0})
        s["host_s"] += (end - start) * 1e-9
        s["count"] += 1
    lost_s, lost = 0.0, 0
    for _, seconds, owners in items:
        for name in owners:
            out[name]["device_s"] += seconds
            out[name]["work"] += 1
        if not owners:
            lost_s += seconds
            lost += 1
    return {"spans": out, "unattributed_s": lost_s,
            "unattributed_work": lost}
