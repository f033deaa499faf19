"""The port's spans and counters: what a profile of it can read.

``span(name)`` marks a region of the host's work. While a
``torch.profiler`` records, it is a ``record_function`` range in the same
trace as the device's work, so each kernel can be put down to the span
that launched it; otherwise it is one shared no-op context, and costs a
check. Nothing switches the spans on but profiling: the trainers'
``--profile-dir`` and any profiler a caller runs.

``count(name, n)`` adds to one registry of counters for the process,
always on: ``ops.build.launch`` counts each call of a kernel entry point
as ``launch.<entry point>``. ``counters()`` reads it (a copy, 0 for a name
never counted) and ``reset_counters()`` empties it.
"""

from __future__ import annotations

import collections
import contextlib
import threading

import torch.autograd.profiler as _profiler

_OFF = contextlib.nullcontext()
_COUNTERS: collections.Counter = collections.Counter()
# autograd launches the backward's kernels from its own threads
_LOCK = threading.Lock()


def span(name: str):
    """A ``record_function`` range named ``name`` while a profiler records,
    else a shared context that does nothing."""
    if not _profiler._is_profiler_enabled:
        return _OFF
    return _profiler.record_function(name)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name``."""
    with _LOCK:
        _COUNTERS[name] += n


def counters() -> collections.Counter:
    """A copy of every counter; a name never counted reads 0."""
    with _LOCK:
        return collections.Counter(_COUNTERS)


def reset_counters() -> None:
    """Set every counter back to nothing."""
    with _LOCK:
        _COUNTERS.clear()
