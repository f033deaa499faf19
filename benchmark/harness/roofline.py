"""A kernel's share of its roofline over the traced window: the least time
the card could take for the work of the op's launches (``counts/``, at
the shapes the cell's model builder lists, times the window's steps) over
the device time of the op's kernels (``trace.kernel_seconds``)."""

from __future__ import annotations

from harness import manifest, peaks, trace


def share(run, op: str, direction: str, patterns, followers=()):
    """``100 * least / device`` for ``direction`` (``fwd`` or ``bwd``) of
    ``op``, or None where the trace holds none of its kernels or the cell
    runs no launch of it."""
    if run.trace is None:
        return None
    shapes = manifest.module("models", run.cell.config["name"]).op_shapes(
        run.cell.config, run.cell.params).get(op, [])
    device = trace.kernel_seconds(run.trace, patterns, followers)
    if not shapes or device <= 0:
        return None
    count = manifest.module("counts", op)
    work = getattr(count, direction)
    # the peak of the kernel's compute type: the port's float32 kernels
    # run on the CUDA cores, never in TF32
    least = sum(peaks.least_seconds(*work(**shape),
                                    shape.get("dtype", "float32"))
                for shape in shapes)
    return 100.0 * least * run.record["count"] / device
