"""The training step's share of the card's peak while the card is busy: a
step's model operations (``FlopCounterMode`` over the reference on the
meta device, forward and backward, no recomputation) times the traced
window's steps, over the device's busy seconds in the trace (the union of
its kernels, copies and fills) and the peak of the cell's compute type
(``params["peak"]``: ``bfloat16`` or ``tf32``). The profiler slows the
host, not the device, so the share reads alike traced or not; the host's
gaps show in ``idle_pct.train``."""

from harness import peaks


def read(run):
    if run.trace is None or run.session.unit != "step":
        return None
    ops = run.session.flops_per_unit() * run.record["count"]
    return 100.0 * ops / run.trace["busy_s"] / peaks.FLOPS[
        run.cell.params["peak"]]
