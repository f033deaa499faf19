"""The predictor's share of the card's peak while the card is busy: the
stock model's forward operations for a request (``FlopCounterMode`` over
the reference on the meta device) times the traced window's answered
requests, over the device's busy seconds in the trace and the bfloat16
peak (the folded route's products); the host's gaps show in
``idle_pct.serve``."""

from harness import peaks


def read(run):
    if run.trace is None or run.session.unit != "request":
        return None
    ops = run.session.flops_per_unit() * (run.record["count"]
                                          - run.record.get("failed", 0))
    return 100.0 * ops / run.trace["busy_s"] / peaks.FLOPS[
        run.cell.params["peak"]]
