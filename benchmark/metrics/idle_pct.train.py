"""The device's idle share of a training window: 1 - the union of its
kernels', copies' and fills' intervals over the traced window's wall time
(annotations are not busy)."""


def read(run):
    if run.trace is None or run.session.unit != "step":
        return None
    return 100.0 * (1.0 - run.trace["busy_s"] / run.trace["window_s"])
