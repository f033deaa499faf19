"""The device's idle share of a serving window, as ``idle_pct.train``
takes it."""


def read(run):
    if run.trace is None or run.session.unit != "request":
        return None
    return 100.0 * (1.0 - run.trace["busy_s"] / run.trace["window_s"])
