"""Device work items a training step: kernels, copies and fills in the
traced window, over its steps."""


def read(run):
    if run.trace is None or run.session.unit != "step":
        return None
    return run.trace["device_work"] / run.record["count"]
