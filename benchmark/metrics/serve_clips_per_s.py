"""Serving throughput: every clip answered in the window, over the window's
seconds."""


def read(run):
    if run.session.unit != "request":
        return None
    return run.record["clips"] / run.record["window_s"]
