"""Training throughput: every clip of the steps the window ran, over the
window's seconds (from a synchronize to the synchronize after the last
step)."""


def read(run):
    if run.session.unit != "step":
        return None
    return run.record["clips"] / run.record["window_s"]
