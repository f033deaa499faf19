"""The 95th percentile of every request's latency in the window: from
handing the host array to the predictor until its probabilities are a
host array (numpy's linear interpolation between order statistics)."""

import numpy as np


def read(run):
    lat = run.record.get("latencies_s")
    if not lat:
        return None
    return float(np.percentile(np.asarray(lat), 95.0)) * 1e3
