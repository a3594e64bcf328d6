"""query_p95_ms: the 95th percentile of every single query's latency in
the window, from the call to the host arrays in hand, ms (numpy's
linear interpolation). Single-query cells only."""

import numpy as np


def read(run):
    if run.entry != "single" or not run.latencies_s:
        return None
    return 1e3 * float(np.percentile(run.latencies_s, 95))
