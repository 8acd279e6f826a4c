"""call_p95_ms: the 95th percentile of the latency of every call in the window
(host clock from the call's start to its synchronize). Listed only for
cells whose window holds well over 200 calls."""

import numpy as np


def read(run):
    return float(np.percentile(np.asarray(run.latencies_s) * 1e3, 95))
