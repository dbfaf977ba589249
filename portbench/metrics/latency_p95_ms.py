"""latency_p95_ms: the 95th percentile of every request's latency in
the window (CUDA events around each call, ms)."""

import numpy as np


def read(rec):
    lat = rec.get("latencies_ms")
    if not lat:
        return None
    return float(np.percentile(np.asarray(lat, np.float64), 95))
