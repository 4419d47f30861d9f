"""The median of the same per-tick latencies as tick_p95_ms: a statistic
beside the tail, steadier than it."""

import numpy as np


def read(run):
    lat = run.window.get("latency_s")
    return float(np.percentile(lat, 50)) * 1e3 if lat else None
