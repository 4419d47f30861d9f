"""Audio to event: the 95th percentile over every tick of the window, each
from when it was due to when its events were collected."""

import numpy as np


def read(run):
    lat = run.window.get("latency_s")
    return float(np.percentile(lat, 95)) * 1e3 if lat else None
