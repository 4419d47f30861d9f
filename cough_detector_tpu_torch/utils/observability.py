"""Serving-side latency percentiles.

The port of `LatencyTracker` from `cough_detector_tpu/utils/observability.py`,
which the detection server uses for its tick-cost and delivery-lag stats.
"""

from __future__ import annotations

from collections import deque
from typing import Deque, Optional

import numpy as np


class LatencyTracker:
    """Recent latencies (seconds) for percentile stats.

    Bounded: only the most recent `maxlen` samples are kept. Writers call
    `record`; readers in another thread take `snapshot()` under whatever
    lock excludes writers (iterating a deque during a concurrent append is
    a RuntimeError)."""

    def __init__(self, maxlen: Optional[int] = 4096):
        self._samples: Deque[float] = deque(maxlen=maxlen)

    def record(self, seconds: float) -> None:
        self._samples.append(seconds)

    def snapshot(self) -> np.ndarray:
        """The retained samples as an array (copy, safe to reduce)."""
        return np.asarray(self._samples, dtype=np.float64)
