"""Serving-side latency percentiles and the trainer's metric stream.

The port of `LatencyTracker` and `JsonlLogger` from
`cough_detector_tpu/utils/observability.py`: the detection server's
tick-cost and delivery-lag stats, and the train loop's per-epoch
metrics.jsonl.
"""

from __future__ import annotations

import json
import time
from collections import deque
from pathlib import Path
from typing import Deque, Optional

import numpy as np


class JsonlLogger:
    """Append-only JSONL metric stream; each record gets a wall-clock "t"
    unless it has one, and is flushed as written."""

    def __init__(self, path: str):
        self._path = Path(path)
        self._path.parent.mkdir(parents=True, exist_ok=True)
        self._fh = self._path.open("a")

    def log(self, **record) -> None:
        record.setdefault("t", time.time())
        self._fh.write(json.dumps(record) + "\n")
        self._fh.flush()

    def close(self) -> None:
        self._fh.close()


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
