"""Metric streams, throughput and latency counters, trace helpers.

The port of `cough_detector_tpu/utils/observability.py`:
  * `JsonlLogger` — the train loop's per-epoch metrics.jsonl;
  * `LatencyTracker` — the detection server's tick-cost and delivery-lag
    stats, and their percentiles;
  * `Throughput` — the featurize CLI's steady clips/s (first batch, which
    builds the kernels, discarded);
  * `trace_span` / `capture_trace` — a named range in a torch.profiler
    trace, and a trace of the card and the host written to a directory.
"""

from __future__ import annotations

import contextlib
import json
import time
from collections import deque
from pathlib import Path
from typing import Deque, Dict, Iterator, Optional

import numpy as np
import torch


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


class Throughput:
    """Items per second over the calls after the first `warmup` ones."""

    def __init__(self, warmup: int = 1):
        self._warmup = warmup
        self._n_calls = 0
        self._items = 0
        self._seconds = 0.0
        self._t0: Optional[float] = None

    def start(self) -> None:
        self._t0 = time.perf_counter()

    def stop(self, items: int) -> None:
        if self._t0 is None:
            raise RuntimeError("Throughput.stop() without a prior start()")
        dt = time.perf_counter() - self._t0
        self._n_calls += 1
        if self._n_calls > self._warmup:
            self._items += items
            self._seconds += dt

    @property
    def items_per_sec(self) -> float:
        return self._items / self._seconds if self._seconds else 0.0


@contextlib.contextmanager
def trace_span(name: str) -> Iterator[None]:
    """A named range in any active torch.profiler trace (a few microseconds
    when none is active)."""
    with torch.profiler.record_function(name):
        yield


@contextlib.contextmanager
def capture_trace(log_dir: str) -> Iterator[torch.profiler.profile]:
    """Profile the host and, where there is one, the card for the duration;
    writes a Chrome/Perfetto trace under `log_dir` on exit."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    Path(log_dir).mkdir(parents=True, exist_ok=True)
    with torch.profiler.profile(
        activities=activities,
        on_trace_ready=torch.profiler.tensorboard_trace_handler(log_dir),
    ) as prof:
        yield prof


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

    def percentiles(self) -> Dict[str, float]:
        """p50, p90 and p99 of the retained samples, and their count (all 0
        when there are none)."""
        arr = self.snapshot()
        if not arr.size:
            return {"p50": 0.0, "p90": 0.0, "p99": 0.0, "n": 0}
        return {
            "p50": float(np.percentile(arr, 50)),
            "p90": float(np.percentile(arr, 90)),
            "p99": float(np.percentile(arr, 99)),
            "n": int(arr.size),
        }
