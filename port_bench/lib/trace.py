"""torch.profiler over the measured window, reduced to what metrics read.

The window is the host span `port_bench.window` that the generator opens
around its measured loop; host spans named `port_bench.<phase>` inside it
say what the host was doing. Device activity (kernels, copies, sets) is
clipped to the window. Kernels are attributed to the front end by the
`__global__` names that the port's CUDA sources define, read at run time,
so a new or renamed kernel there needs no edit here.
"""

from __future__ import annotations

import contextlib
import json
import os
import re
import tempfile
from collections import defaultdict
from pathlib import Path
from typing import Dict, Iterator, List, Optional, Tuple

from .env import ROOT

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
CSRC = ROOT / "cough_detector_tpu_torch" / "csrc"
_GLOBAL = re.compile(r"__global__\s+(?:void\s+)?(?:__launch_bounds__\s*\([^)]*\)\s*)?(?:void\s+)?(\w+)\s*\(")


def frontend_kernels(csrc: Path = CSRC) -> List[str]:
    """The `__global__` function names the port's CUDA sources define."""
    names = set()
    for path in sorted(csrc.glob("*.cu")):
        names.update(_GLOBAL.findall(path.read_text()))
    return sorted(names)


def base_name(name: str) -> str:
    """A kernel's function name from its demangled signature."""
    head = re.sub(r"^void\s+", "", name.replace("(anonymous namespace)::", ""))
    head = re.split(r"[<(]", head, maxsplit=1)[0]
    return head.split("::")[-1].strip() or name


@contextlib.contextmanager
def capture(enabled: bool) -> Iterator[Optional[object]]:
    """A profiler over the block (CPU and CUDA activity), or nothing."""
    if not enabled:
        yield None
        return
    import torch

    prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                              torch.profiler.ProfilerActivity.CUDA])
    prof.start()
    try:
        yield prof
    finally:
        prof.stop()


def _merge(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for lo, hi in sorted(intervals):
        if out and lo <= out[-1][1]:
            out[-1][1] = max(out[-1][1], hi)
        else:
            out.append([lo, hi])
    return [(a, b) for a, b in out]


class Summary:
    """The traced window: its length, device busy time, device events
    (category, name, start, duration, all in seconds) and host spans."""

    def __init__(self, events: List[dict]):
        spans = [e for e in events if e.get("ph") == "X" and e.get("cat") == "user_annotation"
                 and str(e.get("name", "")).startswith("port_bench.")]
        win = [e for e in spans if e["name"] == "port_bench.window"]
        self.found = bool(win)
        lo = float(win[0]["ts"]) if win else 0.0
        hi = lo + float(win[0]["dur"]) if win else 0.0
        self.window_s = (hi - lo) * 1e-6
        self.device = []
        for e in events:
            if e.get("ph") != "X" or e.get("cat") not in DEVICE_CATS:
                continue
            a = max(float(e["ts"]), lo)
            b = min(float(e["ts"]) + float(e.get("dur", 0.0)), hi)
            if b > a:
                self.device.append((e["cat"], str(e["name"]), a * 1e-6, (b - a) * 1e-6))
        self.busy = _merge([(s, s + d) for _, _, s, d in self.device])
        self.busy_s = sum(b - a for a, b in self.busy)
        self.spans = [(e["name"], float(e["ts"]) * 1e-6, float(e["dur"]) * 1e-6) for e in spans
                      if e["name"] != "port_bench.window"]
        self.lo, self.hi = lo * 1e-6, hi * 1e-6

    def kernel_seconds(self, keep=lambda name: True) -> float:
        return sum(d for cat, name, _, d in self.device if cat == "kernel" and keep(name))

    def breakdown(self, top: int = 10) -> Dict[str, list]:
        by_op: Dict[str, float] = defaultdict(float)
        for _, name, _, d in self.device:
            by_op[base_name(name)[:120]] += d
        ops = sorted(by_op.items(), key=lambda kv: -kv[1])[:top]
        gaps = []
        edges = [self.lo] + [x for ab in self.busy for x in ab] + [self.hi]
        for a, b in zip(edges[::2], edges[1::2]):
            if b > a:
                mid = (a + b) / 2
                inside = [(n, s, d) for n, s, d in self.spans if s <= mid <= s + d]
                label = min(inside, key=lambda x: x[2])[0] if inside else "port_bench.other"
                gaps.append((label, b - a))
        gaps.sort(key=lambda g: -g[1])
        return {"device_ops": [[n, s] for n, s in ops], "idle_gaps": [[n, s] for n, s in gaps[:top]]}


def summarize(prof) -> Optional[Summary]:
    """The profiler's trace, read through a chrome-trace file in TMPDIR
    that is removed once read."""
    fd, path = tempfile.mkstemp(suffix=".json", prefix="port_bench_trace_")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as fh:
            data = json.load(fh)
    finally:
        os.unlink(path)
    events = data["traceEvents"] if isinstance(data, dict) else data
    summary = Summary(events)
    return summary if summary.found else None
