"""One run of one cell: set-up, the measured window, the metrics, the check.

`execute` is the whole run behind port_bench/run.py. The cell's generator
(named by its traffic file) builds the system under test from the seed,
warms every shape it will use, measures for `seconds`, hands back the
program's outputs, frees the program, and compares them with the plain
reference. With --trace 1 a profiler covers the window and the per-layer
metrics are read from it; otherwise the end-to-end metrics are reported.
"""

from __future__ import annotations

import argparse
import gc
import json
import math
import sys
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from . import env, spec


@dataclass
class Run:
    """What a generator and the metric readers see of the run."""

    name: str
    seed: int
    seconds: float
    trace: bool
    t0: float
    bench: Dict
    cell: Dict
    config: Dict
    traffic: Dict
    device: object = None
    rehearse: bool = False
    setup_s: float = 0.0
    window: Dict = field(default_factory=dict)
    profile: object = None
    info: List[str] = field(default_factory=list)
    marks: List[tuple] = field(default_factory=list)

    def mark(self, name: str) -> None:
        """Note how far set-up has come (seconds since process start)."""
        self.marks.append((name, time.perf_counter() - self.t0))


def parse(argv: List[str]) -> argparse.Namespace:
    p = argparse.ArgumentParser(prog="port_bench/run.py", description=__doc__)
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--rehearse", action="store_true",
                   help="run on the CPU at the traffic file's rehearsal sizes (a dry run; no result for a card)")
    return p.parse_args(argv)


def build(args: argparse.Namespace, t0: float, overrides: Optional[Dict] = None) -> Run:
    """The run's description from BENCHMARK.json and the files it names;
    `overrides` replaces traffic keys (the rehearsal sizes, a sweep)."""
    bench = spec.benchmark()
    cell = spec.workload(bench, args.workload)
    traffic = spec.traffic(cell["traffic"])
    if args.rehearse:
        traffic.update(traffic.get("rehearsal", {}))
    traffic.update(overrides or {})
    return Run(name=cell["name"], seed=args.seed, seconds=args.seconds, trace=bool(args.trace), t0=t0,
               bench=bench, cell=cell, config=spec.configuration(bench, cell), traffic=traffic,
               rehearse=args.rehearse)


def _device(run: Run):
    import torch

    if run.rehearse:
        return torch.device("cpu")
    if not torch.cuda.is_available() or torch.cuda.device_count() < run.cell["chips"]:
        raise SystemExit(f"port_bench: {run.name} needs {run.cell['chips']} CUDA card(s); "
                         f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}")
    return torch.device("cuda", 0)


def _forbidden(where: str) -> None:
    found = env.forbidden_modules()
    if found:
        print(f"port_bench: forbidden modules loaded {where}: {', '.join(found)}", file=sys.stderr)
        raise SystemExit(3)


def measure(run: Run):
    """Set-up and the window. Returns the generator's cell object, its
    window closed and its program released."""
    import torch

    from . import trace

    run.mark("imports")
    run.device = _device(run)
    if run.device.type == "cuda":
        torch.cuda.init()
    run.mark("device")
    cell = spec.generator(run.traffic["generator"]).Cell(run)
    if run.device.type == "cuda":
        torch.cuda.synchronize(run.device)
    gc.collect()
    run.setup_s = time.perf_counter() - run.t0
    with trace.capture(run.trace and run.device.type == "cuda") as prof:
        cell.window()
    if prof is not None:
        run.profile = trace.summarize(prof)
    _forbidden("after the window")
    cell.memory_peak = (torch.cuda.max_memory_allocated(run.device) if run.device.type == "cuda" else 0)
    cell.release()
    gc.collect()
    if run.device.type == "cuda":
        torch.cuda.synchronize(run.device)
        torch.cuda.empty_cache()
    return cell


def metrics(run: Run, per_layer: bool) -> Dict[str, Dict]:
    entries = spec.per_layer(run.bench, run.name) if per_layer else spec.end_to_end(run.bench, run.name)
    out = {}
    for m in entries:
        value = spec.metric(m["name"]).read(run)
        if value is not None and math.isfinite(value):
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def execute(argv: List[str], t0: float) -> int:
    from . import check

    args = parse(argv)
    run = build(args, t0)
    cell = measure(run)
    result_metrics = metrics(run, run.trace)
    if run.trace:  # the traced window's end-to-end readings, for the tracing overhead
        run.info.append("traced window: " + ", ".join(
            f"{k} {v['value']!r}" for k, v in metrics(run, False).items() if k != "setup_s"))
    run.info.append("set-up: " + ", ".join(f"{n} {t:.3f}" for n, t in run.marks) + f", window {run.setup_s:.3f} s")
    numbers = cell.check()
    correct, rows = check.judge(numbers, spec.limits(run.name))
    _forbidden("after the check")

    import torch

    cuda = run.device.type == "cuda"
    device = {
        "platform": "gpu" if cuda else "cpu",
        "kind": torch.cuda.get_device_name(run.device) if cuda else "cpu",
        "count": run.cell["chips"] if cuda else 0,
        "memory_peak_bytes": int(cell.memory_peak),
        "power_limit": env.power_limit() if cuda else None,
    }
    result = {"correct": bool(correct), "attempted": int(run.window["attempted"]),
              "failed": int(run.window["failed"]), "metrics": result_metrics, "device": device}
    if run.profile is not None:
        device["busy_s"] = run.profile.busy_s
        device["window_s"] = run.profile.window_s
        result["breakdown"] = run.profile.breakdown()
    result["checks"] = {name: {"value": n, "limit": lim} for name, n, lim in rows}
    for line in run.info:
        print(f"port_bench: {line}", file=sys.stderr)
    print(f"port_bench: {run.name} seed {run.seed} on {device['kind']} ({device['power_limit']}), "
          f"setup {run.setup_s:.3f} s, window {run.window['seconds']:.3f} s", file=sys.stderr)
    for name, n, lim in rows:
        print(f"check {name} {n!r} limit {lim!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
