"""The serving knee: the cell's traffic at several stream counts, in one
process, each on a fresh detector.

    python3 port_bench/tools/serve_sweep.py --workload residual.serve \
        --streams 14336,16384,... --seconds 30 [--out FILE]

For each count: the tick latency's p50 and p95, the generator's lateness
(p95 over the window, and its median over the first and the last third,
to see whether it grows) and the ticks past the deadline. No check runs.
The knee is the highest count whose p95 stays under the deadline with
lateness not growing.
"""

import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from port_bench.lib import env  # noqa: E402

env.pin_caches()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402

import numpy as np  # noqa: E402

from port_bench.lib import harness  # noqa: E402


def main(argv):
    p = argparse.ArgumentParser()
    p.add_argument("--workload", default="residual.serve")
    p.add_argument("--streams", required=True)
    p.add_argument("--seconds", type=float, default=30.0)
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--rehearse", action="store_true")
    p.add_argument("--out", default=None)
    a = p.parse_args(argv)
    for n in [int(s) for s in a.streams.split(",")]:
        args = harness.parse(["--workload", a.workload, "--seed", str(a.seed), "--seconds", str(a.seconds)]
                             + (["--rehearse"] if a.rehearse else []))
        run = harness.build(args, time.perf_counter(), {"streams": n})
        cell = harness.measure(run)
        w = run.window
        lat, late = np.array(w["latency_s"]) * 1e3, np.array(w["late_s"]) * 1e3
        third = max(1, len(late) // 3)
        rec = {"streams": n, "setup_s": run.setup_s, "ticks": w["ticks"], "tick_p50_ms": float(np.percentile(lat, 50)),
               "tick_p95_ms": float(np.percentile(lat, 95)), "tick_max_ms": float(lat.max()),
               "late_p95_ms": float(np.percentile(late, 95)), "late_first_third_ms": float(np.median(late[:third])),
               "late_last_third_ms": float(np.median(late[-third:])), "failed": w["failed"],
               "memory_peak_bytes": int(cell.memory_peak), "info": run.info}
        line = json.dumps(rec)
        print(line, flush=True)
        if a.out:
            with open(a.out, "a") as fh:
                fh.write(line + "\n")
        del cell, run
        gc.collect()
        import torch

        if torch.cuda.is_available():
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()


if __name__ == "__main__":
    main(sys.argv[1:])
