"""Readings that the limits of a cell's check are set from, in one process.

    python3 port_bench/tools/calibrate.py --workload <cell> --seconds S \
        --seeds a,b,c,... [--control-seeds x,y,z] [--out FILE]

For each seed of --seeds: the cell's set-up and a window of S seconds at
the cell's own size, then the numbers the check compares (the lower
readings). For each seed of --control-seeds: the same, then the numbers of
the control, the reference in float32 with TF32 on put in the program's
place (the upper readings). One JSON line a seed, on standard output and
appended to FILE.
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

from port_bench.lib import harness  # noqa: E402


def main(argv):
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--rehearse", action="store_true")
    p.add_argument("--out", default=None)
    a = p.parse_args(argv)
    seeds = [int(s) for s in a.seeds.split(",") if s]
    controls = [int(s) for s in a.control_seeds.split(",") if s]
    for seed in seeds + [s for s in controls if s not in seeds]:
        args = harness.parse(["--workload", a.workload, "--seed", str(seed), "--seconds", str(a.seconds)]
                             + (["--rehearse"] if a.rehearse else []))
        t0 = time.perf_counter()
        run = harness.build(args, t0)
        cell = harness.measure(run)
        rec = {"workload": a.workload, "seed": seed, "setup_s": run.setup_s, "window_s": run.window["seconds"],
               "attempted": run.window["attempted"], "failed": run.window["failed"]}
        if seed in seeds:
            t1 = time.perf_counter()
            rec["program"] = cell.check()
            rec["check_s"] = time.perf_counter() - t1
        if seed in controls:
            t1 = time.perf_counter()
            rec["control"] = cell.check(cell.control_answers())
            rec["control_s"] = time.perf_counter() - t1
        rec["info"] = run.info
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
