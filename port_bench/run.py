"""Run one cell of the port's benchmark once.

    python3 port_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout. Prints one JSON line last on standard
output: correct, attempted, failed, metrics (the cell's end-to-end metrics,
or with --trace 1 its per-layer ones), device, and with --trace 1 the
trace's breakdown; its last key, `checks`, holds each compared number with
its limit, which are also the last lines on standard error. Exits non-zero
without a result where the cell's CUDA cards are missing, or where a module
of JAX or of the JAX package is loaded.
"""

import time

T0 = time.perf_counter()

import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from port_bench.lib import env  # noqa: E402

env.pin_caches()

from port_bench.lib import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.execute(sys.argv[1:], T0))
