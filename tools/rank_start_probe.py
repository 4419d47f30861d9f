"""Where a training rank's start goes, on one NVIDIA card.

    python3 tools/rank_start_probe.py

A mesh call (`train(mesh=...)`, `cli.train --mesh`) starts each rank as a
fresh interpreter, which pays everything a process pays once before its
first train step. This runs that start in a child process, as a rank
would see it, and prints the host seconds of each part:
  interpreter  `python -c pass`;
  torch        `import torch`;
  port         importing the trainer (`cough_detector_tpu_torch.train`);
  cuda         the first tensor on the card (the CUDA context);
  kernel       loading the front-end kernel's library (built first, in
               this process, so the child only loads it);
  determinism  the flag as the trainer sets it on the card, its core
               `torch._C._set_deterministic_algorithms(True)`;
  determinism_public  `torch.use_deterministic_algorithms(True)` after
               it, which also sets torch.compile's inductor option, and
               which torch modules that imports (torch._inductor,
               torch._dynamo, sympy, triton);
  to_steps     train() on 64 + 32 synthetic clips (one epoch, batch 32)
               from entry to its "Steps:" line, with all the above paid.
Prints the card's name and power limit first. Needs a CUDA card and nvcc;
imports no JAX.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from pathlib import Path

os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
REPO = Path(__file__).resolve().parents[1]

_CHILD = r'''
import json, sys, time
marks = {}
t = time.perf_counter()
import torch
marks["torch"] = time.perf_counter() - t
sys.path.insert(0, sys.argv[1])
t = time.perf_counter()
import cough_detector_tpu_torch.train  # noqa: F401
marks["port"] = time.perf_counter() - t
t = time.perf_counter()
torch.zeros(1, device="cuda:0")
torch.cuda.synchronize()
marks["cuda"] = time.perf_counter() - t
from cough_detector_tpu_torch.ops import frontend_kernel
t = time.perf_counter()
frontend_kernel.build()
marks["kernel"] = time.perf_counter() - t
watched = ("torch._inductor", "torch._dynamo", "sympy", "triton")
before = {m for m in watched if m in sys.modules}
t = time.perf_counter()
torch._C._set_deterministic_algorithms(True)
marks["determinism"] = time.perf_counter() - t
torch._C._set_deterministic_algorithms(False)
t = time.perf_counter()
torch.use_deterministic_algorithms(True)
marks["determinism_public"] = time.perf_counter() - t
torch.use_deterministic_algorithms(False)
marks["determinism_public_imported"] = [m for m in watched if m in sys.modules and m not in before]
print(json.dumps(marks), flush=True)
'''


def main() -> None:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    sys.path.insert(0, str(REPO))
    import contextlib
    import io

    import numpy as np
    import torch

    from cough_detector_tpu_torch.config import Config, ModelConfig, TrainConfig
    from cough_detector_tpu_torch.data import pack_arrays, synth
    from cough_detector_tpu_torch.ops import frontend_kernel
    from cough_detector_tpu_torch.train import train

    frontend_kernel.build()
    torch.zeros(1, device="cuda:0")
    torch.use_deterministic_algorithms(True)
    torch.use_deterministic_algorithms(False)
    t = time.perf_counter()
    subprocess.run([sys.executable, "-c", "pass"], check=True)
    interpreter = time.perf_counter() - t
    child = subprocess.run([sys.executable, "-c", _CHILD, str(REPO)], capture_output=True, text=True, check=True)
    marks = json.loads(child.stdout.strip().splitlines()[-1])

    root = REPO / "build" / "rank_start_probe"
    labels = (np.arange(96) % 2).astype(np.int64)
    waves = np.stack([(synth.synthetic_cough if lab else synth.synthetic_non_cough)(i, 1.0)
                      for i, lab in enumerate(labels)])
    pack_arrays(waves[:64], labels[:64], str(root / "corpus" / "train"))
    pack_arrays(waves[64:], labels[64:], str(root / "corpus" / "val"))
    config = Config(model=ModelConfig(model_type="residual"), train=TrainConfig(batch_size=32, epochs=1))
    seen = []

    class Stamp(io.StringIO):
        def write(self, s: str) -> int:
            if s.startswith("Steps:") and not seen:
                seen.append(time.perf_counter())
            return super().write(s)

    t = time.perf_counter()
    with contextlib.redirect_stdout(Stamp()):
        train(None, str(root / "out"), config=config, shards_dir=str(root / "corpus"), device="cuda:0")
    marks["to_steps"] = seen[0] - t
    print(f"[{smi}] a fresh process's start, host s: interpreter {interpreter:.3f}, "
          + ", ".join(f"{k} {v:.3f}" if isinstance(v, float) else f"{k} {v}" for k, v in marks.items())
          + " (to_steps in a process that paid the rest)", flush=True)


if __name__ == "__main__":
    main()
