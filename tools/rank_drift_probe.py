"""How far a change of summation order carries a training run, on one NVIDIA card.

    python3 tools/rank_drift_probe.py [--clips 2048]

Trains the residual model through cli.train for 2 epochs (batch 32) on
`--clips` + 256 synthetic clips packed as shards (chip_smoke.py phase 6's
corpus at 2048), three times with the step-loss probe on
(CDT_DEBUG_STEP_METRICS):
  plain    one process, as shipped (cuDNN's BatchNorm);
  twopass  one process, BatchNorm's masked two-pass sums with every row
           real: the same function, its sums in another order;
  gloo     two ranks on cuda:0 over gloo (cli.train --distributed), the
           corpus sharded by rows: the two-pass sums, halved and reduced
           across the ranks.
Prints, for each pair, each epoch's per-step relative loss difference
(the first 8 steps, the largest and the first step past 1e-5) and the
three runs' epoch records. Prints the card's name and power limit first.
Needs a CUDA card and nvcc; imports no JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import socket
import subprocess
import sys
from pathlib import Path

os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from chip_smoke import run_cli  # noqa: E402
from cough_detector_tpu_torch.cli import train as train_cli  # noqa: E402
from cough_detector_tpu_torch.data import pack_arrays, synth  # noqa: E402
from cough_detector_tpu_torch.models import layers  # noqa: E402
from cough_detector_tpu_torch.ops import frontend_kernel  # noqa: E402

KEYS = ("train_loss", "val_loss", "tp", "fp", "fn", "tn")


def corpus(n: int, seed0: int) -> tuple:
    labels = np.arange(n) % 2
    waves = np.stack([
        synth.synthetic_cough(seed0 + i, 1.0) if labels[i] else synth.synthetic_non_cough(seed0 + i, 1.0)
        for i in range(n)
    ])
    return waves, labels


def step_losses(text: str) -> dict:
    return {int(e): np.array(json.loads(v)) for e, v in re.findall(r"STEP_LOSSES epoch=(\d+) (\[.*\])", text)}


def records(out: Path) -> list:
    return [json.loads(line) for line in (out / "metrics.jsonl").read_text().splitlines()]


def two_ranks(argv: list) -> str:
    """argv through cli.train --distributed as two gloo ranks on cuda:0;
    returns rank 0's output."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    procs = []
    for r in range(2):
        env = dict(os.environ, RANK=str(r), WORLD_SIZE="2", LOCAL_RANK=str(r), LOCAL_WORLD_SIZE="2",
                   MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "cough_detector_tpu_torch.cli.train", "--distributed", "--dist-backend",
             "gloo", "--device", "cuda:0", *argv],
            env=env, cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        ))
    try:
        outs = [p.communicate(timeout=600)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    if any(p.returncode for p in procs):
        sys.exit("a rank failed:\n" + outs[0][-3000:] + outs[1][-3000:])
    return outs[0]


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--clips", type=int, default=2048, help="training clips (256 validation clips beside)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip())
    frontend_kernel.build()
    os.environ["CDT_DEBUG_STEP_METRICS"] = "1"
    root = REPO / "build" / "rank_drift"
    shutil.rmtree(root, ignore_errors=True)
    shards = root / "corpus"
    pack_arrays(*corpus(args.clips, 0), str(shards / "train"))
    pack_arrays(*corpus(256, args.clips), str(shards / "val"))
    # The corpus sharded by rows over the two ranks: past one budget, within two.
    budget = (args.clips + 256) * 32000 * 2 // 3

    def argv(name: str, *extra: str) -> list:
        return ["--shards", str(shards), "--output-dir", str(root / name), "--model-type", "residual",
                "--epochs", "2", *extra]

    losses = {"plain": step_losses(run_cli(train_cli.main, argv("plain"), echo=False))}
    forward = layers.BatchNorm.forward

    def two_pass(self, x, mask=None):
        if self.training and mask is None and x.dtype == torch.float32:
            mask = torch.ones(x.shape[0], device=x.device)
        return forward(self, x, mask)

    layers.BatchNorm.forward = two_pass
    try:
        losses["twopass"] = step_losses(run_cli(train_cli.main, argv("twopass"), echo=False))
    finally:
        layers.BatchNorm.forward = forward
    losses["gloo"] = step_losses(two_ranks(argv("gloo", "--device-corpus-budget", str(budget))))
    for a, b in (("twopass", "plain"), ("gloo", "plain"), ("gloo", "twopass")):
        for e in (0, 1):
            r = np.abs(losses[a][e] - losses[b][e]) / np.abs(losses[b][e])
            past = int(np.argmax(r > 1e-5)) if (r > 1e-5).any() else None
            print(
                f"{a} vs {b}, epoch {e} ({len(r)} steps): steps 0-7 {np.array2string(r[:8], precision=2)}; "
                f"largest {r.max():.3e} at step {int(r.argmax())}; first past 1e-5 at step {past}"
            )
    for name in losses:
        print(name, json.dumps([{k: rec[k] for k in KEYS} for rec in records(root / name)]))


if __name__ == "__main__":
    main()
