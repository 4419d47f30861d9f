"""What a train step costs the host and the card, on one NVIDIA card.

    python3 tools/train_step_probe.py

Times the port's train step (train/steps.py::train_step: augmentation p 0.3,
the fused front end, the residual model's forward and backward with dropout
0.5, clip + AdamW) with CUDA events over back-to-back steps at batch 32 and
256 on synthetic clips, in three settings taken in turns (each twice, in
the order a b c c b a):
  a. the trainer's deterministic mode as torch sets it, with its fill of
     every new tensor's memory (torch.utils.deterministic);
  b. the trainer's deterministic mode (the fill off);
  c. no deterministic mode (cuDNN may pick nondeterministic algorithms).
Then, under torch.profiler over 5 batch-32 steps in settings a and b: the
device kernels and the aten calls (nested ones included) a step, the
device's busy time a step and the largest device items. Last, in setting
b, the batch-32 step as the trainer runs it on the card, a captured CUDA
graph (train/steps.py::StepPrograms: the batch's rows gathered from the
corpus inside the graph), beside the eager step, in turns (eager, graphed,
graphed, eager): CUDA events, the host clock to a synchronize and the
host's enqueue time over 30 steps, and under torch.profiler the device
kernels and aten calls a step. Prints the card's name and power limit
first. Needs a CUDA card and nvcc; imports no JAX.
"""

from __future__ import annotations

import itertools
import os
import subprocess
import sys
import time
from pathlib import Path

os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import numpy as np  # noqa: E402
import torch  # noqa: E402
from torch.autograd import DeviceType  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from chip_smoke import busy_ms, cuda_ms  # noqa: E402
from cough_detector_tpu_torch.config import Config  # noqa: E402
from cough_detector_tpu_torch.data import quantize, synth  # noqa: E402
from cough_detector_tpu_torch.models import create_model, init_weights, no_tf32  # noqa: E402
from cough_detector_tpu_torch.ops import frontend_kernel  # noqa: E402
from cough_detector_tpu_torch.train import StepRandom, make_optimizer, train_step  # noqa: E402
from cough_detector_tpu_torch.train.steps import StepPrograms  # noqa: E402
from cough_detector_tpu_torch.train.loop import deterministic, make_feature_fns  # noqa: E402

SETTINGS = ("deterministic+fill", "deterministic", "plain")


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip())
    frontend_kernel.build()
    dev = torch.device("cuda")
    no_tf32(dev)
    cfg = Config()
    waves = np.stack([
        synth.synthetic_cough(i, 1.0) if i % 2 else synth.synthetic_non_cough(i, 1.0)
        for i in range(256)
    ])
    corpus = torch.from_numpy(quantize(waves)).to(dev)
    labels = torch.from_numpy(np.arange(256) % 2).to(dev)
    cw = torch.tensor([1.0, 1.0], device=dev)
    model = init_weights(create_model("residual"), torch.Generator().manual_seed(0)).to(dev)
    feature_fn, _ = make_feature_fns(cfg, dev, use_time_shift=True)
    opt = make_optimizer(model.parameters(), cfg.train, 64)
    rand, count = StepRandom(dev), itertools.count()
    fill = torch.utils.deterministic

    def step(b: int) -> None:
        train_step(
            model, opt, corpus[:b], labels[:b], cw, rand.key(0, 0, next(count)),
            feature_fn=feature_fn,
        )

    def in_setting(name: str, fn):
        if name == "plain":
            return fn()
        with deterministic(dev):
            fill.fill_uninitialized_memory = name == "deterministic+fill"
            try:
                return fn()
            finally:
                fill.fill_uninitialized_memory = False

    times = {}
    for name in SETTINGS + SETTINGS[::-1]:
        for b in (32, 256):
            times.setdefault((name, b), []).append(in_setting(name, lambda: cuda_ms(lambda: step(b), 30)))
    for (name, b), ms in times.items():
        print(f"step at batch {b} [{name}]: " + ", ".join(f"{t:.4f}" for t in ms) + " ms (CUDA events, 30 steps)")

    for name in SETTINGS[:2]:
        def profiled():
            step(32)
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                for _ in range(5):
                    step(32)
                torch.cuda.synchronize()
            return prof.events()

        events = in_setting(name, profiled)
        kernels = [e for e in events if e.device_type == DeviceType.CUDA and not e.name.startswith("cdt.")]
        aten = [e for e in events if e.device_type == DeviceType.CPU and e.name.startswith("aten::")]
        by_name = {}
        for e in kernels:
            by_name[e.name[:60]] = by_name.get(e.name[:60], 0.0) + e.time_range.elapsed_us()
        top = ", ".join(
            f"{k} {v / 5 / 1e3:.4f}" for k, v in sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
        )
        print(
            f"batch-32 step [{name}] (torch.profiler, 5 steps): {len(kernels) / 5:.1f} device kernels "
            f"and {len(aten) / 5:.1f} aten calls a step, device busy {busy_ms(kernels) / 5:.4f} ms a step; "
            f"largest device items (ms a step): {top}"
        )

    programs = StepPrograms(model, opt, cw, rand, feature_fn)
    idx, lab = np.arange(32), np.arange(32) % 2
    ways = {
        "eager": lambda: step(32),
        "graphed": lambda: programs.train(corpus, idx, lab, None, 0, 0, next(count)),
    }

    def timed(fn) -> tuple:
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(30):
            fn()
        enqueue = time.perf_counter() - t0
        torch.cuda.synchronize()
        return enqueue * 1e3 / 30, (time.perf_counter() - t0) * 1e3 / 30, cuda_ms(fn, 30)

    with deterministic(dev):
        runs = {}
        for name in ("eager", "graphed", "graphed", "eager"):
            runs.setdefault(name, []).append(timed(ways[name]))
        for name, fn in ways.items():
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                for _ in range(5):
                    fn()
                torch.cuda.synchronize()
            events = prof.events()
            kernels = [e for e in events if e.device_type == DeviceType.CUDA and not e.name.startswith("cdt.")]
            aten = [e for e in events if e.device_type == DeviceType.CPU and e.name.startswith("aten::")]
            print(
                f"batch-32 step, {name} [deterministic]: host enqueue "
                + ", ".join(f"{r[0]:.4f}" for r in runs[name]) + " ms, host clock to a synchronize "
                + ", ".join(f"{r[1]:.4f}" for r in runs[name]) + " ms, CUDA events "
                + ", ".join(f"{r[2]:.4f}" for r in runs[name]) + " ms a step (30 steps, two turns); "
                f"torch.profiler over 5 steps: {len(kernels) / 5:.1f} device kernels and "
                f"{len(aten) / 5:.1f} aten calls a step, device busy {busy_ms(kernels) / 5:.4f} ms a step"
            )


if __name__ == "__main__":
    main()
