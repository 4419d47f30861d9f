"""Smoke run of the PyTorch port on one NVIDIA card: serving, training, and
files to detections.

    python3 chip_smoke.py

Phases, each printing its own lines; any failure raises and exits non-zero:
  1. a CUDA card is required; prints its name and power limit (nvidia-smi);
  2. builds the front-end kernel from csrc/ with nvcc (build seconds);
  3. holds each of the two front-end launches (spectral: waveform to power
     mel, 3xTF32 on the tensor cores; epilogue: power mel to features), and
     the pair, against its plain torch version on the card: the shipped
     config at B = 1, 17, 256, PCEN, pre-emphasis + delta-deltas, 32 mels,
     n_fft 256, 20 MFCCs at n_fft 256, f_max = 8 kHz, 128 mels, 128 mels x
     201 frames x 20 MFCCs with PCEN and delta-deltas, 36 MFCCs of 40 mels
     with delta-deltas, and f_max = 8 kHz on a batch with sine sweeps; fails above 1e-3 max-relative deviation. The
     spectral launch is also held against power_mel_split_reference, the
     model of its 3xTF32 arithmetic, and the features of a single TF32 pass
     are printed beside (the reason the kernel splits). Each launch's
     shared memory is held against its Python mirror, which the card route
     reads (frontend_kernel.card_supports), and a 160-mel config, more than
     the spectral launch takes, must run the torch chain on the card;
  4. times each launch and the pair, their plain versions and library
     yardsticks (torch.stft + matmuls, + the torch epilogue for the pair)
     with CUDA events at B = 256 and 4096, beside each launch's bound at the
     card's peak rate (TF32 tensor cores for the spectral launch, with its
     FP32 CUDA-core bound beside it) and memory rate; at B = 256 also each
     launch's device time from torch.profiler (back-to-back calls of a
     launch this short time the host's dispatch); and the epilogue launch
     at B = 4096 at n_fft 256 and with PCEN, beside its bound;
  5. serves: a DetectionServer on the card (residual model at full width,
     random weights from a seed, eager ticks, 8 slots, threshold 0) answers
     8 streams of 1.25 s from a loopback DetectionClient; its events must
     equal an in-process StreamingDetector's on the same audio, and both
     launch counters must have advanced while it served. Then the card's
     detector scores are held against the CPU's on a few windows, and 256
     streams run 1600-sample ticks for the p50 tick latency, then 20 more
     on the host clock alone and 20 under torch.profiler for the device's
     busy time and idle share;
  6. trains (the training path): synthesizes a corpus of 2048 training
     clips (half coughs) and 256 validation clips with data/synth.py and
     packs it as int16 shards under build/; holds one train step of the
     residual model (augmentation off, dropout 0, batch 32) on the card
     against the CPU (loss 1e-5 relative, every grad 1e-3 max-relative,
     running stats 1e-5), and a padded step (6 rows + 2 masked) against
     the unpadded one on the card; runs `train()` for 3 epochs at the
     shipped config and TrainConfig defaults on the resident corpus, then
     2 epochs and a resume to 3 through the training CLI (with
     --export-pt), which must equal the uninterrupted run bit for bit
     (parameters, optimizer state, metrics.jsonl); both front-end launch
     counters must have advanced once per train and eval step; times the
     steady train step at batch 32 and 256 (CUDA events), its device time
     by part (torch.profiler ranges, and each part alone by CUDA events),
     the epoch wall time and clips/s from metrics.jsonl, and the device's
     idle share over one profiled epoch; serves the exported `.pt` and the
     checkpoint directory through StreamingDetector;
  7. files to detections: writes a WAV data directory with cli.prepare_data
     (384 coughs, 768 non-coughs of 2 s, 30% hard negatives) and rewrites a
     quarter of it at 44.1 and 8 kHz; holds ops/resample.py on the card
     against the CPU (B = 64; 44.1k and 8k to 16k and the four speed
     factors; 1e-5 max abs, cuDNN's TF32 on at entry) and speed
     perturbation's apply on the same draws; trains the residual model
     from the directory through cli.train --data-dir for 3 epochs, then 2
     and a resume to 3 (bit-equal parameters, moments and metrics.jsonl;
     both launch counters one per train and eval step), with host decode
     clips/s, step ms, epoch wall and a profiled epoch's idle share beside
     phase 6's shard numbers; packs the directory with cli.pack (epoch 0's
     shard batches in the decode path's order and labels, waves within
     half an int16 LSB); scores a 10-minute recording with 40 coughs
     through cli.detect --wav (events at threshold 0 equal the streaming
     detector's, times exact, confidences 1e-4; probabilities within 1e-3
     of the CPU's; one launch of each kernel per 1024-window batch;
     detections at 0.5 against the true times; windows/s, batch ms, idle
     share); holds and times the kernel pair at B = 1024 and times
     torch.stft + mel at 1024 and 32; featurizes the directory with
     cli.featurize at batch 512 (16 clips within 1e-3 of the CPU chain);
     serves the trained `.pt` through CoughDetectorInference;
  8. prints the kernels' JSON line, then the device line last.

Imports only torch, numpy, scipy (data/synth.py) and the port package;
never JAX. It downloads nothing: the data are synthesized from seeds.
"""

from __future__ import annotations

import os

# The training phase asks for deterministic algorithms; torch then wants
# cuBLAS's workspace fixed, which it reads before the first cuBLAS call.
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

import concurrent.futures  # noqa: E402
import contextlib  # noqa: E402
import copy  # noqa: E402
import io  # noqa: E402
import itertools  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import shutil  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import time  # noqa: E402
from pathlib import Path  # noqa: E402

import numpy as np  # noqa: E402
import torch  # noqa: E402

SEED = 0
TOL = 1e-3
SR = 16000
CHUNK = 1600

# NVIDIA H100 SXM data sheet peaks (dense, no sparsity), at 700 W.
PEAK_FP32_FLOPS = 67e12   # FP32 on the CUDA cores, no tensor cores
PEAK_TF32_FLOPS = 495e12  # TF32 on the tensor cores
PEAK_HBM_BYTES = 3.35e12


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    return ((got - want).abs().max() / want.abs().max().clamp_min(1e-8)).item()


def make_audio(rng: np.random.Generator, n_streams: int, n_samples: int) -> np.ndarray:
    """Background noise with cough-like bursts: decaying noise plus a
    low tone, at random places and levels."""
    out = (rng.standard_normal((n_streams, n_samples)) * 0.01).astype(np.float32)
    t = np.arange(int(0.3 * SR)) / SR
    for s in range(n_streams):
        for _ in range(max(1, n_samples // SR * 2)):
            start = rng.integers(0, n_samples - t.size)
            env = np.exp(-t / rng.uniform(0.03, 0.12))
            burst = rng.standard_normal(t.size) + np.sin(2 * np.pi * rng.uniform(150, 800) * t)
            out[s, start : start + t.size] += (rng.uniform(0.2, 0.9) * env * burst).astype(np.float32)
    return out


def make_sweeps(rng: np.random.Generator, n_streams: int, n_samples: int) -> np.ndarray:
    """Log chirps from 100 Hz to 7 kHz at random levels, as in the JAX
    package's fixture batch (data/synth.py::sine_sweep)."""
    t = np.linspace(0.0, n_samples / SR, n_samples)
    k = (7000.0 / 100.0) ** (SR / n_samples)
    phase = 2 * np.pi * 100.0 * (k**t - 1) / np.log(k)
    amp = rng.uniform(0.3, 0.9, (n_streams, 1))
    return (amp * np.sin(phase)[None]).astype(np.float32)


def cuda_ms(fn, iters: int, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters: int, kernel: str) -> float:
    """Mean device time of the kernel whose name holds `kernel` over
    `iters` calls of fn, from torch.profiler: the card's own clock, with no
    host dispatch in it. The mean is over the launches the profiler
    recorded, which may miss one at the edge of its window."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    times = [
        e.time_range.elapsed_us() for e in prof.events()
        if e.device_type == DeviceType.CUDA and kernel in e.name
    ]
    if not iters // 2 <= len(times) <= iters:
        fail(f"the profiler saw {len(times)} launches of {kernel} over {iters} calls")
    return sum(times) / len(times) / 1e3


def busy_ms(events, lo: float = float("-inf"), hi: float = float("inf")) -> float:
    """Union of the device events' intervals inside [lo, hi] (us), in ms.
    The device-side copies of the trainer's "cdt." profiler ranges span
    whole epochs and are left out: only kernels, copies and fills count."""
    from torch.autograd import DeviceType

    spans = sorted(
        (max(e.time_range.start, lo), min(e.time_range.end, hi)) for e in events
        if e.device_type == DeviceType.CUDA and not e.name.startswith("cdt.")
        and e.time_range.end > lo and e.time_range.start < hi
    )
    busy, reach = 0.0, float("-inf")
    for start, end in spans:
        busy += max(0.0, end - max(start, reach))
        reach = max(reach, end)
    return busy / 1e3


def hold_grads(model, got, want, tol: float) -> float:
    """Worst grad error: each grad's max-relative deviation, except the conv
    biases, whose exact train-mode gradient is 0 (each conv feeds a
    BatchNorm, whose batch mean removes a per-channel constant): for those,
    the deviation relative to the model's largest grad. Fails above tol."""
    named = dict(model.named_parameters())
    scale = max(float(w.abs().max()) for w in want)
    worst = 0.0
    for (name, p), g, w in zip(named.items(), got, want):
        conv_bias = name.endswith(".bias") and named[name[: -len("bias")] + "weight"].ndim == 4
        denom = scale if conv_bias else max(float(w.abs().max()), 1e-12)
        err = float((g - w).abs().max()) / denom
        worst = max(worst, err)
        if not err <= tol:
            fail(f"grad of {name} off by {err:.3e} (limit {tol})")
    return worst


def train_phase(smi: str) -> dict:
    """Phase 6, the training path; returns what the kernels' JSON line adds."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from cough_detector_tpu_torch.augment import augment_waveforms, spec_augment
    from cough_detector_tpu_torch.cli import train as train_cli
    from cough_detector_tpu_torch.config import Config, FeatureConfig, ModelConfig, TrainConfig
    from cough_detector_tpu_torch.data import dequantize_torch, pack_arrays, quantize, synth
    from cough_detector_tpu_torch.models import create_model, init_weights, no_tf32
    from cough_detector_tpu_torch.ops import frontend, frontend_kernel
    from cough_detector_tpu_torch.stream import StreamingDetector
    from cough_detector_tpu_torch.train import (
        StepRandom, checkpoint, loss_and_grads, make_optimizer, train, train_step,
    )
    from cough_detector_tpu_torch.train.loop import deterministic, make_feature_fns

    t_phase = time.perf_counter()
    dev = torch.device("cuda")
    no_tf32(dev)
    root = Path(__file__).resolve().parent / "build" / "smoke_train"
    shutil.rmtree(root, ignore_errors=True)
    shards = root / "corpus"
    n_train, n_val, bs = 2048, 256, TrainConfig().batch_size

    # -- 6.1 corpus
    def corpus(n: int, seed0: int) -> tuple:
        labels = np.arange(n) % 2  # half coughs
        waves = np.stack([
            synth.synthetic_cough(seed0 + i, 1.0) if labels[i] else synth.synthetic_non_cough(seed0 + i, 1.0)
            for i in range(n)
        ])
        return waves, labels

    t0 = time.perf_counter()
    train_w, train_l = corpus(n_train, SEED)
    pack_arrays(train_w, train_l, str(shards / "train"))
    pack_arrays(*corpus(n_val, SEED + n_train), str(shards / "val"))
    print(f"training corpus: {n_train} + {n_val} clips synthesized and packed in {time.perf_counter() - t0:.3f} s", flush=True)

    # -- 6.2 one train step, card against CPU (augmentation off, dropout 0)
    step_cfg = Config(model=ModelConfig(dropout=0.0), train=TrainConfig(p_augment=0.0))
    waves16 = torch.from_numpy(quantize(train_w[:bs]))
    labels = torch.from_numpy(train_l[:bs])
    cw = torch.tensor([1.0, 1.0])  # a balanced corpus's class weights
    base = init_weights(create_model("residual", dropout=0.0), torch.Generator().manual_seed(SEED))
    def one_step(d: torch.device, feats: torch.Tensor) -> tuple:
        model = copy.deepcopy(base).to(d)
        gen = StepRandom(d).key(SEED, 0, 0).dropout
        loss, _, grads = loss_and_grads(model, feats.to(d), labels.to(d), cw.to(d), generator=gen)
        stats = [v.cpu() for k, v in model.state_dict().items() if "running" in k]
        return loss.cpu(), [g.cpu() for g in grads], stats, model

    feats = {}
    for where in ("cpu", "cuda"):
        d = torch.device(where)
        feature_fn, _ = make_feature_fns(step_cfg, d, use_time_shift=True)
        feats[where] = feature_fn(waves16.to(d), StepRandom(d).key(SEED, 0, 0).aug)
    loss_c, grads_c, stats_c, model_c = one_step(torch.device("cpu"), feats["cpu"])
    loss_g, grads_g, stats_g, _ = one_step(dev, feats["cuda"])
    # The same step on the card from the CPU's features: the model's own
    # arithmetic, without the front ends' difference (phase 3 holds those).
    _, grads_s, _, _ = one_step(dev, feats["cpu"])
    feat_err = rel_err(feats["cuda"].cpu(), feats["cpu"])
    loss_err = abs(float(loss_g) - float(loss_c)) / abs(float(loss_c))
    grad_err = hold_grads(model_c, grads_s, grads_c, 1e-3)
    grad_own = hold_grads(model_c, grads_g, grads_c, float("inf"))
    stat_err = max(float((a - b).abs().max()) for a, b in zip(stats_g, stats_c))
    print(
        f"train step card vs CPU (batch {bs}, residual, augmentation off, dropout 0; each through its own "
        f"front end, features max-relative {feat_err:.3e}): loss {float(loss_g):.6f} vs {float(loss_c):.6f}, "
        f"relative {loss_err:.3e} (limit 1e-5); running stats max abs {stat_err:.3e} (limit 1e-5); grads "
        f"worst {grad_own:.3e} (no limit); from the same features, grads worst {grad_err:.3e} (limit 1e-3)",
        flush=True,
    )
    if not (loss_err <= 1e-5 and stat_err <= 1e-5):
        fail("the card's train step disagrees with the CPU's")
    feats_g = feats["cuda"]

    # A padded step on the card: 6 real rows + 2 masked (the explicit
    # two-pass batch norm) against the 6 rows unmasked (cuDNN's).
    mask = torch.tensor([1.0] * 6 + [0.0] * 2, device=dev)
    padded = []
    for x, y, m in ((feats_g[:8], labels[:8], mask), (feats_g[:6], labels[:6], None)):
        model = copy.deepcopy(base).to(dev)
        loss, _, grads = loss_and_grads(model, x, y.to(dev), cw.to(dev), mask=m)
        padded.append((loss.cpu(), [g.cpu() for g in grads], [v.cpu() for k, v in model.state_dict().items() if "running" in k], model))
    (loss_p, grads_p, stats_p, model_p), (loss_u, grads_u, stats_u, _) = padded
    pad_loss = abs(float(loss_p) - float(loss_u)) / abs(float(loss_u))
    pad_grad = hold_grads(model_p, grads_p, grads_u, 1e-4)
    pad_stat = max(float((a - b).abs().max()) for a, b in zip(stats_p, stats_u))
    print(
        f"padded step on the card (6 rows + 2 masked vs 6 rows, masked two-pass BN vs cuDNN BN): loss "
        f"relative {pad_loss:.3e}, grads worst {pad_grad:.3e}, running stats max abs {pad_stat:.3e} (limits 1e-5, 1e-4, 1e-5)",
        flush=True,
    )
    if not (pad_loss <= 1e-5 and pad_stat <= 1e-5):
        fail("a padded step on the card differs from the unpadded one")

    # -- 6.3 train() for 3 epochs; 2 epochs and a resume to 3 through the CLI
    def records(out: Path) -> list:
        return [json.loads(line) for line in (out / "metrics.jsonl").read_text().splitlines()]

    out_a, out_b = root / "straight", root / "resumed"
    steps_per_epoch, val_steps = n_train // bs, -(-n_val // bs)
    frontend_kernel.SPECTRAL_LAUNCHES = frontend_kernel.EPILOGUE_LAUNCHES = 0
    t0 = time.perf_counter()
    best_a = train(None, str(out_a), config=Config(train=TrainConfig(epochs=3)), shards_dir=str(shards))
    wall_a = time.perf_counter() - t0
    launches = {"spectral": frontend_kernel.SPECTRAL_LAUNCHES, "epilogue": frontend_kernel.EPILOGUE_LAUNCHES}
    recs_a = records(out_a)
    want_launches = 3 * (steps_per_epoch + val_steps)
    print(
        f"train(): 3 epochs in {wall_a:.3f} s; front-end launches {launches}, expected "
        f"{want_launches} each (3 x ({steps_per_epoch} train + {val_steps} eval steps)); "
        f"losses {[(r['train_loss'], r['val_loss']) for r in recs_a]}; best {best_a}",
        flush=True,
    )
    if set(launches.values()) != {want_launches}:
        fail(f"the front-end launches {launches} on the training path are not {want_launches} each")
    state_a = checkpoint.load_checkpoint(str(out_a / "latest_model"))[0]
    finite = np.isfinite([v for r in recs_a for v in (r["train_loss"], r["val_loss"])]).all() and all(
        bool(torch.isfinite(v).all()) for v in state_a["model"].values() if v.is_floating_point()
    )
    if len(recs_a) != 3 or not finite:
        fail("train() did not write 3 epochs of finite losses and parameters")

    train(None, str(out_b), config=Config(train=TrainConfig(epochs=2)), shards_dir=str(shards))
    train_cli.main([
        "--shards", str(shards), "--output-dir", str(out_b), "--model-type", "residual",
        "--epochs", "3", "--batch-size", str(bs), "--lr", str(TrainConfig().learning_rate),
        "--weight-decay", str(TrainConfig().weight_decay), "--patience", str(TrainConfig().patience),
        "--resume", str(out_b / "latest_model"), "--export-pt",
    ])
    state_b = checkpoint.load_checkpoint(str(out_b / "latest_model"))[0]
    skip = {"train_clips_per_sec", "val_clips_per_sec", "wall_s", "t"}
    same_records = [{k: v for k, v in r.items() if k not in skip} for r in recs_a] == [
        {k: v for k, v in r.items() if k not in skip} for r in records(out_b)
    ]
    same_params = all(torch.equal(v, state_b["model"][k]) for k, v in state_a["model"].items())
    same_opt = all(
        torch.equal(x, y) for x, y in zip(
            state_a["optimizer"]["mu"] + state_a["optimizer"]["nu"],
            state_b["optimizer"]["mu"] + state_b["optimizer"]["nu"],
        )
    )
    print(
        f"resume (2 epochs, then the CLI to 3) vs 3 straight epochs: parameters bit-equal {same_params}, "
        f"optimizer state bit-equal {same_opt}, metrics.jsonl records equal {same_records}",
        flush=True,
    )
    if not (same_params and same_opt and same_records):
        fail("the resumed run differs from the uninterrupted one")

    # -- 6.4 times
    cfg = Config()
    model = init_weights(create_model("residual"), torch.Generator().manual_seed(SEED)).to(dev)
    feature_fn, _ = make_feature_fns(cfg, dev, use_time_shift=True)
    corpus_d = torch.from_numpy(quantize(train_w[:256])).to(dev)
    labels_d = torch.from_numpy(train_l[:256]).to(dev)
    cw_d = cw.to(dev)

    def profiled_busy(fn, n: int = 20) -> float:
        """Device busy ms a call of fn over n calls, from torch.profiler."""
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        return busy_ms(prof.events()) / n

    times, step_busy = {}, {}
    with deterministic(dev):
        for b, iters in ((32, 50), (256, 20)):
            opt = make_optimizer(model.parameters(), cfg.train, steps_per_epoch)
            rand, count = StepRandom(dev), itertools.count()

            def one_step(b=b, opt=opt, rand=rand, count=count):
                train_step(
                    model, opt, corpus_d[:b], labels_d[:b], cw_d, rand.key(SEED, 0, next(count)),
                    feature_fn=feature_fn,
                )

            times[b] = cuda_ms(one_step, iters)
            step_busy[b] = profiled_busy(one_step)

        # The parts of a batch-32 step, each alone.
        gen = torch.Generator(device=dev).manual_seed(SEED)
        w32 = frontend.peak_normalize(dequantize_torch(corpus_d[:32]))
        feats32 = feature_fn(corpus_d[:32], gen)
        _, _, grads32 = loss_and_grads(model, feats32, labels_d[:32], cw_d, generator=gen)
        opt = make_optimizer(model.parameters(), cfg.train, steps_per_epoch)

        def augment_alone():
            waves = augment_waveforms(dequantize_torch(corpus_d[:32]), gen, p=cfg.train.p_augment)
            frontend.peak_normalize(waves)
            spec_augment(feats32, gen, p=cfg.train.p_augment)

        parts = {
            "augment": augment_alone,
            "frontend": lambda: frontend.extract_features_fast(w32, FeatureConfig(), device=dev),
            "forward_backward": lambda: loss_and_grads(model, feats32, labels_d[:32], cw_d, generator=gen),
            "optimizer": lambda: opt.step(grads32),
        }
        part_ms = {k: cuda_ms(fn, 50) for k, fn in parts.items()}
        part_dev = {k: profiled_busy(fn) for k, fn in parts.items()}
        mel32 = frontend_kernel.power_mel_fused(w32, FeatureConfig())
        launches_32 = {
            "spectral": (lambda: frontend_kernel.power_mel_fused(w32, FeatureConfig()), "spectral_kernel"),
            "epilogue": (lambda: frontend_kernel.mel_epilogue_fused(mel32, FeatureConfig()), "epilogue_kernel"),
        }
        launch_ms = {k: cuda_ms(fn, 50) for k, (fn, _) in launches_32.items()}
        launch_dev = {k: device_ms(fn, 50, name) for k, (fn, name) in launches_32.items()}
    for b in (32, 256):
        print(
            f"[{smi}] train step at batch {b} (CUDA events over back-to-back steps, resident batch, "
            f"augmentation p=0.3, dropout 0.5): {times[b]:.4f} ms ({b / times[b] * 1e3:,.0f} clips/s); "
            f"device busy {step_busy[b]:.4f} ms a step (torch.profiler), idle share {1 - step_busy[b] / times[b]:.3f}",
            flush=True,
        )
    print(
        f"[{smi}] batch-32 step by part, each alone: CUDA events "
        + ", ".join(f"{k} {v:.4f}" for k, v in part_ms.items())
        + " ms; device busy (torch.profiler) "
        + ", ".join(f"{k} {v:.4f}" for k, v in part_dev.items())
        + (f" ms; the front end {100 * part_dev['frontend'] / step_busy[32]:.1f}% of the step's device time; "
           if step_busy[32] > 0 else " ms; the profiler recorded no device time, shares not measured; ")
        + f"its launches at B=32: spectral {launch_ms['spectral']:.4f} ms (device {launch_dev['spectral']:.4f}), "
        f"epilogue {launch_ms['epilogue']:.4f} ms (device {launch_dev['epilogue']:.4f})",
        flush=True,
    )
    deltas = [b["wall_s"] - a["wall_s"] for a, b in zip(recs_a, recs_a[1:])]
    print(
        f"[{smi}] epoch wall (metrics.jsonl wall_s deltas, {n_train} train + {n_val} val clips, checkpoints included): "
        + ", ".join(f"{d:.3f} s ({n_train / d:,.0f} train clips/s)" for d in deltas),
        flush=True,
    )

    # Idle share over one epoch: a resumed run of one more epoch under the
    # profiler; busy time is the union of device intervals inside its
    # "cdt.epoch" range (train and validation, no checkpoint writes).
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        train(None, str(root / "profiled"), config=Config(train=TrainConfig(epochs=4)),
              shards_dir=str(shards), resume=str(out_a / "latest_model"))
    events = prof.events()
    epoch_ev = [e for e in events if e.device_type == DeviceType.CPU and e.name == "cdt.epoch"]
    last = recs_a[-1]
    plain_ms = (n_train / last["train_clips_per_sec"] + n_val / last["val_clips_per_sec"]) * 1e3
    epoch_idle = None
    if len(epoch_ev) == 1:
        lo, hi = epoch_ev[0].time_range.start, epoch_ev[0].time_range.end
        busy = busy_ms(events, lo, hi)
        span = (hi - lo) / 1e3
        epoch_idle = 1 - busy / plain_ms
        print(
            f"[{smi}] one epoch under torch.profiler: {span:.3f} ms span, device busy {busy:.3f} ms, "
            f"idle share {1 - busy / span:.3f}; against the unprofiled epoch 2 of train() "
            f"({plain_ms:.3f} ms train + val): idle share {1 - busy / plain_ms:.3f}",
            flush=True,
        )
    else:
        print(f"[{smi}] the profiler recorded {len(epoch_ev)} epoch ranges; idle share not measured", flush=True)

    # -- 6.5 train to serve: the exported .pt and the checkpoint directory
    windows = train_w[:8]
    scores = [
        StreamingDetector(str(path), device="cuda").scores_for(windows)
        for path in (out_b / "best_model.pt", out_b / "best_model")
    ]
    serve_err = float(np.abs(scores[0] - scores[1]).max())
    print(
        f"served the trained model: best_model.pt and best_model/ score {len(windows)} windows "
        f"{np.round(scores[0], 4).tolist()}, max abs difference {serve_err:.3e}",
        flush=True,
    )
    if not (all(np.isfinite(s).all() and s.shape == (8,) for s in scores) and serve_err <= 1e-6):
        fail("the exported checkpoint and the checkpoint directory do not serve the same scores")
    print(f"training phase: {time.perf_counter() - t_phase:.3f} s", flush=True)
    return {
        "launches": launches, "ms_b32": launch_ms, "device_ms_b32": launch_dev,
        "shard": {
            "step_ms_b32": times[32], "epoch_wall_s": deltas,
            "train_clips_per_s": [n_train / d for d in deltas], "idle_share": epoch_idle,
        },
    }


def run_cli(main, argv, echo: bool = True) -> str:
    """Run a CLI's main(argv) in this process; returns what it printed,
    echoed unless `echo` is False."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        main(argv)
    out = buf.getvalue()
    if echo:
        print(out, end="", flush=True)
    return out


def synth_recording(rng: np.random.Generator, seconds: int, n_coughs: int) -> tuple:
    """Seeded background (noise at a slowly varying level plus a hum) with
    `n_coughs` 1 s synthetic coughs at seeded, non-overlapping times;
    returns (wave, sorted cough start times in seconds)."""
    from cough_detector_tpu_torch.data import synth

    n = seconds * SR
    level = np.interp(np.arange(n), np.linspace(0, n, 61), rng.uniform(0.005, 0.03, 61))
    wave = rng.standard_normal(n) * level + 0.01 * np.sin(2 * np.pi * 60.0 * np.arange(n) / SR)
    slots = np.sort(rng.choice(np.arange(2, seconds - 2, 3), size=n_coughs, replace=False))
    starts = slots + rng.uniform(0.0, 1.0, n_coughs)
    for i, t0 in enumerate(starts):
        c = synth.synthetic_cough(SEED + 5000 + i, 1.0)
        lo = int(t0 * SR)
        wave[lo : lo + c.size] += rng.uniform(0.3, 0.9) * c
    return (wave / np.abs(wave).max() * 0.9).astype(np.float32), starts


def files_phase(smi: str, shard: dict, yard: dict) -> dict:
    """Phase 7, files to detections; returns what the kernels' JSON line adds."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from cough_detector_tpu_torch.augment import waveform as augment_wave
    from cough_detector_tpu_torch.cli import detect as detect_cli
    from cough_detector_tpu_torch.cli import featurize as featurize_cli
    from cough_detector_tpu_torch.cli import pack as pack_cli
    from cough_detector_tpu_torch.cli import prepare_data as prepare_cli
    from cough_detector_tpu_torch.cli import train as train_cli
    from cough_detector_tpu_torch.config import FeatureConfig, TrainConfig
    from cough_detector_tpu_torch.data import (
        BatchLoader, CoughDataset, ShardLoader, audio_io, dequantize, prepare_dataset_split,
    )
    from cough_detector_tpu_torch.models import model_from_config, place_model
    from cough_detector_tpu_torch.ops import frontend, frontend_kernel, resample
    from cough_detector_tpu_torch.stream import CoughDetectorInference, StreamingDetector, offline
    from cough_detector_tpu_torch.stream.detector import _load_checkpoint
    from cough_detector_tpu_torch.train import checkpoint

    t_phase = time.perf_counter()
    dev = torch.device("cuda")
    shipped = FeatureConfig()
    root = Path(__file__).resolve().parent / "build" / "smoke_files"
    shutil.rmtree(root, ignore_errors=True)
    data = root / "data"
    rng = np.random.default_rng(SEED + 7)

    # -- 7.1 a WAV data directory; a quarter of it at 44.1 and 8 kHz
    t0 = time.perf_counter()
    run_cli(prepare_cli.main, [
        "--output-dir", str(data), "--esc50-dir", str(root / "no_esc50"), "--skip-download",
        "--synthetic-coughs", "384", "--synthetic-non-coughs", "768", "--hard-negatives", "0.3",
        "--seed", str(SEED),
    ])
    wavs = sorted(data.rglob("*.wav"))
    rates = {}
    for k, rate in enumerate((44100, 8000)):
        paths = wavs[1 + 4 * k :: 8]
        clips = torch.from_numpy(np.stack([audio_io.read_wav(p)[0][0] for p in paths])).to(dev)
        for path, wave in zip(paths, resample.resample(clips, SR, rate).cpu().numpy()):
            audio_io.write_wav(path, wave, rate)
        rates[rate] = len(paths)
    print(
        f"data directory: {len(wavs)} clips of 2 s written by cli.prepare_data and {rates} rewritten "
        f"at other rates in {time.perf_counter() - t0:.3f} s",
        flush=True,
    )

    # -- 7.2 the resampler on the card against the CPU (cuDNN's TF32 on at entry)
    factors = (0.9, 0.95, 1.05, 1.1)
    pairs = [(44100, SR), (8000, SR)] + [(SR, int(round(SR / f))) for f in factors]
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(pairs)) as pool:  # the banks, built at once
        list(pool.map(lambda p: resample._sinc_kernel(p[0] // math.gcd(*p), p[1] // math.gcd(*p)), pairs))
    bank_s = time.perf_counter() - t0
    torch.backends.cudnn.allow_tf32 = True
    resample_err = {}
    for orig, new in pairs:
        x = make_audio(rng, 64, orig)
        x /= np.abs(x).max(axis=1, keepdims=True)
        want = resample.resample(torch.from_numpy(x), orig, new)
        got = resample.resample(torch.from_numpy(x).to(dev), orig, new).cpu()
        resample_err[f"{orig}->{new}"] = float((got - want).abs().max()) if got.shape == want.shape else float("inf")
    tf32_after = torch.backends.cudnn.allow_tf32
    gen = torch.Generator().manual_seed(SEED)
    x = torch.from_numpy(make_audio(rng, 16, SR))
    draws = augment_wave.speed_draws(gen, 16, 0.7, len(factors))
    want = augment_wave.speed_apply(x, draws, factors)
    got = augment_wave.speed_apply(x.to(dev), augment_wave.SpeedDraws(*(d.to(dev) for d in draws)), factors).cpu()
    speed_err = float((got - want).abs().max())
    torch.backends.cudnn.allow_tf32 = False  # the models' setting (phase 5)
    print(
        f"resample card vs CPU at B=64 on unit-peak audio, cuDNN TF32 on at entry and {tf32_after} after "
        f"(banks built in {bank_s:.3f} s): max abs {resample_err}; speed_perturbation apply at B=16 on the "
        f"same draws ({int(draws.apply.sum())} clips stretched): max abs {speed_err:.3e} (limit 1e-5)",
        flush=True,
    )
    if not (max(resample_err.values()) <= 1e-5 and speed_err <= 1e-5 and tf32_after):
        fail("the resampler on the card disagrees with the CPU's, or left TF32 changed")

    # -- 7.3 training from the data directory through the CLI
    bs = TrainConfig().batch_size
    train_ds, val_ds = prepare_dataset_split(str(data))
    steps_per_epoch, val_steps = len(train_ds) // bs, -(-len(val_ds) // bs)
    loader = BatchLoader(train_ds, bs, shipped, num_workers=4)
    t0 = time.perf_counter()
    n_dec = sum(len(lab) for _, lab in loader)
    decode_cps = n_dec / (time.perf_counter() - t0)
    by_rate = {}
    for path in wavs:
        rate = audio_io.read_wav(path)[1]
        if len(by_rate.setdefault(rate, [])) < 16:
            by_rate[rate].append(path)
    decode_ms = {}
    for rate, paths in sorted(by_rate.items()):
        t0 = time.perf_counter()
        for path in paths:
            audio_io.load_mono_16k(path)
        decode_ms[rate] = (time.perf_counter() - t0) / len(paths) * 1e3

    def train_args(out: Path, epochs: int) -> list:
        return [
            "--data-dir", str(data), "--no-esc50", "--output-dir", str(out), "--model-type", "residual",
            "--epochs", str(epochs), "--batch-size", str(bs), "--lr", str(TrainConfig().learning_rate),
            "--weight-decay", str(TrainConfig().weight_decay), "--patience", str(TrainConfig().patience),
            "--num-workers", "4",
        ]

    def records(out: Path) -> list:
        return [json.loads(line) for line in (out / "metrics.jsonl").read_text().splitlines()]

    out_a, out_b = root / "straight", root / "resumed"
    frontend_kernel.SPECTRAL_LAUNCHES = frontend_kernel.EPILOGUE_LAUNCHES = 0
    t0 = time.perf_counter()
    train_cli.main(train_args(out_a, 3) + ["--export-pt"])
    wall_a = time.perf_counter() - t0
    train_launches = {"spectral": frontend_kernel.SPECTRAL_LAUNCHES, "epilogue": frontend_kernel.EPILOGUE_LAUNCHES}
    want_launches = 3 * (steps_per_epoch + val_steps)
    recs_a = records(out_a)
    print(
        f"cli.train --data-dir: 3 epochs in {wall_a:.3f} s ({len(train_ds)} train + {len(val_ds)} val clips); "
        f"front-end launches {train_launches}, expected {want_launches} each (3 x ({steps_per_epoch} train + "
        f"{val_steps} eval steps)); losses {[(r['train_loss'], r['val_loss']) for r in recs_a]}",
        flush=True,
    )
    if set(train_launches.values()) != {want_launches}:
        fail(f"the front-end launches {train_launches} on the decode path are not {want_launches} each")
    if len(recs_a) != 3 or not np.isfinite([v for r in recs_a for v in (r["train_loss"], r["val_loss"])]).all():
        fail("cli.train --data-dir did not write 3 epochs of finite losses")
    run_cli(train_cli.main, train_args(out_b, 2))
    run_cli(train_cli.main, train_args(out_b, 3) + ["--resume", str(out_b / "latest_model")])
    state_a = checkpoint.load_checkpoint(str(out_a / "latest_model"))[0]
    state_b = checkpoint.load_checkpoint(str(out_b / "latest_model"))[0]
    skip = {"train_clips_per_sec", "val_clips_per_sec", "wall_s", "t"}
    same_records = [{k: v for k, v in r.items() if k not in skip} for r in recs_a] == [
        {k: v for k, v in r.items() if k not in skip} for r in records(out_b)
    ]
    same_params = all(torch.equal(v, state_b["model"][k]) for k, v in state_a["model"].items())
    same_opt = all(
        torch.equal(x, y) for x, y in zip(
            state_a["optimizer"]["mu"] + state_a["optimizer"]["nu"],
            state_b["optimizer"]["mu"] + state_b["optimizer"]["nu"],
        )
    )
    print(
        f"decode path resume (2 epochs, then --resume to 3) vs 3 straight epochs: parameters bit-equal "
        f"{same_params}, optimizer moments bit-equal {same_opt}, metrics.jsonl records equal {same_records}",
        flush=True,
    )
    if not (same_params and same_opt and same_records):
        fail("the resumed decode-path run differs from the uninterrupted one")

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run_cli(train_cli.main, train_args(root / "profiled", 4) + ["--resume", str(out_a / "latest_model")])
    events = prof.events()
    epoch_ev = [e for e in events if e.device_type == DeviceType.CPU and e.name == "cdt.epoch"]
    last = recs_a[-1]
    plain_ms = (len(train_ds) / last["train_clips_per_sec"] + len(val_ds) / last["val_clips_per_sec"]) * 1e3
    idle = "not measured"
    if len(epoch_ev) == 1:
        busy = busy_ms(events, epoch_ev[0].time_range.start, epoch_ev[0].time_range.end)
        idle = f"{1 - busy / plain_ms:.3f} (device busy {busy:.3f} ms)"
    deltas = [b["wall_s"] - a["wall_s"] for a, b in zip(recs_a, recs_a[1:])]
    print(
        f"[{smi}] decode path (batch {bs}): host decode {decode_cps:,.0f} clips/s cold (4 threads, one pass over "
        f"{n_dec} clips); one thread, ms a 2 s clip by source rate "
        f"{ {r: round(v, 3) for r, v in decode_ms.items()} }; step {[round(bs / r['train_clips_per_sec'] * 1e3, 4) for r in recs_a]} ms (train "
        f"clips/s {[round(r['train_clips_per_sec'], 1) for r in recs_a]}); epoch wall {[round(d, 3) for d in deltas]} s "
        f"({[round(len(train_ds) / d, 1) for d in deltas]} train clips/s); idle share over one profiled epoch {idle}. "
        f"Shard path (phase 6): step {shard['step_ms_b32']:.4f} ms, epoch wall {[round(d, 3) for d in shard['epoch_wall_s']]} s "
        f"({[round(c, 1) for c in shard['train_clips_per_s']]} train clips/s), idle share {shard['idle_share']}",
        flush=True,
    )

    # -- 7.4 pack the same directory: epoch 0's shard batches are the decoded ones
    run_cli(pack_cli.main, ["--data-dir", str(data), "--output", str(root / "shards"), "--num-workers", "4"])
    shard_loader = ShardLoader(str(root / "shards" / "train"), bs, weighted=True, drop_last=True, seed=SEED,
                               feature_config=shipped)
    decode_loader = BatchLoader(train_ds, bs, shipped, weighted=True, drop_last=True, seed=SEED, num_workers=4)
    worst, n_batches = 0.0, 0
    for (sw, sl), (dw, dl) in zip(shard_loader, decode_loader):
        if not np.array_equal(sl, dl):
            fail("the packed corpus's batch labels differ from the decode path's")
        worst = max(worst, float(np.abs(dequantize(sw) - dw).max()))
        n_batches += 1
    print(
        f"cli.pack: {shard_loader.n_clips} train clips; epoch 0 order and labels equal the decode path's over "
        f"{n_batches} batches; waves max abs {worst:.3e} (limit half an int16 LSB, {0.5 / 32768:.3e})",
        flush=True,
    )
    if n_batches != steps_per_epoch or worst > 0.5 / 32768 + 1e-7:
        fail("the packed corpus's batches differ from the decode path's")

    # -- 7.5 offline scoring of a 10-minute recording
    wave, starts = synth_recording(rng, 600, 40)
    rec = root / "recording.wav"
    audio_io.write_wav(rec, wave, SR)
    wave = audio_io.load_mono_16k(rec)
    model_dir = out_a / "best_model"
    variables, config = _load_checkpoint(str(model_dir))
    n_windows = (len(wave) - SR) // 4000 + 1
    frontend_kernel.SPECTRAL_LAUNCHES = frontend_kernel.EPILOGUE_LAUNCHES = 0
    lines = run_cli(
        detect_cli.main, ["--model", str(model_dir), "--wav", str(rec), "--threshold", "0"], echo=False
    ).splitlines()
    offline_launches = {"spectral": frontend_kernel.SPECTRAL_LAUNCHES, "epilogue": frontend_kernel.EPILOGUE_LAUNCHES}
    n_batches = -(-n_windows // 1024)
    if set(offline_launches.values()) != {n_batches}:
        fail(f"offline scoring launched {offline_launches}, not one of each per 1024-window batch ({n_batches})")
    t0 = time.perf_counter()
    events = offline.score_recording(wave, variables, config, threshold=0.0)
    offline_s = time.perf_counter() - t0
    streamed = StreamingDetector(
        str(model_dir), device="cuda", chunk_size=SR, confidence_threshold=0.0,
    ).process_chunk(wave)
    same_times = [e.time_seconds for e in events] == [d.time_seconds for d in streamed]
    printed = [float(line.split("t=")[1].split("s")[0]) for line in lines if line.startswith("cough at")]
    conf_err = max(abs(e.confidence - d.confidence) for e, d in zip(events, streamed)) if same_times else float("inf")
    probs = offline.window_probs(wave, variables, config)
    cpu_probs = offline.window_probs(wave[: 120 * SR], variables, config, device="cpu")
    prob_err = float(np.abs(probs[: len(cpu_probs)] - cpu_probs).max())
    print(
        f"offline scoring ({n_windows} windows, {n_batches} batches of up to 1024; cli.detect launches "
        f"{offline_launches}): {len(events)} events at threshold 0 (cli.detect printed {len(printed)}); times equal "
        f"StreamingDetector.process_chunk's {same_times}, confidences max abs {conf_err:.3e} (limit 1e-4); window "
        f"probabilities card vs CPU over the first {len(cpu_probs)} windows max abs {prob_err:.3e} (limit 1e-3)",
        flush=True,
    )
    if not (same_times and conf_err <= 1e-4 and prob_err <= TOL and len(printed) == len(events)
            and np.isfinite(probs).all() and len(probs) == n_windows):
        fail("offline scoring disagrees with the streaming detector or the CPU")
    found = offline.score_recording(wave, variables, config, threshold=0.5)
    hit = [any(t0 + 0.9 <= e.time_seconds <= t0 + 2.1 for e in found) for t0 in starts]
    spurious = [e.time_seconds for e in found if not any(t0 + 0.9 <= e.time_seconds <= t0 + 2.1 for t0 in starts)]
    print(
        f"threshold 0.5: {len(found)} detections; {sum(hit)} of the {len(starts)} true coughs found (an event "
        f"within 0.9-2.1 s of a cough's start), {len(spurious)} others",
        flush=True,
    )
    model = model_from_config(config.model)
    model.load_state_dict({k: torch.as_tensor(v) for k, v in variables.items()})
    model = place_model(model, dev)
    batch = offline.frame_windows(torch.from_numpy(wave).to(dev), SR, 4000)[:1024].contiguous()

    def score_batch():
        with torch.no_grad():
            feats = frontend.extract_features_fast(frontend.peak_normalize(batch), config.features, device=dev)
            return torch.softmax(model(feats), dim=-1)[:, 1]

    batch_ms = cuda_ms(score_batch, 10)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        offline.score_recording(wave, variables, config, threshold=0.5)
        torch.cuda.synchronize()
        call_ms = (time.perf_counter() - t0) * 1e3
    busy = busy_ms(prof.events())
    print(
        f"[{smi}] offline scoring: {n_windows / offline_s:,.0f} windows/s over the whole call ({offline_s:.3f} s, "
        f"model load included); one 1024-window batch {batch_ms:.4f} ms by CUDA events ({1024 / batch_ms * 1e3:,.0f} "
        f"windows/s); launches a batch 1 + 1; one call under torch.profiler {call_ms:.3f} ms, device busy "
        f"{busy:.3f} ms, idle share {1 - busy / call_ms:.3f}",
        flush=True,
    )

    # -- 7.6 the front-end kernel at B = 1024, and torch.stft + mel at 1024 and 32
    w = torch.from_numpy(make_audio(rng, 1024, SR)).to(dev)
    pair_err = rel_err(frontend_kernel.extract_features_fused(w, shipped),
                       frontend_kernel.frontend_kernel_reference(w, shipped))
    if not pair_err <= TOL:
        fail(f"the kernel pair disagrees with frontend_kernel_reference at B=1024: {pair_err:.3e}")
    mel = frontend_kernel.power_mel_fused(w, shipped)
    b1024 = {
        "spectral": dict(
            ms=cuda_ms(lambda: frontend_kernel.power_mel_fused(w, shipped), 20),
            device_ms=device_ms(lambda: frontend_kernel.power_mel_fused(w, shipped), 20, "spectral_kernel"),
            plain_ms=cuda_ms(lambda: frontend_kernel.power_mel_reference(w, shipped), 20),
            library_ms=cuda_ms(lambda: yard["library_mel"](w), 20),
            bound=yard["bound_a"](1024),
        ),
        "epilogue": dict(
            ms=cuda_ms(lambda: frontend_kernel.mel_epilogue_fused(mel, shipped), 20),
            device_ms=device_ms(lambda: frontend_kernel.mel_epilogue_fused(mel, shipped), 20, "epilogue_kernel"),
            plain_ms=cuda_ms(lambda: frontend_kernel.mel_epilogue_reference(mel, shipped), 20),
            library_ms=None,
            bound=yard["bound_b"](1024),
        ),
    }
    pair_ms = cuda_ms(lambda: frontend_kernel.extract_features_fused(w, shipped), 20)
    w32 = w[:32].contiguous()
    lib32 = cuda_ms(lambda: yard["library_mel"](w32), 50)
    for part, tm in b1024.items():
        print(
            f"[{smi}] {part} launch at B=1024: kernel {tm['ms']:.4f} ms (device {tm['device_ms']:.4f}), plain "
            f"{tm['plain_ms']:.4f} ms, library {'none' if tm['library_ms'] is None else format(tm['library_ms'], '.4f')}"
            f"; bound {tm['bound']['bound_ms']:.4f} ms by {tm['bound']['bound_by']} (device time at "
            f"{100 * tm['bound']['bound_ms'] / tm['device_ms']:.1f}% of it); bound at B=32 "
            f"{(yard['bound_a'] if part == 'spectral' else yard['bound_b'])(32)['bound_ms']:.4f} ms",
            flush=True,
        )
    print(
        f"[{smi}] kernel pair at B=1024: {pair_ms:.4f} ms, vs frontend_kernel_reference max-relative "
        f"{pair_err:.3e}; torch.stft + mel matmul {b1024['spectral']['library_ms']:.4f} ms at B=1024, "
        f"{lib32:.4f} ms at B=32",
        flush=True,
    )

    # -- 7.7 featurize the data directory at batch 512
    frontend_kernel.SPECTRAL_LAUNCHES = frontend_kernel.EPILOGUE_LAUNCHES = 0
    report = json.loads(run_cli(featurize_cli.main, [
        "--data-dir", str(data), "--output", str(root / "features.npz"), "--batch-size", "512", "--num-workers", "8",
    ]).strip().splitlines()[-1])
    feat_launches = {"spectral": frontend_kernel.SPECTRAL_LAUNCHES, "epilogue": frontend_kernel.EPILOGUE_LAUNCHES}
    feats = np.load(root / "features.npz")["features"][:16]
    first, _ = next(iter(BatchLoader(CoughDataset(str(data)), 16, shipped, num_workers=4)))
    want = frontend.extract_features(frontend.peak_normalize(torch.from_numpy(first)), shipped)
    feat_err = rel_err(torch.from_numpy(feats), want)
    n_feat_batches = -(-len(wavs) // 512)
    print(
        f"[{smi}] cli.featurize: {report['clips']} clips at batch 512, {report['clips_per_sec']} clips/s "
        f"(steady {report['steady_clips_per_sec']}); launches {feat_launches} for {n_feat_batches} batches; 16 "
        f"clips' features vs the CPU torch chain max-relative {feat_err:.3e} (limit 1e-3)",
        flush=True,
    )
    if not (feat_err <= TOL and set(feat_launches.values()) == {n_feat_batches}):
        fail("featurize disagrees with the CPU chain or missed its launches")

    # -- 7.8 the trained model served by the facade
    facade = CoughDetectorInference(str(out_a / "best_model.pt"), verbose=False)
    facade.confidence_threshold = 0.0
    hits = [facade.process_audio_chunk(wave[lo : lo + 1600]) for lo in range(0, 20 * SR, 1600)]
    hits = [h for h in hits if h is not None]
    early = [e for e in events if e.time_seconds <= 20.0]
    first_window = frontend.peak_normalize(torch.from_numpy(wave[None, :SR]).to(dev))
    p_cough = facade.predict(frontend.extract_features_fast(first_window, shipped, device=dev).cpu().numpy())[1]
    print(
        f"CoughDetectorInference(best_model.pt) on the card: {len(hits)} detections over the first 20 s at "
        f"threshold 0 (offline scoring: {len(early)}), predict on the first window {p_cough:.4f} "
        f"(offline {probs[0]:.4f})",
        flush=True,
    )
    if len(hits) != len(early) or not abs(p_cough - probs[0]) <= 1e-4:
        fail("the facade does not serve the trained model as offline scoring does")
    print(f"files-to-detections phase: {time.perf_counter() - t_phase:.3f} s", flush=True)
    return {
        "offline_launches": offline_launches, "offline_batch_ms": batch_ms, "decode_training_launches": train_launches,
        "b1024": b1024,
    }


def main() -> None:
    # -- 1. the card ---------------------------------------------------------
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke run needs a CUDA card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")

    from cough_detector_tpu_torch.config import FeatureConfig, default_config
    from cough_detector_tpu_torch.models import count_parameters, create_model
    from cough_detector_tpu_torch.ops import filters, frontend, frontend_kernel
    from cough_detector_tpu_torch.serve import DetectionClient, DetectionServer
    from cough_detector_tpu_torch.stream import StreamingDetector
    from cough_detector_tpu_torch.utils import kernel_build

    # -- 2. build ----------------------------------------------------------------
    t0 = time.perf_counter()
    frontend_kernel.build()
    print(
        f"build: {kernel_build.library_path('frontend_kernel').name} in "
        f"{time.perf_counter() - t0:.3f} s",
        flush=True,
    )

    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED)
    shipped = FeatureConfig()

    def waves(b: int) -> torch.Tensor:
        return torch.from_numpy(make_audio(rng, b, shipped.segment_samples)).to(dev)

    # -- 3. kernels vs plain versions --------------------------------------
    # Each launch on its own against its plain version on the same input
    # (launch B is fed the plain power mel), then the pair end to end.
    def sweep_batch(b: int) -> torch.Tensor:
        """Every other clip a sine sweep, in band at f_max = 8 kHz."""
        w = make_audio(rng, b, shipped.segment_samples)
        w[::2] = make_sweeps(rng, len(w[::2]), shipped.segment_samples)
        return torch.from_numpy(w).to(dev)

    full_band = FeatureConfig(f_max=8000.0)
    n_fft_256 = FeatureConfig(n_fft=256, win_length=200, hop_length=80)
    widest = FeatureConfig(
        n_mels=128, f_max=8000.0, n_fft=256, win_length=200, hop_length=80, n_mfcc=20,
        use_pcen=True, use_delta_delta=True,
    )
    checks = [
        ("shipped", shipped, waves(1)), ("shipped", shipped, waves(17)),
        ("shipped", shipped, waves(256)),
        ("pcen", FeatureConfig(use_pcen=True), waves(17)),
        ("pre_emphasis+delta_delta", FeatureConfig(use_pre_emphasis=True, use_delta_delta=True), waves(17)),
        ("n_mels=32", FeatureConfig(n_mels=32, n_mfcc=8), waves(17)),
        ("n_fft=256", n_fft_256, waves(17)),
        ("n_fft=256 n_mfcc=20", FeatureConfig(n_fft=256, win_length=200, hop_length=80, n_mfcc=20), waves(17)),
        ("f_max=8000", full_band, waves(17)),
        ("n_mels=128 f_max=8000", FeatureConfig(n_mels=128, f_max=8000.0), waves(17)),
        ("n_mels=128 n_fft=256 n_mfcc=20 pcen+delta_delta", widest, waves(17)),
        # 36 MFCCs: two DCT passes, and tiles after the mel tile (2C > M).
        ("n_mels=40 n_mfcc=36 delta_delta", FeatureConfig(n_mels=40, n_mfcc=36, use_delta_delta=True), waves(17)),
        ("f_max=8000 sweeps", full_band, sweep_batch(17)),
    ]
    max_abs = {"spectral": 0.0, "epilogue": 0.0}
    split_err = 0.0
    lib = frontend_kernel.build()
    for name, cfg, w in checks:
        b = w.shape[0]
        kpad = frontend_kernel._constants(cfg, dev).kpad
        smem = {
            "spectral": (lib.cdt_frontend_smem_a(cfg.hop_length, kpad),
                         frontend_kernel.spectral_smem_bytes(cfg.hop_length, kpad)),
            "epilogue": (lib.cdt_frontend_smem_b(cfg.num_frames, cfg.n_mels, cfg.n_mfcc, int(cfg.use_delta_delta)),
                         frontend_kernel.epilogue_smem_bytes(cfg)),
        }
        print(f"shared memory a block [{name}] (kernel, Python mirror): {smem}", flush=True)
        if any(c != py for c, py in smem.values()) or not frontend_kernel.card_supports(cfg, cfg.segment_samples):
            fail(f"the card route's mirror of the kernels' shared memory disagrees on {name}: {smem}")
        mel_want = frontend_kernel.power_mel_reference(w, cfg)
        feat_want = frontend_kernel.mel_epilogue_reference(mel_want, cfg)
        pairs = {
            "spectral": (frontend_kernel.power_mel_fused(w, cfg), mel_want),
            "epilogue": (frontend_kernel.mel_epilogue_fused(mel_want.contiguous(), cfg), feat_want),
            "pair": (frontend_kernel.extract_features_fused(w, cfg), feat_want),
        }
        torch.cuda.synchronize()
        for part, (got, want) in pairs.items():
            err = rel_err(got, want)
            if part in max_abs:
                max_abs[part] = max(max_abs[part], (got - want).abs().max().item())
            ok = got.shape == want.shape and bool(torch.isfinite(got).all())
            print(
                f"kernel vs plain [{part}, {name}, B={b}]: max-relative {err:.3e} "
                f"shape {tuple(got.shape)}",
                flush=True,
            )
            if not ok or not err <= TOL:
                fail(f"{part} kernel disagrees with its plain version on {name} B={b}: {err:.3e}")
        err = rel_err(pairs["spectral"][0], frontend_kernel.power_mel_split_reference(w, cfg))
        split_err = max(split_err, err)
        one_pass = frontend_kernel.mel_epilogue_reference(
            frontend_kernel.power_mel_split_reference(w, cfg, passes=1), cfg
        )
        print(
            f"spectral kernel vs its 3xTF32 model [{name}, B={b}]: max-relative {err:.3e}; "
            f"features of one TF32 pass (model) vs plain: {rel_err(one_pass, feat_want):.3e}",
            flush=True,
        )
        if not err <= TOL:
            fail(f"spectral kernel disagrees with its 3xTF32 model on {name} B={b}: {err:.3e}")
        if pairs["pair"][0].shape != (b, cfg.num_features, cfg.num_frames):
            fail(f"feature image of shape {tuple(pairs['pair'][0].shape)} on {name}")

    # More mels than the spectral launch takes: the card route runs the
    # torch chain, launches nothing, and raises nothing.
    wide = FeatureConfig(n_mels=160, f_max=8000.0)
    w = waves(17)
    before = (frontend_kernel.SPECTRAL_LAUNCHES, frontend_kernel.EPILOGUE_LAUNCHES)
    got = frontend.extract_features_fast(w, wide)
    err = rel_err(got, frontend.extract_features(w, wide))
    after = (frontend_kernel.SPECTRAL_LAUNCHES, frontend_kernel.EPILOGUE_LAUNCHES)
    print(f"card route [n_mels=160]: torch chain, max-relative {err:.3e}, launches {before} -> {after}", flush=True)
    if after != before or not err <= TOL or frontend_kernel.card_supports(wide, wide.segment_samples):
        fail("a 160-mel config did not run the torch chain on the card")

    # -- 4. times ----------------------------------------------------------------
    fb_full = torch.from_numpy(
        filters.mel_filterbank(
            shipped.n_fft // 2 + 1, shipped.n_mels, shipped.sample_rate, shipped.f_min, shipped.f_max
        )
    ).to(dev)
    window = torch.hann_window(shipped.win_length, device=dev)

    def library_mel(w: torch.Tensor) -> torch.Tensor:
        """cuFFT power spectrum and a mel matmul, (B, T, n_mels)."""
        spec = torch.stft(
            w, shipped.n_fft, shipped.hop_length, shipped.win_length, window,
            center=True, pad_mode="reflect", return_complex=True,
        )
        return (spec.real**2 + spec.imag**2).transpose(1, 2) @ fb_full

    def library(w: torch.Tensor) -> torch.Tensor:
        return frontend.stack_features(library_mel(w), shipped)

    consts = frontend_kernel._constants(shipped, dev)
    t_frames, n_mels = shipped.num_frames, shipped.n_mels
    taps, n_used = consts.j1 - consts.j0, consts.n_used
    # Operations each launch needs for one clip. A: the windowed DFT over the
    # window's nonzero taps (a multiply-add each for re and im), the power
    # (3 a bin) and the mel matmul. B (epilogue_work): the DCT matmul, plus
    # about 8 elementwise operations per log-mel value (log, scale, max, dB
    # clamp and scale) and 10 per MFCC value (z-norm sums and scale, deltas).
    flops_a = 4 * t_frames * taps * n_used + 3 * t_frames * n_used + 2 * t_frames * n_used * n_mels
    table_a = 4 * sum(c.numel() for c in (consts.cos, consts.sin, consts.fb))

    def bound(flops: float, nbytes: float, peak: float = PEAK_FP32_FLOPS) -> dict:
        t_ops, t_bytes = flops / peak, nbytes / PEAK_HBM_BYTES
        return dict(
            bound_ms=max(t_ops, t_bytes) * 1e3,
            bound_by="operations" if t_ops >= t_bytes else "bytes",
        )

    def epilogue_work(cfg: FeatureConfig, b: int) -> tuple:
        """Launch B's operations and bytes for b clips: the power mel read
        once, the features written once, the DCT table read once."""
        t, m, c = cfg.num_frames, cfg.n_mels, cfg.n_mfcc
        flops = b * (2 * t * m * c + 8 * m * t + 10 * c * t)
        return flops, 4 * b * (m + cfg.num_features) * t + 4 * m * c

    def bound_a(b: int) -> dict:
        """The spectral launch's bound for b clips: the waveform read and
        the power mel written once, the tables read once, its operations
        at the TF32 tensor-core peak."""
        return bound(b * flops_a, 4 * b * (shipped.segment_samples + n_mels * t_frames) + table_a, PEAK_TF32_FLOPS)

    yard = dict(library_mel=library_mel, bound_a=bound_a, bound_b=lambda b: bound(*epilogue_work(shipped, b)))

    timing = {}
    for b, iters in ((256, 50), (4096, 10)):
        w = waves(b)
        mel = frontend_kernel.power_mel_fused(w, shipped)
        mel_err = rel_err(mel, frontend_kernel.power_mel_reference(w, shipped))
        if not mel_err <= TOL:
            fail(f"spectral kernel disagrees with its plain version at B={b}: {mel_err:.3e}")
        lib_err = rel_err(library(w), frontend_kernel.extract_features_fused(w, shipped))
        bytes_a = 4 * b * (shipped.segment_samples + n_mels * t_frames) + table_a
        spectral = dict(
            ms=cuda_ms(lambda: frontend_kernel.power_mel_fused(w, shipped), iters),
            plain_ms=cuda_ms(lambda: frontend_kernel.power_mel_reference(w, shipped), iters),
            library_ms=cuda_ms(lambda: library_mel(w), iters),
            precision="3xTF32",
            **bound(b * flops_a, bytes_a, PEAK_TF32_FLOPS),
            bound_fp32_ms=bound(b * flops_a, bytes_a)["bound_ms"],
        )
        epilogue = dict(
            ms=cuda_ms(lambda: frontend_kernel.mel_epilogue_fused(mel, shipped), iters),
            plain_ms=cuda_ms(lambda: frontend_kernel.mel_epilogue_reference(mel, shipped), iters),
            library_ms=None,
            **bound(*epilogue_work(shipped, b)),
        )
        pair = dict(
            ms=cuda_ms(lambda: frontend_kernel.extract_features_fused(w, shipped), iters),
            plain_ms=cuda_ms(lambda: frontend_kernel.frontend_kernel_reference(w, shipped), iters),
            library_ms=cuda_ms(lambda: library(w), iters),
        )
        if b == 256:  # the card's own time, beside the events' host-bound one
            spectral["device_ms"] = device_ms(lambda: frontend_kernel.power_mel_fused(w, shipped), iters, "spectral_kernel")
            epilogue["device_ms"] = device_ms(lambda: frontend_kernel.mel_epilogue_fused(mel, shipped), iters, "epilogue_kernel")
        timing[b] = dict(spectral=spectral, epilogue=epilogue)
        print(f"spectral kernel vs plain at B={b}: max-relative {mel_err:.3e}", flush=True)
        for part, tm in (("spectral", spectral), ("epilogue", epilogue)):
            lib_ms = "none" if tm["library_ms"] is None else f"{tm['library_ms']:.4f} ms"
            fp32 = (
                f"; FP32 CUDA-core bound {tm['bound_fp32_ms']:.4f} ms "
                f"({100 * tm['bound_fp32_ms'] / tm['ms']:.1f}%)"
                if "bound_fp32_ms" in tm else ""
            )
            dev_ms = (
                f"; device time (profiler) {tm['device_ms']:.4f} ms, "
                f"{100 * tm['bound_ms'] / tm['device_ms']:.1f}% of bound"
                if "device_ms" in tm else ""
            )
            print(
                f"times {part} B={b}: kernel {tm['ms']:.4f} ms, plain {tm['plain_ms']:.4f} ms, "
                f"library {lib_ms}; bound {tm['bound_ms']:.4f} ms by {tm['bound_by']}; "
                f"kernel at {100 * tm['bound_ms'] / tm['ms']:.1f}% of bound{fp32}{dev_ms}",
                flush=True,
            )
        print(
            f"times pair B={b}: kernels {pair['ms']:.4f} ms, plain {pair['plain_ms']:.4f} ms, "
            f"library {pair['library_ms']:.4f} ms (torch.stft + matmuls + torch epilogue; "
            f"vs kernels max-relative {lib_err:.2e}); operations {b * flops_a / 1e9:.3f} "
            f"GFLOP spectral at {PEAK_TF32_FLOPS / 1e12:.0f} TFLOP/s TF32 (FP32 "
            f"{PEAK_FP32_FLOPS / 1e12:.0f}), {epilogue_work(shipped, b)[0] / 1e9:.3f} GFLOP epilogue, bytes at "
            f"{PEAK_HBM_BYTES / 1e12:.2f} TB/s",
            flush=True,
        )

    # The epilogue launch on the other layouts it takes, at B = 4096.
    for name, cfg in (("n_fft=256", n_fft_256), ("pcen", FeatureConfig(use_pcen=True))):
        w = waves(4096)
        mel = frontend_kernel.power_mel_fused(w, cfg)
        tm = dict(
            ms=cuda_ms(lambda: frontend_kernel.mel_epilogue_fused(mel, cfg), 10),
            plain_ms=cuda_ms(lambda: frontend_kernel.mel_epilogue_reference(mel, cfg), 10),
            **bound(*epilogue_work(cfg, 4096)),
        )
        print(
            f"times epilogue B=4096 [{name}]: kernel {tm['ms']:.4f} ms, plain {tm['plain_ms']:.4f} ms; "
            f"bound {tm['bound_ms']:.4f} ms by {tm['bound_by']}; kernel at "
            f"{100 * tm['bound_ms'] / tm['ms']:.1f}% of bound",
            flush=True,
        )

    # -- 5. the serving path -----------------------------------------------------
    cfg = default_config("residual")
    gen = torch.Generator().manual_seed(SEED)
    torch.manual_seed(SEED)
    model = create_model("residual")
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.normal_(0.0, 0.5, generator=gen)
                m.running_var.uniform_(0.5, 2.0, generator=gen)
                m.weight.normal_(1.0, 0.2, generator=gen)
                m.bias.normal_(0.0, 0.2, generator=gen)
    n_params = count_parameters(model)
    if n_params != 290370:
        fail(f"residual model has {n_params} parameters, expected 290370")
    weights = model.state_dict()
    n_streams, n_samples = 8, int(1.25 * SR)
    audio = make_audio(rng, n_streams, n_samples)

    server = DetectionServer(
        variables=weights, config=cfg, device="cuda", num_streams=n_streams,
        chunk_size=CHUNK, confidence_threshold=0.0, tick_policy="eager",
        liveness_seconds=float("inf"),
    )
    print(
        f"tf32: cudnn.allow_tf32={torch.backends.cudnn.allow_tf32} "
        f"cuda.matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32}",
        flush=True,
    )
    if torch.backends.cudnn.allow_tf32 or torch.backends.cuda.matmul.allow_tf32:
        fail("TF32 is on for the model on the card")
    n_ticks = n_samples // CHUNK
    server.start()
    try:
        frontend_kernel.SPECTRAL_LAUNCHES = frontend_kernel.EPILOGUE_LAUNCHES = 0
        with DetectionClient(*server.address) as client:
            sids = [client.open_stream() for _ in range(n_streams)]
            for t in range(n_ticks + 1):
                for s, sid in enumerate(sids):
                    client.send_audio(sid, audio[s, t * CHUNK : (t + 1) * CHUNK])
            deadline = time.time() + 120
            while server.stats()["ticks"] < n_ticks and time.time() < deadline:
                time.sleep(0.01)
            got = []
            while len(got) < n_streams and time.time() < deadline:
                got += client.events(timeout=0.5)
            time.sleep(0.2)
            got += client.events()
        launches = {
            "spectral": frontend_kernel.SPECTRAL_LAUNCHES,
            "epilogue": frontend_kernel.EPILOGUE_LAUNCHES,
        }
        stats = server.stats()
    finally:
        server.stop()
    print(
        f"server: {stats['ticks']} ticks, {len(got)} events over loopback, "
        f"kernel launches while serving {launches}, tick_ms_p50 {stats.get('tick_ms_p50')}",
        flush=True,
    )
    if stats["ticks"] < n_ticks or min(launches.values()) < 1:
        fail("the server did not tick through both front-end kernels")

    ref = StreamingDetector(
        variables=weights, config=cfg, device="cuda", num_streams=n_streams,
        chunk_size=CHUNK, confidence_threshold=0.0,
    )
    expected = ref.process_chunk(audio[:, : n_ticks * CHUNK])
    lane = {sid: s for s, sid in enumerate(sids)}
    got_set = sorted((lane[e["stream"]], round(e["time"], 6), e["confidence"]) for e in got)
    want_set = sorted((d.stream, round(d.time_seconds, 6), d.confidence) for d in expected)
    same = len(got_set) == len(want_set) == n_streams and all(
        g[:2] == w[:2] and abs(g[2] - w[2]) <= 2e-6 for g, w in zip(got_set, want_set)
    )
    print(f"server events == in-process detector events: {same} ({len(want_set)} events)", flush=True)
    if not same:
        fail(f"server events {got_set} differ from the detector's {want_set}")

    windows = audio[:, :SR]
    card_p = ref.scores_for(windows)
    cpu_det = StreamingDetector(variables=weights, config=cfg, device="cpu", num_streams=1)
    cpu_p = cpu_det.scores_for(windows)
    p_err = float(np.abs(card_p - cpu_p).max())
    print(f"card vs CPU cough probabilities on {len(windows)} windows: max abs {p_err:.3e}", flush=True)
    if not (np.isfinite(card_p).all() and p_err <= TOL):
        fail(f"card probabilities disagree with the CPU's: {p_err:.3e}")

    det = StreamingDetector(
        variables=weights, config=cfg, device="cuda", num_streams=256,
        chunk_size=CHUNK, confidence_threshold=0.5,
    )
    n_span = 20  # ticks in each of the two spans below
    ticks_audio = make_audio(rng, 256, (60 + 2 * n_span) * CHUNK)

    def tick(t: int) -> None:
        det.collect_events(det.tick_async(ticks_audio[:, t * CHUNK : (t + 1) * CHUNK]))

    lat_all, lat_scoring = [], []
    for t in range(60):
        w0 = det._state.windows_emitted
        t_start = time.perf_counter()
        tick(t)
        dt = time.perf_counter() - t_start
        if t >= 20:
            lat_all.append(dt)
            if det._state.windows_emitted > w0:
                lat_scoring.append(dt)
    print(
        f"256 streams x {CHUNK}-sample ticks: p50 {np.percentile(lat_all, 50) * 1e3:.3f} ms over "
        f"{len(lat_all)} ticks; p50 {np.percentile(lat_scoring, 50) * 1e3:.3f} ms over the "
        f"{len(lat_scoring)} ticks that score 256 windows (host clock, tick + event fetch)",
        flush=True,
    )

    # Device idle share. First the host-clock span of n_span ticks back to
    # back without the profiler (ending in a synchronize), then n_span more
    # under torch.profiler: the union of every device kernel's and copy's
    # interval is the busy time. Only the device-side events count; a CPU
    # op's device time repeats its kernels'. Both spans hold the same number
    # of scoring ticks (a window completes every 2.5 ticks). The busy time
    # over the plain span is the idle share without the profiler's host
    # overhead; over the profiled span, with it.
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def span(first: int) -> tuple:
        w0 = det._state.windows_emitted
        torch.cuda.synchronize()
        t_start = time.perf_counter()
        for t in range(first, first + n_span):
            tick(t)
        torch.cuda.synchronize()
        return (time.perf_counter() - t_start) * 1e3, det._state.windows_emitted - w0

    plain_span_ms, plain_windows = span(60)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        prof_span_ms, prof_windows = span(60 + n_span)
    spans, by_name = [], {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            spans.append((e.time_range.start, e.time_range.end))
            by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    busy_us, reach = 0.0, float("-inf")
    for start, end in sorted(spans):
        busy_us += max(0.0, end - max(start, reach))
        reach = max(reach, end)
    if busy_us > 0:
        busy_ms = busy_us / 1e3
        top = ", ".join(
            f"{name[:48]} {us / 1e3 / n_span:.4f}"
            for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
        )
        ours = ", ".join(
            f"{name} {sum(us for n, us in by_name.items() if name in n) / 1e3 / n_span:.4f}"
            for name in ("spectral_kernel", "epilogue_kernel")
        )
        print(
            f"{n_span} ticks: {plain_span_ms:.3f} ms on the host clock without the profiler "
            f"(windows {plain_windows}), {prof_span_ms:.3f} ms under it (windows {prof_windows}); "
            f"device busy {busy_ms:.3f} ms under the profiler ({len(spans)} device ops); "
            f"idle share {1 - busy_ms / plain_span_ms:.3f} against the plain span, "
            f"{1 - busy_ms / prof_span_ms:.3f} against the profiled span",
            flush=True,
        )
        print(f"device ms a tick: front-end kernels {ours}; top device ops {top}", flush=True)
    else:
        print(
            f"{n_span} ticks: {plain_span_ms:.3f} ms on the host clock; the profiler recorded "
            f"no device time, idle share not measured",
            flush=True,
        )
    w256 = waves(256)
    feats256 = frontend_kernel.extract_features_fused(w256, shipped)
    with torch.no_grad():
        clf_ms = cuda_ms(lambda: det._model(feats256), 20)
        score_ms = cuda_ms(lambda: det._score_fn(w256), 20)
    print(
        f"256 windows on the card (CUDA events): classifier {clf_ms:.4f} ms, score function "
        f"(peak normalize + front-end kernels + classifier + softmax) {score_ms:.4f} ms",
        flush=True,
    )

    # -- 6. the training path -------------------------------------------------------
    trained = train_phase(smi)

    # -- 7. files to detections ----------------------------------------------------------
    files = files_phase(smi, trained["shard"], yard)

    # -- 8. summary ----------------------------------------------------------------
    main_b = 256
    kernels = [
        {
            "name": f"frontend_{part}",
            "route": "cuda",
            "source": "cough_detector_tpu_torch/csrc/frontend_kernel.cu",
            "replaces": "cough_detector_tpu/ops/pallas/frontend_kernel.py:278",
            "launches": launches[part],
            "training_launches": trained["launches"][part],
            "max_abs_err": max_abs[part],
            "batch": main_b,
            **timing[main_b][part],
            "training_batch_ms": trained["ms_b32"][part],
            "training_batch_device_ms": trained["device_ms_b32"][part],
            "decode_training_launches": files["decode_training_launches"][part],
            "offline_launches": files["offline_launches"][part],
            "offline_batch": 1024,
            "offline_batch_ms": files["b1024"][part]["ms"],
            "offline_batch_device_ms": files["b1024"][part]["device_ms"],
            "offline_batch_bound_ms": files["b1024"][part]["bound"]["bound_ms"],
        }
        for part in ("spectral", "epilogue")
    ]
    kernels[0]["max_rel_vs_3xtf32_model"] = split_err
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }))


if __name__ == "__main__":
    main()
