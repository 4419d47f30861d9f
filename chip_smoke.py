"""Smoke run of the PyTorch port's serving path on one NVIDIA card.

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
  7. prints the kernels' JSON line, then the device line last.

Imports only torch, numpy, scipy (data/synth.py) and the port package;
never JAX.
"""

from __future__ import annotations

import os

# The training phase asks for deterministic algorithms; torch then wants
# cuBLAS's workspace fixed, which it reads before the first cuBLAS call.
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

import copy  # noqa: E402
import itertools  # noqa: E402
import json  # noqa: E402
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
        feature_fn, _ = make_feature_fns(step_cfg, d)
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
    feature_fn, _ = make_feature_fns(cfg, dev)
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
    if len(epoch_ev) == 1:
        lo, hi = epoch_ev[0].time_range.start, epoch_ev[0].time_range.end
        busy = busy_ms(events, lo, hi)
        span = (hi - lo) / 1e3
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
    return {"launches": launches, "ms_b32": launch_ms, "device_ms_b32": launch_dev}


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

    # -- 7. summary ----------------------------------------------------------------
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
