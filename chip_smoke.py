"""Smoke run of the PyTorch port on one NVIDIA card: serving, training, files
to detections, the serving daemon with the native tiers, the tools between
training and serving, training and scoring across ranks and devices, the
captured programs (CUDA graphs) of the tick and the train step, the
pipelined epochs and the scoring programs, the port's bench, and training
over a mesh from one call.

    python3 chip_smoke.py

Phases, each printing its own lines; any failure raises and exits non-zero:
  1. a CUDA card is required; prints its name and power limit (nvidia-smi);
  2. builds the front-end kernel from csrc/ with nvcc, and with g++ the two
     C++ libraries from native/ (the decode tier and the daemon's socket
     plane) and the bench's load generator, all four at once (build
     seconds), and beside them the host work of later phases (phase 6's
     corpus, phase 7's resample banks and its data directory, the last in
     a process of its own, phase 3's DFT tables, and one profiler session,
     whose start the first device time of phase 4 would pay); the phases'
     seconds are printed at the end;
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
     shared memory is held against its Python mirror. The
     contrast launch (the launcher's contrast rows) is held against its
     plain version (the gemm rows, 1e-3) and its 3xTF32 model
     (spectral_contrast_split_reference, 1e-4: one TF32 pass would miss
     it), with one TF32 pass's model printed beside, on the shipped config with
     contrast at B = 1, 17, 256, 1024, every flag (pre-emphasis must not
     reach the rows), n_fft 256 and 1024, 4 and 8 bands, and a batch of
     sine sweeps, a silent clip, a half-silent clip and a click train
     (ties); its shared memory against its mirror. Then every config the
     JAX launcher sends to its Pallas kernel that the card once ran on the
     torch chain (budget 15 s; coverage_configs: 160 and 256 mels, n_fft
     2048 at 16 and 22.05 kHz, 5 and 10 s clips, a hop of 4, n_fft 1024
     and 2048 with contrast, 17 bands; each at B = 17 and 256; and at
     B = 17 a 60 s clip with every flag, contrast at a hop of 4, at n_fft
     4096, 2000 and 3000 (the FFT plans' radix-3 and radix-5 stages), 256
     mels at n_fft 768, n_fft 1792 and 2744 with contrast and 896 at 256
     mels (radix-7 stages), 44.1 kHz at n_fft 1764 with contrast and at
     882 (40 and 20 ms windows, a 10 ms hop; 441 points a frame of launch
     A, odd), n_fft 1760 and 2662 with contrast and 880 at 256 mels
     (radix-11 stages), an odd n_fft (launch A two frames a row): 44.1 kHz
     at 1323 with and without contrast and at 2205 with contrast (30 and
     50 ms windows), n_fft 1125 (57 frames, a lone last one), a prime
     factor of 13 (the FFT plans' generic prime stage) at n_fft 1664 and
     2704 with contrast, 832 at 256 mels and the odd 1365 at 44.1 kHz, a
     prime factor past the generic stage's cap (the FFT plans' Bluestein
     stage) at n_fft 2096 and 2192 with contrast, 2192 and 1048 at 256
     mels and the odd 1965 at 44.1 kHz, the contrast launch's bands past
     512 bins (block_tails) at n_fft 5296 and 6144, 4608 with 8 bands and
     8192 at 44.1 kHz, Bluestein's rows over two and four warps (n_fft
     6544 and the prime 1987 with contrast), the GEMM plans' spans from device
     memory, contrast levels 1 and 3 and mel groups where the FFT plans do
     not fit (a 25 ms hop with contrast; the prime n_fft 2129 at 256 mels
     with contrast), and 10 s clips with PCEN, delta-deltas and 20 MFCCs and with 36 MFCCs of 40 mels
     (launch B's cluster route's other branches), 120 s at 128 mels (launch
     B in device memory), for the plans no other config reaches) through
     extract_features_fast: every launch it needs once a call (the FFT
     plans' kernels counted on their own too), the
     features within 1e-3 of the plain versions and of the torch chain,
     each launch alone within 1e-3 of its plain version and of the CPU
     model of its plan (FFT_TOL for the FFT plans' models, SPLIT_TOL for
     the 3xTF32 models), each launch's shared memory and plan (the FFT or
     the GEMM's span staged or not, blocks a clip, LayoutC's level or the
     FFT) equal to its Python mirror; and the main path on 160 mels, 10 s
     clips, n_fft 2048, n_fft 2048 with contrast, 44.1 kHz at n_fft 1764
     with contrast (radix-7 stages in both FFT plans), at the odd 1323
     with contrast (launch A's two frames a row, launch C's odd FFT),
     n_fft 2704 with contrast (two radix-13 stages in both FFT plans) and
     2192 with contrast (Bluestein's stage in both),
     features into the
     residual model through a captured graphs.Programs program (one eager
     call, two replays, launches counted through them, logits within 1e-3
     of eager);
  4. times each launch and the pair, their plain versions and library
     yardsticks (torch.stft + matmuls, + the torch epilogue for the pair)
     with CUDA events at B = 256 and 4096, beside each launch's bound (the
     function's least work: for the spectral launch an FFT a frame at the
     FP32 CUDA-core peak, or its bytes at the memory rate; its GEMM
     design's ceiling, the DFT as a GEMM at the TF32 peak, beside it); at
     B = 256 also each launch's device time from torch.profiler
     (back-to-back calls of a launch this short time the host's
     dispatch); the spectral and epilogue launches at B = 1024 on 256
     mels and n_fft 1024 (both of launch A's plans), n_fft 2048 at 16 and
     22.05 kHz, 10 s clips (the GEMM), n_fft 2000, 3000 and 256 mels at
     n_fft 768 (the FFT's radix-3 and radix-5 stages), 896 at 256 mels,
     1792, 2744 and 44.1 kHz at 1764 and 882 (radix 7), 880 at 256 mels
     (radix 11) and 44.1 kHz at the odd 1323, 832 at 256 mels and 44.1 kHz
     at the odd 1365 (a radix-13 stage), 2192 and 1048 at 256 mels and
     44.1 kHz at the odd 1965 on 256 mels, 5296 and 6544 (Bluestein's stage), the
     contrast launch on n_fft 1024 (both plans), 2048, 4096, 2000, 3000,
     1792, 2744, 1760 and 2662, 44.1 kHz at 1764, 1323 and 2205, 1664 and
     2704 (radix 13), 2192 and 2096 (Bluestein's stage; the FFT), and
     5296, 6144, 4608 with 8 bands and 8192 at 44.1 kHz (bands past 512
     bins by block_tails) and 6544 (Bluestein's stage), each beside
     its bound, its plain version and torch.stft + mel (the fft rows for
     contrast); the epilogue launch alone on its cluster route (5 s at 128
     mels, 10 s with PCEN, delta-deltas and 20 MFCCs at B = 1024, a hop of
     4 at B = 256, 60 s at 128 mels with every flag at B = 64) and in
     device memory (120 s at 128 mels, B = 32), beside its bound and plain
     version; the epilogue launch
     at B = 4096 at n_fft 256 and with PCEN, beside its bound; the contrast
     launch at B = 32, 256, 1024 and 4096 (device time at 256 and 1024),
     held to its plain version (1e-3) at each, beside its bound (an FFT of
     each window at the FP32 CUDA-core peak, the tails as selections), its
     GEMM design's own ceiling, the ceiling of the 3xTF32 products its
     GEMM plan issues, its plain version, the fft rows, the pair, the
     hybrid of all three launches and the torch chain with contrast;
  5. serves: a DetectionServer on the card (the native socket plane,
     residual model at full width, random weights from a seed, eager
     ticks, 8 slots, threshold 0) answers
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
     from the directory through cli.train --data-dir on the Python decoder
     (--decode-backend python) for 3 epochs, then 2
     and a resume to 3 (bit-equal parameters, moments and metrics.jsonl;
     both launch counters one per train and eval step), with host decode
     clips/s, step ms, epoch wall and a profiled epoch's idle share beside
     phase 6's shard numbers; packs the directory with cli.pack (epoch 0's
     shard batches in the decode path's order and labels, waves within
     half an int16 LSB of the C++ decoder's, which pack's "auto" takes); scores a 10-minute recording with 40 coughs
     through cli.detect --wav (events at threshold 0 equal the streaming
     detector's, times exact, confidences 1e-4; probabilities within 1e-3
     of the CPU's; one launch of each kernel per 1024-window batch;
     detections at 0.5 against the true times; windows/s, batch ms, idle
     share); holds and times the kernel pair at B = 1024 and times
     torch.stft + mel at 1024 and 32; featurizes the directory with
     cli.featurize at batch 512 (16 clips within 1e-3 of the CPU chain);
     serves the trained `.pt` through CoughDetectorInference;
  8. the serving daemon and the native tiers: decodes phase 7's train clips
     cold through the C++ loader (4 and 8 threads) and the Python decoder
     (clips/s; every row within 2e-5) and trains one decode-path epoch on
     the native tier under torch.profiler (step ms, idle share); serves 16
     streams from phase 6's trained model on a DetectionServer for each tick
     format (float32, int16, μ-law), on the native plane, the python tier
     and the native plane with 4 ingest workers: events equal the
     in-process detector's fed the host quantizer's output (times exact,
     confidences 1e-4) and each other's, and both launch counters equal the
     ticks that complete windows; starts cli.serve --backend native in its
     own process (256 slots, timer ticks, --stats-port 0), streams 64
     clients into it at real time for 5 s, reads /healthz and /stats (tick
     and delivery-lag percentiles, dropped samples) and stops it with
     SIGTERM (exit 0, last line serving false); holds the precision modes
     on the trained checkpoint at B = 256 and 1024 ("serve" vs "high" 1e-3
     max-relative, BN-folded vs unfolded 2e-4, bf16 + fold vs "high" 1e-2;
     classifier ms by CUDA events; TF32 flags off after each);
  9. spectral contrast and the tools between training and serving (budget
     35 s, seconds printed by sub-step, under build/smoke_tools/): the
     shipped config with spectral contrast (97x101) through the fused
     launcher's hybrid at B = 256 and 1024 (each of its three launches once
     a call; against the torch chain with each of its
     four contrast variants, fft and gemm x select and rank, and against
     the CPU, 1e-3 max-relative; phase 4 times it); a contrast-config
     residual: 8 train steps on phase 6's shards, one 16-stream detector
     tick (scores 1e-3 from the CPU's, a replay of its scoring program
     bit-equal), cli.featurize --config on 16 of phase 7's clips (1e-3
     from the CPU chain), its serving function exported by torch.export
     (three custom-op nodes; 1e-6 from eager), each launch once a call or
     step; cli.evaluate on phase 6's
     trained checkpoint: its 256 validation shards card vs CPU (counts
     equal, loss 1e-4), --behavioral and --calibrate (its replay
     self-check) at 0.5 minutes a scenario; cli.audit --model on phase 7's
     directory plus a planted silent, clipped and DC-offset clip (each
     flagged); cli.extract_segments --mode energy --threshold-db -20 --model
     on phase 7's 10-minute recording, card vs CPU (the same segments
     kept); cli.export
     --pt --program --fold-bn, the serving.pt2 loaded on the card against
     the eager serving function at B = 256 (1e-6) and the exported .pt
     served. Each path's launches are counted from 0;
 10. training and scoring across ranks and devices (budget 45 s, seconds
     printed by sub-step, under build/smoke_parallel/), 2 epochs of phase
     6's corpus through cli.train each time: the plain trainer, then NCCL
     at world size 1 through cli.train --distributed (bit-equal
     checkpoints, moments and metrics.jsonl; the routed gather equal to
     index_select); two ranks on cuda:0 over gloo, as subprocesses of
     cli.train --distributed --dist-backend gloo with the row probes on
     (CDT_DEBUG_STEP_METRICS), the corpus sharded by rows, in two pairs
     side by side: on the whole corpus (one epoch, 72 steps) every rank's
     rows equal the one-process run's by CRC, its batch matrices too, rows
     built sum to one process's, each rank's launches equal its steps,
     rank 0 alone writes, and the first 5 step losses are within 1e-5; on the first
     64 + 32 clips (2 + 1 steps an epoch, the geometry of the JAX
     package's cluster test) the same, and counts, accuracy and F1 exact,
     epoch losses within 1e-3; chunked windows (8 windows of 8 steps an
     epoch), one epoch and a resume to two through the background writer,
     bit-equal to the resident run, with both runs' epoch wall and the
     device idle share over a profiled epoch; synchronous checkpoint saves
     against the background writer (epoch walls); the train step's ms of
     the three runs (the timed runs without the probes, which copy every
     batch to the host); and a mesh of ["cuda:0", "cuda:0"] against one
     device: 256 detector streams x 20 ticks (events equal, confidences
     1e-5), the 10-minute recording through score_recording (events
     equal, confidences 1e-5), cli.evaluate --mesh on the 256 validation
     shards (counts equal) and cli.featurize --mesh on 16 clips (1e-6).
     Each path's launches are counted from 0;
 11. captured programs (budget 30 s, seconds printed by sub-step, under
     build/smoke_graphs/): on the card the streaming tick and the train and
     eval steps run as CUDA graphs (utils/graphs.py), which every phase
     above already runs through, their launches counted through replays.
     Here each is held against its eager version on the card: a graphed
     and an eager 256-stream detector over 44 ticks in float32, int16 and
     μ-law with reset_streams and set_thresholds mid-run (every tick's
     packed tensor bit-equal, events equal, launches one a scoring tick,
     one graph a (dtype, fill) key), their tick p50 / p99 and idle shares;
     train() for 2 epochs on phase 6's corpus on the graphs and eagerly
     (losses, parameters, BN statistics and moments bit-equal, 144 launches
     each), the epoch walls and a profiled epoch's idle share of each, and
     the batch-32 step by CUDA events and the host clock. Phase 8 checks
     that every daemon tick of every format and tier replays a graph its
     warm ticks captured, and that cli.serve reports its tick graphs;
 12. pipelined epochs and the scoring programs (budget 30 s, seconds
     printed by sub-step, under build/smoke_pipeline/): train() for 3
     epochs of phase 6's corpus pipelined one deep (the loop's choice for
     one process with a resident corpus) and synchronous, then both with an
     early stop forced at epoch 1 by patience: per-step losses, parameters
     with BN statistics, moments, both checkpoints and metrics.jsonl (less
     timings) bit-equal, launches one a finished epoch's step, the
     in-memory model and optimizer count the last finished epoch's, every
     epoch e+1's first replay before epoch e's fetch; epoch walls, the host
     time from epoch e's metrics in hand to e+1's first replay (negative
     pipelined, and below every synchronous one), the idle share over
     epochs 1-2 of a profiled run of each. Every scoring path as captured
     programs against its eager function, bit for bit: score_recording on
     phase 7's recording (windows/s of the call and of a 1024-window batch,
     peak device memory, graphed beside eager), cli.evaluate on the 256
     validation shards, cli.featurize on 16 clips with and without
     --augment, extract-segments' scorer, CoughDetectorInference.predict;
     each path's keys, replays and launches through replays. Phases 5, 7,
     9 and 10 score through the same programs;
 13. the port's bench (budget 45 s, seconds printed by sub-step, under
     build/smoke_bench/): cli/bench.py's headline at B = 16384 in "high"
     (with the ingest-inclusive record), "serve" and bf16 (records, the
     card's name, one launch of each kernel a timed replay, "high"'s logits
     on 256 rows within 1e-3 of the plain version, the pair's device time
     inside the program); extract_features_fast at B = 70,000, past the old
     65,535-clip limit (rows 65,000-69,999 within 1e-3 of the plain version
     on those rows); the serving bench at 256 and 20,480 streams (no tick
     captured inside the timed loops); `python -m
     cough_detector_tpu_torch.cli.bench --daemon --backend native --loadgen
     native --streams 512 --seconds 5` as a subprocess beside them;
 14. training over a mesh (budget 30 s, seconds printed by sub-step, under
     build/smoke_mesh/), on phase 10's 64 + 32-clip corpus for 2 epochs:
     train(mesh=["cuda:0"]) bit-equal to train(device="cuda:0") (one
     process, pipelined); train(mesh=["cuda:0", "cuda:0"]), two gloo ranks
     started by the call, bit-equal to phase 10's pair of the same
     arguments run under torchrun's environment, each rank's launches one a
     train and eval step, rank 0 alone writing; cli.train --mesh
     cuda:0,cuda:0 --compile-cache DIR, a subprocess beside them,
     bit-equal to the pair too; the host time from each call's entry to
     rank 0 joining the group, its step loop and its first step, and the
     epoch walls of the mesh beside the one-process run;
 15. prints the kernels' JSON line, then the device line last.

Imports only torch, numpy, scipy (data/synth.py) and the port package;
never JAX. It downloads nothing: the data are synthesized from seeds.
"""

from __future__ import annotations

import os
import threading
import time
from pathlib import Path

T_IMPORTS = time.time()  # main() prints the seconds its imports took


def _start_kernel_build() -> tuple:
    """(thread, result): the front-end kernel's nvcc build, started before
    torch is imported (about 8 s of the run). utils/kernel_build.py imports
    only the standard library, so it is loaded from its file, without the
    package (which imports torch). Phase 2 joins the thread; result holds
    the build's seconds, or the error phase 2 raises."""
    import importlib.util

    result = {}

    def build() -> None:
        t0 = time.perf_counter()
        try:
            path = Path(__file__).resolve().parent / "cough_detector_tpu_torch" / "utils" / "kernel_build.py"
            spec = importlib.util.spec_from_file_location("_chip_smoke_kernel_build", path)
            module = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(module)
            module.load("frontend_kernel")
            result["seconds"] = time.perf_counter() - t0
        except Exception as e:  # raised in phase 2, after the card's check
            result["error"] = e

    thread = threading.Thread(target=build, name="kernel-build")
    thread.start()
    return thread, result


KERNEL_BUILD = _start_kernel_build()

# The training phase asks for deterministic algorithms; torch then wants
# cuBLAS's workspace fixed, which it reads before the first cuBLAS call.
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

import atexit  # noqa: E402
import concurrent.futures  # noqa: E402
import contextlib  # noqa: E402
import copy  # noqa: E402
import dataclasses  # noqa: E402
import functools  # noqa: E402
import gc  # noqa: E402
import io  # noqa: E402
import itertools  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import re  # noqa: E402
import shutil  # noqa: E402
import signal  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import urllib.request  # noqa: E402

import numpy as np  # noqa: E402
import torch  # noqa: E402

SEED = 0
TOL = 1e-3
# The contrast launch against its 3xTF32 model: sound runs read ~3e-6, one
# TF32 pass ~7e-4 (tests/test_torch_contrast_kernel.py).
SPLIT_TOL = 1e-4
# The FFT plans against their CPU models (power_mel_fft_reference,
# spectral_contrast_fft_reference), which round each multiply and add where
# the kernels may fuse them: the card read 6.1e-8 to 3.5e-7 (NVIDIA H100).
FFT_TOL = 1e-5
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


def without_ceilings(obj):
    """obj with every key ending in ceiling_ms dropped, at any depth: a
    design's ceiling is worked out from its shapes, not measured, and the
    kernels line carries only this run's measurements beside bound_ms (the
    phases print the ceilings on their own lines)."""
    if isinstance(obj, dict):
        return {k: without_ceilings(v) for k, v in obj.items() if not str(k).endswith("ceiling_ms")}
    if isinstance(obj, list):
        return [without_ceilings(v) for v in obj]
    return obj


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


def make_audio_bulk(rng: np.random.Generator, n_streams: int, n_samples: int, device) -> torch.Tensor:
    """make_audio's kind of clips, made on `device` in bulk for long clips
    and large batches: noise from a device generator seeded from rng, and
    two bursts a second, each one of a bank of 32 (make_audio's decaying
    noise plus a low tone) at a random place and level."""
    gen = torch.Generator(device=device).manual_seed(int(rng.integers(2**31)))
    out = torch.randn((n_streams, n_samples), generator=gen, device=device) * 0.01
    t = np.arange(int(0.3 * SR)) / SR
    bank = torch.from_numpy(np.stack([
        np.exp(-t / rng.uniform(0.03, 0.12)) * (rng.standard_normal(t.size) + np.sin(2 * np.pi * rng.uniform(150, 800) * t))
        for _ in range(32)
    ]).astype(np.float32)).to(device)
    per = max(1, n_samples // SR * 2)
    starts = torch.from_numpy(rng.integers(0, n_samples - t.size, (n_streams, per))).to(device)
    which = torch.from_numpy(rng.integers(0, len(bank), (n_streams, per))).to(device)
    level = torch.from_numpy(rng.uniform(0.2, 0.9, (n_streams, per)).astype(np.float32)).to(device)
    rows, span = torch.arange(n_streams, device=device)[:, None], torch.arange(t.size, device=device)
    for k in range(per):  # one burst a clip at a time: no index repeats within a step
        out[rows, starts[:, k, None] + span] += level[:, k, None] * bank[which[:, k]]
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
    recorded, which may miss one at the edge of its window. A profile that
    lost the device's records (it has come back with none) is taken again,
    up to three times."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        times = [
            e.time_range.elapsed_us() for e in prof.events()
            if e.device_type == DeviceType.CUDA and kernel in e.name
        ]
        if iters // 2 <= len(times) <= iters:
            return sum(times) / len(times) / 1e3
        print(f"the profiler saw {len(times)} launches of {kernel} over {iters} calls", flush=True)
    fail(f"the profiler saw {len(times)} launches of {kernel} over {iters} calls, three times")


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


# Phase 7's resampling: 16 kHz clips rewritten at 44.1 and 8 kHz, those read
# back to 16 kHz, and speed perturbation's factors (0.9, 0.95, 1.05, 1.1).
SPEED_FACTORS = (0.9, 0.95, 1.05, 1.1)
RESAMPLE_PAIRS = [(SR, 44100), (SR, 8000), (44100, SR), (8000, SR)] + [(SR, int(round(SR / f))) for f in SPEED_FACTORS]


def resample_banks() -> None:
    """The polyphase banks of RESAMPLE_PAIRS (cached by ops/resample.py),
    built on the host, at once: phase 2 runs this beside the kernel build."""
    from cough_detector_tpu_torch.ops import resample

    with concurrent.futures.ThreadPoolExecutor(len(RESAMPLE_PAIRS)) as pool:
        list(pool.map(lambda p: resample._sinc_kernel(p[0] // math.gcd(*p), p[1] // math.gcd(*p)), RESAMPLE_PAIRS))


def training_corpus() -> tuple:
    """Phase 6's corpus, (train waves, labels, val waves, labels): 2048 + 256
    synthetic clips of 1 s, half coughs, made on the host from SEED (phase 2
    runs this beside the kernel build)."""
    from cough_detector_tpu_torch.data import synth

    def corpus(n: int, seed0: int) -> tuple:
        labels = np.arange(n) % 2  # half coughs
        waves = np.stack([
            synth.synthetic_cough(seed0 + i, 1.0) if labels[i] else synth.synthetic_non_cough(seed0 + i, 1.0)
            for i in range(n)
        ])
        return waves, labels

    return (*corpus(2048, SEED), *corpus(256, SEED + 2048))


def coverage_tables() -> None:
    """The DFT matrices of every coverage config (ops/filters.py caches
    them: 2.7 s of float64 cosines on the host, most of it at n_fft 2000 to
    4096), which phase 3's plain versions and models read. Phase 2 runs
    this beside the kernel build."""
    from cough_detector_tpu_torch.ops import filters

    for cfg, _ in coverage_configs().values():
        filters.dft_matrices(cfg.n_fft, cfg.win_length)
        if cfg.use_spectral_contrast:
            filters.dft_matrices(cfg.n_fft, cfg.n_fft)


def keep_config_tables() -> None:
    """Phases 3 and 4 run the launches on more configs than a serving
    process holds tables for: the launchers' per-config caches of device
    tables (ops/frontend_kernel.py, 16 to 48 entries, least recently used
    out) are rebuilt here at 128 entries for this run, so that phase 4
    reuses the tables phase 3 built instead of building each again. The
    tables, and so every result, are the same."""
    from cough_detector_tpu_torch.ops import frontend_kernel

    for name in ("_constants", "_fft_constants", "_geometry", "_contrast_constants", "_centroid_and_bands",
                 "_contrast_fft_constants"):
        setattr(frontend_kernel, name, functools.lru_cache(maxsize=128)(getattr(frontend_kernel, name).__wrapped__))


def start_profiler() -> None:
    """One torch.profiler session on the card: a process's first starts the
    profiler's device tracing, 11-13 s on an H100's host (phase 4's first
    device time took 12.9 s where later ones take about 1; PERF.md). Phase
    2 runs this beside the kernel build."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        torch.ones(1, device="cuda").add_(1)
        torch.cuda.synchronize()


def start_prepare_data() -> subprocess.Popen:
    """Phase 7's WAV data directory, written by cli.prepare_data in a process
    of its own (the card hidden) into a fresh build/smoke_files/data: phase 2
    starts it beside the kernel build, phase 7 waits for it."""
    root = Path(__file__).resolve().parent / "build" / "smoke_files"
    shutil.rmtree(root, ignore_errors=True)
    return subprocess.Popen(
        [sys.executable, "-m", "cough_detector_tpu_torch.cli.prepare_data", "--output-dir", str(root / "data"),
         "--esc50-dir", str(root / "no_esc50"), "--skip-download", "--synthetic-coughs", "384",
         "--synthetic-non-coughs", "768", "--hard-negatives", "0.3", "--seed", str(SEED)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, cwd=Path(__file__).resolve().parent,
        env={**os.environ, "CUDA_VISIBLE_DEVICES": ""},
    )


def train_phase(smi: str, made: tuple) -> dict:
    """Phase 6, the training path, on `made` (training_corpus's); returns
    what the kernels' JSON line adds."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from cough_detector_tpu_torch.augment import augment_waveforms, spec_augment
    from cough_detector_tpu_torch.cli import train as train_cli
    from cough_detector_tpu_torch.config import Config, FeatureConfig, ModelConfig, TrainConfig
    from cough_detector_tpu_torch.data import dequantize_torch, pack_arrays, quantize
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

    # -- 6.1 corpus (synthesized in phase 2)
    t0 = time.perf_counter()
    train_w, train_l, val_w, val_l = made
    pack_arrays(train_w, train_l, str(shards / "train"))
    pack_arrays(val_w, val_l, str(shards / "val"))
    print(f"training corpus: {n_train} + {n_val} clips (synthesized in phase 2) packed in {time.perf_counter() - t0:.3f} s",
          flush=True)

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
    # The unprofiled epoch: epoch 2's wall_s delta. The pipelined loop's
    # rates both denominate over a window that holds the epoch before's
    # tail, so they are not this epoch's time.
    plain_ms = deltas[-1] * 1e3
    epoch_idle = None
    if len(epoch_ev) == 1:
        lo, hi = epoch_ev[0].time_range.start, epoch_ev[0].time_range.end
        busy = busy_ms(events, lo, hi)
        span = (hi - lo) / 1e3
        epoch_idle = 1 - busy / plain_ms
        print(
            f"[{smi}] one epoch under torch.profiler: {span:.3f} ms span, device busy {busy:.3f} ms, "
            f"idle share {1 - busy / span:.3f}; against the unprofiled epoch 2 of train() "
            f"({plain_ms:.3f} ms, its wall_s delta): idle share {1 - busy / plain_ms:.3f}",
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
        "best_model": out_b / "best_model", "shards": shards, "launches": launches, "ms_b32": launch_ms,
        "device_ms_b32": launch_dev,
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


def files_phase(smi: str, shard: dict, yard: dict, prepare: subprocess.Popen) -> dict:
    """Phase 7, files to detections, from the data directory `prepare`
    (start_prepare_data's process) writes; returns what the kernels' JSON
    line adds."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from cough_detector_tpu_torch.augment import waveform as augment_wave
    from cough_detector_tpu_torch.cli import detect as detect_cli
    from cough_detector_tpu_torch.cli import featurize as featurize_cli
    from cough_detector_tpu_torch.cli import pack as pack_cli
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
    data = root / "data"
    rng = np.random.default_rng(SEED + 7)

    # -- 7.1 a WAV data directory (cli.prepare_data, started in phase 2); a
    # quarter of it at 44.1 and 8 kHz
    t0 = time.perf_counter()
    prepared = prepare.communicate(timeout=600)[0]
    print(prepared, end="", flush=True)
    if prepare.returncode:
        fail(f"cli.prepare_data exited {prepare.returncode}")
    wavs = sorted(data.rglob("*.wav"))
    rates = {}
    for k, rate in enumerate((44100, 8000)):
        paths = wavs[1 + 4 * k :: 8]
        clips = torch.from_numpy(np.stack([audio_io.read_wav(p)[0][0] for p in paths])).to(dev)
        for path, wave in zip(paths, resample.resample(clips, SR, rate).cpu().numpy()):
            audio_io.write_wav(path, wave, rate)
        rates[rate] = len(paths)
    print(
        f"data directory: {len(wavs)} clips of 2 s written by cli.prepare_data (its process started in phase 2) "
        f"and {rates} rewritten at other rates in {time.perf_counter() - t0:.3f} s",
        flush=True,
    )

    # -- 7.2 the resampler on the card against the CPU (cuDNN's TF32 on at
    # entry; the banks built in phase 2)
    pairs = RESAMPLE_PAIRS[2:]
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
    draws = augment_wave.speed_draws(gen, 16, 0.7, len(SPEED_FACTORS))
    want = augment_wave.speed_apply(x, draws, SPEED_FACTORS)
    got = augment_wave.speed_apply(x.to(dev), augment_wave.SpeedDraws(*(d.to(dev) for d in draws)), SPEED_FACTORS).cpu()
    speed_err = float((got - want).abs().max())
    torch.backends.cudnn.allow_tf32 = False  # the models' setting (phase 5)
    print(
        f"resample card vs CPU at B=64 on unit-peak audio, cuDNN TF32 on at entry and {tf32_after} after "
        f"(banks built in phase 2): max abs {resample_err}; speed_perturbation apply at B=16 on the "
        f"same draws ({int(draws.apply.sum())} clips stretched): max abs {speed_err:.3e} (limit 1e-5)",
        flush=True,
    )
    if not (max(resample_err.values()) <= 1e-5 and speed_err <= 1e-5 and tf32_after):
        fail("the resampler on the card disagrees with the CPU's, or left TF32 changed")

    # -- 7.3 training from the data directory through the CLI
    bs = TrainConfig().batch_size
    train_ds, val_ds = prepare_dataset_split(str(data))
    steps_per_epoch, val_steps = len(train_ds) // bs, -(-len(val_ds) // bs)
    loader = BatchLoader(train_ds, bs, shipped, num_workers=4, backend="python")
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
            "--num-workers", "4", "--decode-backend", "python",
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
    idle, idle_share = "not measured", None
    if len(epoch_ev) == 1:
        busy = busy_ms(events, epoch_ev[0].time_range.start, epoch_ev[0].time_range.end)
        idle_share = 1 - busy / plain_ms
        idle = f"{idle_share:.3f} (device busy {busy:.3f} ms)"
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
    # cli.pack decodes with "auto", the C++ decoder that phase 2 built; the
    # batches it is held against come from the same decoder.
    run_cli(pack_cli.main, ["--data-dir", str(data), "--output", str(root / "shards"), "--num-workers", "4"])
    shard_loader = ShardLoader(str(root / "shards" / "train"), bs, weighted=True, drop_last=True, seed=SEED,
                               feature_config=shipped)
    decode_loader = BatchLoader(train_ds, bs, shipped, weighted=True, drop_last=True, seed=SEED, num_workers=4,
                                backend="native")
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
        "b1024": b1024, "data": data, "recording": rec, "decode": {
            "clips_per_s": decode_cps, "step_ms": [bs / r["train_clips_per_sec"] * 1e3 for r in recs_a],
            "idle_share": idle_share,
        },
    }


def windows_completed(n_ticks: int, chunk: int, window: int, hop: int) -> list:
    """For each tick of a lockstep stream (stream/ring.py's arithmetic),
    whether it completes at least one window: the ticks that launch the
    front-end kernels."""
    out, fill = [], 0
    k_max = (chunk - 1) // hop + 1
    for _ in range(n_ticks):
        fill += chunk
        n_valid = min((fill - window) // hop + 1, k_max) if fill >= window else 0
        fill -= n_valid * hop
        out.append(n_valid > 0)
    return out


def serve_streams(server, audio: np.ndarray, n_ticks: int, n_clients: int = 4) -> list:
    """Feed `audio` (one row a slot) to a started eager server through
    `n_clients` loopback clients, tick-major; returns (lane, time, confidence)
    for every event, lane being the audio row."""
    from cough_detector_tpu_torch.serve import DetectionClient

    n = audio.shape[0]
    with contextlib.ExitStack() as stack:
        clients = [stack.enter_context(DetectionClient(*server.address)) for _ in range(n_clients)]
        owner = [clients[s % n_clients] for s in range(n)]
        sids = [owner[s].open_stream() for s in range(n)]
        for t in range(n_ticks):
            for s in range(n):
                owner[s].send_audio(sids[s], audio[s, t * CHUNK : (t + 1) * CHUNK])
        deadline = time.time() + 60
        while server.stats()["ticks"] < n_ticks and time.time() < deadline:
            time.sleep(0.01)
        lane = {sid: s for s, sid in enumerate(sids)}
        got = []
        time.sleep(0.2)  # the last tick's frames may still be on the wire
        for c in clients:
            got += [(lane[e["stream"]], round(e["time"], 6), e["confidence"]) for e in c.events(timeout=0.5)]
    return sorted(got)


def same_events(got: list, want: list, conf_tol: float) -> tuple:
    """(equal, worst confidence difference): same lanes and times, each
    confidence within conf_tol."""
    if len(got) != len(want) or [g[:2] for g in got] != [w[:2] for w in want]:
        return False, float("inf")
    worst = max((abs(g[2] - w[2]) for g, w in zip(got, want)), default=0.0)
    return worst <= conf_tol, worst


def daemon_phase(smi: str, best_model: Path, data: Path, decode: dict, shard: dict) -> dict:
    """Phase 8, the serving daemon and the native tiers; returns what the
    kernels' JSON line adds."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from cough_detector_tpu_torch.config import Config, FeatureConfig, TrainConfig
    from cough_detector_tpu_torch.data import BatchLoader, native_loader, prepare_dataset_split
    from cough_detector_tpu_torch.models import fold_batchnorm, model_from_config, place_model
    from cough_detector_tpu_torch.ops import frontend_kernel
    from cough_detector_tpu_torch.serve import DetectionClient, DetectionServer, quantize_i16, quantize_mulaw
    from cough_detector_tpu_torch.stream import StreamingDetector, ring
    from cough_detector_tpu_torch.stream.detector import _load_checkpoint
    from cough_detector_tpu_torch.train import train

    t_phase = time.perf_counter()
    dev = torch.device("cuda")
    shipped = FeatureConfig()
    rng = np.random.default_rng(SEED + 8)
    root = Path(__file__).resolve().parent / "build" / "smoke_daemon"
    shutil.rmtree(root, ignore_errors=True)

    # -- 8.1 the decode tier: phase 7's train clips, cold, native and Python
    bs = TrainConfig().batch_size
    train_ds, _ = prepare_dataset_split(str(data))
    paths = [p for p, _ in train_ds.samples]
    rates = {}
    for threads in (4, 8):
        t0 = time.perf_counter()
        native_w, n_ok, errors = native_loader.load_batch(paths, shipped.segment_samples, SR, n_threads=threads)
        rates[threads] = len(paths) / (time.perf_counter() - t0)
        if n_ok != len(paths):
            fail(f"the native loader failed on {len(paths) - n_ok} clips: {errors}")
    t0 = time.perf_counter()
    python_w, _ = next(iter(BatchLoader(train_ds, len(paths), shipped, num_workers=4, backend="python", cache_bytes=0)))
    python_rate = len(paths) / (time.perf_counter() - t0)
    decode_err = float(np.abs(native_w - python_w).max())
    print(
        f"[{smi}] decode tier, {len(paths)} train clips cold: native load_batch {rates[4]:,.0f} clips/s on 4 "
        f"threads, {rates[8]:,.0f} on 8; the Python decoder {python_rate:,.0f} clips/s on 4 (phase 7: "
        f"{decode['clips_per_s']:,.0f}); every row native vs Python max abs {decode_err:.3e} (limit 2e-5)",
        flush=True,
    )
    if not decode_err <= 2e-5:
        fail("the native loader's rows differ from the Python decoder's")

    # One decode-path epoch on the native tier, under the profiler.
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        train(str(data), str(root / "native_epoch"), config=Config(train=TrainConfig(epochs=1)),
              num_workers=4, decode_backend="native")
    rec = json.loads((root / "native_epoch" / "metrics.jsonl").read_text().splitlines()[-1])
    events = prof.events()
    epoch_ev = [e for e in events if e.device_type == DeviceType.CPU and e.name == "cdt.epoch"]
    idle = None
    if len(epoch_ev) == 1:
        lo, hi = epoch_ev[0].time_range.start, epoch_ev[0].time_range.end
        idle = 1 - busy_ms(events, lo, hi) / ((hi - lo) / 1e3)
    native_step = bs / rec["train_clips_per_sec"] * 1e3
    print(
        f"[{smi}] decode path on the native tier (one epoch under torch.profiler, batch {bs}): step "
        f"{native_step:.4f} ms ({rec['train_clips_per_sec']:.1f} train clips/s), idle share "
        f"{'not measured' if idle is None else format(idle, '.3f')}; phase 7 on the Python decoder: step "
        f"{[round(v, 4) for v in decode['step_ms']]} ms, idle share {decode['idle_share']}; shards (phase 6) "
        f"step {shard['step_ms_b32']:.4f} ms",
        flush=True,
    )

    # -- 8.2 the daemon in-process: 16 streams on the native plane, each format
    variables, config = _load_checkpoint(str(best_model))
    n_streams, n_ticks = 16, 30
    audio = make_audio(rng, n_streams, n_ticks * CHUNK)
    w16 = torch.from_numpy(audio[:, :SR]).to(dev)
    pair16 = rel_err(frontend_kernel.extract_features_fused(w16, shipped),
                     frontend_kernel.frontend_kernel_reference(w16, shipped))
    if not pair16 <= TOL:
        fail(f"the kernel pair disagrees with its plain version at the daemon's B=16: {pair16:.3e}")
    window, hop = shipped.segment_samples, SR // 4
    scoring = sum(windows_completed(n_ticks, CHUNK, window, hop))
    quantizers = {"float32": lambda x: x, "int16": quantize_i16, "mulaw": quantize_mulaw}
    wants = {}
    for fmt, q in quantizers.items():
        ref = StreamingDetector(variables=variables, config=config, device="cuda", num_streams=n_streams,
                                chunk_size=CHUNK, confidence_threshold=0.0)
        dets = []
        for t in range(n_ticks):
            dets += ref.collect_events(ref.tick_async(q(audio[:, t * CHUNK : (t + 1) * CHUNK])))
        wants[fmt] = sorted((d.stream, round(d.time_seconds, 6), d.confidence) for d in dets)
    runs = [(fmt, backend, workers) for fmt in quantizers for backend, workers in
            (("native", 1), ("python", 1), ("native", 4))]
    got, ticks, graph_runs = {}, {}, {}
    daemon_launches = {"spectral": 0, "epilogue": 0}
    t0 = time.perf_counter()
    for fmt, backend, workers in runs:
        server = DetectionServer(
            variables=variables, config=config, device="cuda", num_streams=n_streams, chunk_size=CHUNK,
            confidence_threshold=0.0, tick_policy="eager", liveness_seconds=float("inf"), backend=backend,
            h2d_dtype=fmt, ingest_workers=workers,
        )
        server.start()  # its warm ticks launch the kernels once, before any client
        try:
            frontend_kernel.SPECTRAL_LAUNCHES = frontend_kernel.EPILOGUE_LAUNCHES = 0
            got[fmt, backend, workers] = serve_streams(server, audio, n_ticks)
            daemon_launches["spectral"] += frontend_kernel.SPECTRAL_LAUNCHES
            daemon_launches["epilogue"] += frontend_kernel.EPILOGUE_LAUNCHES
            ticks[fmt, backend, workers] = server.stats()["ticks"]
            # The ticks ran as graphs of this format's dtype, every key
            # captured by the warm ticks: each client tick a replay.
            progs = server._detector.tick_programs()
            graph_runs[fmt, backend, workers] = bool(progs) and progs[0].graphed and (
                {k[0] for k in progs[0].keys} == {{"mulaw": "uint8"}.get(fmt, fmt)}
                and len(progs[0].keys) == len(ring.tick_fills(CHUNK, window, hop))
                and sum(progs[0].replays().values()) == n_ticks
            )
        finally:
            server.stop()
    serve_s = time.perf_counter() - t0
    for fmt in quantizers:
        main_run = got[fmt, "native", 1]
        vs_ref = same_events(main_run, wants[fmt], 1e-4)
        vs_python = same_events(main_run, got[fmt, "python", 1], 2e-6)
        vs_workers = same_events(main_run, got[fmt, "native", 4], 2e-6)
        print(
            f"daemon [{fmt}] native plane, {n_streams} streams x {n_ticks} eager ticks: {len(main_run)} events; "
            f"== in-process detector {vs_ref[0]} (confidences max abs {vs_ref[1]:.3e}, limit 1e-4); == python "
            f"tier {vs_python[0]} ({vs_python[1]:.3e}); == 4 ingest workers {vs_workers[0]} ({vs_workers[1]:.3e})",
            flush=True,
        )
        if not (main_run and vs_ref[0] and vs_python[0] and vs_workers[0]):
            fail(f"the daemon's events on {fmt} differ between the native plane, the python tier and the detector")
    want_launches = scoring * len(runs)
    print(
        f"daemon front-end launches over the {len(runs)} runs {daemon_launches}, expected {want_launches} "
        f"({scoring} of each run's {n_ticks} ticks complete windows; ticks {sorted(set(ticks.values()))}); "
        f"the runs took {serve_s:.3f} s; kernel pair vs plain at B=16 max-relative {pair16:.3e}",
        flush=True,
    )
    if set(daemon_launches.values()) != {want_launches} or set(ticks.values()) != {n_ticks}:
        fail("the daemon's ticks did not launch the front-end kernels once per scoring tick")
    print(
        f"daemon ticks on captured graphs, every client tick a replay of a key its warm ticks captured "
        f"({len(ring.tick_fills(CHUNK, window, hop))} keys a format): {graph_runs}",
        flush=True,
    )
    if not all(graph_runs.values()):
        fail("a daemon run's ticks did not all replay graphs its warm ticks captured")

    # -- 8.3 the daemon as users start it: cli.serve in its own process
    n_slots, n_clients, seconds = 256, 64, 5.0
    proc = subprocess.Popen(
        [sys.executable, "-m", "cough_detector_tpu_torch.cli.serve", "--model", str(best_model),
         "--port", "0", "--streams", str(n_slots), "--backend", "native", "--tick-policy", "timer",
         "--stats-port", "0", "--stats-interval", "1", "--threshold", "0.5"],
        cwd=Path(__file__).resolve().parent, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
    )
    err_tail = []
    drain = threading.Thread(target=lambda: err_tail.append(proc.stderr.read()), daemon=True)
    drain.start()
    killer = threading.Timer(120, proc.kill)  # a hung daemon fails the run, never stalls it
    killer.start()
    try:
        t0 = time.perf_counter()
        first = json.loads(proc.stdout.readline() or "{}")
        start_s = time.perf_counter() - t0
        if not first.get("serving") or first.get("backend") != "native":
            proc.kill()
            drain.join(timeout=10)
            fail(f"cli.serve did not start on the native plane: {first}; stderr: {''.join(err_tail)[-2000:]}")
        base = f"http://{first['stats_http'][0]}:{first['stats_http'][1]}"
        stream_audio = make_audio(rng, n_clients, int(seconds * SR))
        with contextlib.ExitStack() as stack:
            clients = [stack.enter_context(DetectionClient(first["host"], first["port"])) for _ in range(8)]
            owner = [clients[s % 8] for s in range(n_clients)]
            sids = [owner[s].open_stream() for s in range(n_clients)]
            t_start = time.perf_counter()
            for t in range(int(seconds * SR) // CHUNK):  # real time: one chunk a stream every 100 ms
                for s in range(n_clients):
                    owner[s].send_audio(sids[s], stream_audio[s, t * CHUNK : (t + 1) * CHUNK])
                time.sleep(max(0.0, t_start + (t + 1) * CHUNK / SR - time.perf_counter()))
            with urllib.request.urlopen(base + "/healthz", timeout=5) as r:
                health = (r.status, r.read())
            with urllib.request.urlopen(base + "/stats", timeout=5) as r:
                stats = json.loads(r.read())
            n_events = sum(len(c.events(timeout=0.2)) for c in clients)
        proc.send_signal(signal.SIGTERM)
        rest = proc.stdout.read()
        proc.wait(timeout=60)
    finally:
        killer.cancel()
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    drain.join(timeout=10)
    last = json.loads(rest.strip().splitlines()[-1])
    print(
        f"[{smi}] cli.serve --backend native --tick-policy timer, {n_slots} slots, {n_clients} client streams "
        f"for {seconds} s of real-time audio: ready in {start_s:.3f} s; /healthz {health}; /stats ticks "
        f"{stats.get('ticks')}, open_streams {stats.get('open_streams')}, tick_ms_p50 {stats.get('tick_ms_p50')} "
        f"p99 {stats.get('tick_ms_p99')}, delivery_lag_ms_p50 {stats.get('delivery_lag_ms_p50')} p99 "
        f"{stats.get('delivery_lag_ms_p99')}, dropped_samples {stats.get('dropped_samples')}, events "
        f"{stats.get('events')} ({n_events} received at threshold 0.5); tick graphs {stats.get('tick_graphs')}, "
        f"replays {stats.get('tick_replays')}; SIGTERM: exit {proc.returncode}, last line "
        f"serving={last.get('serving')}",
        flush=True,
    )
    if not (health == (200, b"ok") and stats.get("backend") == "native" and stats.get("open_streams") == n_clients
            and stats.get("ticks", 0) > 0 and proc.returncode == 0 and last.get("serving") is False
            and stats.get("tick_graphs") == len(ring.tick_fills(CHUNK, window, hop))
            and stats.get("tick_replays", 0) >= stats.get("ticks", 0)):
        fail(f"cli.serve did not serve, report or stop as it should; stderr: {''.join(err_tail)[-2000:]}")

    # -- 8.4 the precision modes on phase 6's trained checkpoint
    folded = fold_batchnorm(variables, config.model.model_type)
    modes = {
        "high": (config.model, "high", variables),
        "serve": (config.model, "serve", variables),
        "high+fold": (config.model, "high", folded),
        "bf16+fold": (dataclasses.replace(config.model, compute_dtype="bfloat16"), "high", folded),
    }
    models = {}
    for name, (mcfg, mode, weights) in modes.items():
        m = model_from_config(mcfg, mode)
        m.load_state_dict({k: torch.as_tensor(v) for k, v in weights.items()})
        models[name] = place_model(m, dev)
    precision = {}
    for b in (256, 1024):
        feats = frontend_kernel.extract_features_fused(torch.from_numpy(make_audio(rng, b, SR)).to(dev), shipped)
        with torch.no_grad():
            logits = {}
            for name, m in models.items():
                logits[name] = m(feats)
                flags = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
                if any(flags) or logits[name].dtype != torch.float32:
                    fail(f"the {name} mode left TF32 flags {flags} or gave {logits[name].dtype} logits")
            ms = {name: cuda_ms(lambda m=m: m(feats), 20) for name, m in models.items()}
        errs = {
            "serve_vs_high": rel_err(logits["serve"], logits["high"]),
            "fold_vs_unfolded": rel_err(logits["high+fold"], logits["high"]),
            "bf16_fold_vs_high": rel_err(logits["bf16+fold"], logits["high"]),
        }
        precision[b] = dict(errs, ms=ms)
        print(
            f"[{smi}] precision modes at B={b} (phase 6's trained checkpoint, max|logit| "
            f"{logits['high'].abs().max().item():.3f}): serve vs high {errs['serve_vs_high']:.3e} (limit 1e-3), "
            f"folded vs unfolded {errs['fold_vs_unfolded']:.3e} (limit 2e-4), bf16 + fold vs high "
            f"{errs['bf16_fold_vs_high']:.3e} (limit 1e-2); classifier ms (CUDA events) "
            + ", ".join(f"{k} {v:.4f}" for k, v in ms.items()) + "; TF32 flags False after every mode",
            flush=True,
        )
        if not (errs["serve_vs_high"] <= 1e-3 and errs["fold_vs_unfolded"] <= 2e-4 and errs["bf16_fold_vs_high"] <= 1e-2):
            fail(f"a precision mode is outside its bound at B={b}: {errs}")
    print(f"daemon phase: {time.perf_counter() - t_phase:.3f} s", flush=True)
    return {"launches": daemon_launches, "precision": precision}


def tools_phase(smi: str, trained: dict, files: dict) -> dict:
    """Phase 9, spectral contrast through the kernel's hybrid launch on every
    path, and the tools between training and serving; returns what the
    kernels' JSON line adds."""
    from cough_detector_tpu_torch.cli import audit as audit_cli
    from cough_detector_tpu_torch.cli import evaluate as evaluate_cli
    from cough_detector_tpu_torch.cli import export as export_cli
    from cough_detector_tpu_torch.cli import extract_segments as segments_cli
    from cough_detector_tpu_torch.cli import featurize as featurize_cli
    from cough_detector_tpu_torch.config import Config, FeatureConfig, TrainConfig
    from cough_detector_tpu_torch.data import BatchLoader, CoughDataset, ShardLoader, audio_io
    from cough_detector_tpu_torch.models import create_model, fold_batchnorm, init_weights
    from cough_detector_tpu_torch.models import export as model_export
    from cough_detector_tpu_torch.ops import frontend, frontend_kernel
    from cough_detector_tpu_torch.stream import StreamingDetector
    from cough_detector_tpu_torch.stream.detector import _load_checkpoint
    from cough_detector_tpu_torch.train import StepRandom, make_optimizer, train_step
    from cough_detector_tpu_torch.train.loop import make_feature_fns

    t_phase = time.perf_counter()
    dev = torch.device("cuda")
    contrast = FeatureConfig(use_spectral_contrast=True)
    base = dataclasses.replace(contrast, use_spectral_contrast=False)
    rng = np.random.default_rng(SEED + 9)
    root = Path(__file__).resolve().parent / "build" / "smoke_tools"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    best = str(trained["best_model"])
    seconds, launches = {}, {}

    def counted(name: str, fn):
        """fn() with the launch counters set to 0 just before and read just
        after into launches[name]."""
        frontend_kernel.SPECTRAL_LAUNCHES = frontend_kernel.EPILOGUE_LAUNCHES = 0
        frontend_kernel.CONTRAST_LAUNCHES = 0
        out = fn()
        torch.cuda.synchronize()
        launches[name] = {
            "spectral": frontend_kernel.SPECTRAL_LAUNCHES, "epilogue": frontend_kernel.EPILOGUE_LAUNCHES,
            "contrast": frontend_kernel.CONTRAST_LAUNCHES,
        }
        return out

    # The paths on the contrast config run all three launches; the others,
    # on the shipped config, the pair alone.
    contrast_paths = ("hybrid_b256", "hybrid_b1024", "train_steps", "tick", "scores_replay", "featurize",
                      "contrast_program")

    def once_each(name: str, n: int = 1) -> None:
        want = {"spectral": n, "epilogue": n, "contrast": n if name in contrast_paths else 0}
        if launches[name] != want:
            fail(f"{name}: front-end launches {launches[name]}, not {want}")

    # -- 9.1 the hybrid at B = 256 and 1024 against the torch chain's four
    # contrast variants, and its first 256 clips against the CPU (phase 4
    # times it)
    t0 = time.perf_counter()
    tf32_before = torch.backends.cuda.matmul.allow_tf32
    for b in (256, 1024):
        w = torch.from_numpy(make_audio(rng, b, SR)).to(dev)
        got = counted(f"hybrid_b{b}", lambda: frontend_kernel.extract_features_fused(w, contrast))
        once_each(f"hybrid_b{b}")
        chain_rows = frontend.extract_features(w, base)
        errs, row_errs = {}, {}
        for method, tails in itertools.product(("fft", "gemm"), ("select", "rank")):
            rows = frontend.spectral_contrast(w, contrast, method=method, tails=tails).transpose(1, 2)
            errs[f"{method}/{tails}"] = rel_err(got, torch.cat([chain_rows, rows], dim=1))
            row_errs[f"{method}/{tails}"] = rel_err(got[:, base.num_features :], rows)
        cpu_err = rel_err(got[:256].cpu(), frontend_kernel.extract_features_fused(w[:256].cpu(), contrast))
        print(
            f"contrast hybrid at B={b} (shape {tuple(got.shape)}; launches {launches[f'hybrid_b{b}']}): "
            f"vs the torch chain max-relative {', '.join(f'{k} {v:.3e}' for k, v in errs.items())}; its contrast "
            f"rows alone vs each variant's {', '.join(f'{k} {v:.3e}' for k, v in row_errs.items())}; the first 256 vs the CPU "
            f"{cpu_err:.3e} (limits 1e-3)",
            flush=True,
        )
        if not (max(errs.values()) <= TOL and cpu_err <= TOL and got.shape == (b, 97, 101)):
            fail(f"the contrast hybrid disagrees with the torch chain or the CPU at B={b}")
    if torch.backends.cuda.matmul.allow_tf32 != tf32_before:
        fail("the gemm contrast left cuBLAS's TF32 flag changed")
    seconds["9.1 hybrid checks"] = time.perf_counter() - t0

    # -- 9.2 a contrast-config residual: 8 train steps on phase 6's shards,
    # a detector tick card vs CPU, cli.featurize on 16 clips
    t0 = time.perf_counter()
    cfg_c = Config(features=contrast)
    model = init_weights(create_model("residual"), torch.Generator().manual_seed(SEED)).to(dev)
    opt = make_optimizer(model.parameters(), cfg_c.train, 64)
    feature_fn, _ = make_feature_fns(cfg_c, dev, use_time_shift=True)
    loader = ShardLoader(str(trained["shards"] / "train"), TrainConfig().batch_size, shuffle=True, seed=SEED,
                         feature_config=contrast)
    batches = list(itertools.islice(iter(loader), 8))
    cw = torch.ones(2, device=dev)
    rand = StepRandom(dev)

    def train8():
        return [
            train_step(model, opt, torch.from_numpy(x).to(dev), torch.from_numpy(y.astype(np.int64)).to(dev), cw,
                       rand.key(SEED, 0, s), feature_fn=feature_fn)["loss"].item()
            for s, (x, y) in enumerate(batches)
        ]

    losses = counted("train_steps", train8)
    once_each("train_steps", 8)
    state = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    window_audio = make_audio(rng, 16, SR)
    det = StreamingDetector(variables=state, config=cfg_c, device="cuda", num_streams=16, chunk_size=SR,
                            confidence_threshold=0.0)
    events = counted("tick", lambda: det.collect_events(det.tick_async(window_audio)))
    once_each("tick")
    card_p = det.scores_for(window_audio)
    replayed = counted("scores_replay", lambda: det.scores_for(window_audio))  # its program's first replay
    once_each("scores_replay")
    cpu_p = StreamingDetector(variables=state, config=cfg_c, device="cpu", num_streams=16).scores_for(window_audio)
    tick_err = float(np.abs(card_p - cpu_p).max())
    clips = root / "clips16"
    data = files["data"]
    for sub in ("cough", "non_cough"):
        (clips / sub).mkdir(parents=True)
        for p in sorted((data / sub).glob("*.wav"))[:8]:
            (clips / sub / p.name).symlink_to(p)
    (root / "contrast.json").write_text(cfg_c.to_json())
    report = json.loads(counted("featurize", lambda: run_cli(featurize_cli.main, [
        "--data-dir", str(clips), "--output", str(root / "contrast.npz"), "--batch-size", "16",
        "--num-workers", "4", "--config", str(root / "contrast.json"),
    ], echo=False)).strip().splitlines()[-1])
    once_each("featurize")
    feats = np.load(root / "contrast.npz")["features"]
    first, _ = next(iter(BatchLoader(CoughDataset(str(clips)), 16, contrast, num_workers=4)))
    want = frontend.extract_features(frontend.peak_normalize(torch.from_numpy(first)), contrast)
    feat_err = rel_err(torch.from_numpy(feats), want)
    print(
        f"contrast residual (97x101 features): 8 train steps on phase 6's shards, losses "
        f"{[round(v, 4) for v in losses]}, launches {launches['train_steps']}; one 16-stream tick, "
        f"{len(events)} events at threshold 0, launches {launches['tick']}, scores card vs CPU max abs "
        f"{tick_err:.3e} (limit 1e-3), a replay of the scoring program bit-equal {np.array_equal(replayed, card_p)} "
        f"(launches {launches['scores_replay']}); cli.featurize --config on 16 clips: shape "
        f"{report['feature_shape']}, launches {launches['featurize']}, vs the CPU chain max-relative "
        f"{feat_err:.3e} (limit 1e-3)",
        flush=True,
    )
    if not (np.isfinite(losses).all() and tick_err <= TOL and feat_err <= TOL and len(events) == 16
            and report["feature_shape"] == [97, 101] and np.array_equal(replayed, card_p)):
        fail("the contrast residual's paths disagree with the CPU")
    seconds["9.2 contrast residual"] = time.perf_counter() - t0

    # The contrast residual's serving function traced by torch.export on the
    # card: the three launches as custom-op nodes, the loaded program
    # against eager at B = 256. Budget 6 s.
    t0 = time.perf_counter()
    serving_c = model_export.make_serving_fn(state, cfg_c, "cuda")
    program_c = model_export.aot_compile(serving_c, 256)
    ops_c = [op for op in ("cdt.power_mel", "cdt.mel_epilogue", "cdt.spectral_contrast")
             if op in model_export.graph_text(program_c)]
    loaded_c = model_export.load_serialized(model_export.export_serialized(program_c, str(root / "contrast.pt2")))
    w = torch.from_numpy(make_audio(rng, 256, SR)).to(dev)
    with torch.no_grad():
        got = counted("contrast_program", lambda: loaded_c(w))
        want = serving_c(w)
    once_each("contrast_program")
    program_c_err = float((got - want).abs().max())
    print(
        f"contrast residual's serving program (torch.export, B=256): custom ops in the graph {ops_c}, launches "
        f"{launches['contrast_program']}, vs the eager serving function max abs {program_c_err:.3e} (limit 1e-6)",
        flush=True,
    )
    if not (program_c_err <= 1e-6 and len(ops_c) == 3):
        fail("the contrast config's exported program disagrees with the eager serving function")
    seconds["9.2 contrast program"] = time.perf_counter() - t0

    # -- 9.3 cli.evaluate on phase 6's trained checkpoint: dataset mode on its
    # 256 validation clips card vs CPU, --behavioral, --calibrate
    t0 = time.perf_counter()
    val = str(trained["shards"] / "val")
    summaries = {}
    for where in ("cuda", "cpu"):
        out = counted(f"evaluate_{where}", lambda: run_cli(evaluate_cli.main, [
            "--model", best, "--data-dir", val, "--device", where,
        ], echo=False))
        summaries[where] = json.loads(out.strip().splitlines()[-1])
    once_each("evaluate_cuda")
    card, cpu = summaries["cuda"], summaries["cpu"]
    counts_equal = all(card[k] == cpu[k] for k in ("tp", "fp", "fn", "tn"))
    loss_err = abs(card["loss"] - cpu["loss"])
    print(
        f"cli.evaluate --data-dir (256 validation shards): card {json.dumps(card)}; counts equal the CPU run's "
        f"{counts_equal}, loss difference {loss_err:.3e} (limit 1e-4); launches {launches['evaluate_cuda']}",
        flush=True,
    )
    if not (counts_equal and loss_err <= 1e-4 and card["tp"] + card["fp"] + card["fn"] + card["tn"] == 256):
        fail("cli.evaluate on the card disagrees with the CPU")
    seconds["9.3 evaluate dataset"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    behavioral = json.loads(counted("behavioral", lambda: run_cli(evaluate_cli.main, [
        "--model", best, "--behavioral", "--minutes", "0.5",
    ], echo=False)).strip().splitlines()[-1])
    seconds["9.3 evaluate --behavioral"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    calibrated = json.loads(counted("calibrate", lambda: run_cli(evaluate_cli.main, [
        "--model", best, "--calibrate", "--minutes", "0.5",
    ], echo=False)).strip().splitlines()[-1])
    seconds["9.3 evaluate --calibrate"] = time.perf_counter() - t0
    print(
        f"cli.evaluate --behavioral --minutes 0.5: {json.dumps({k: v for k, v in behavioral.items() if k != 'targets'})} "
        f"(launches {launches['behavioral']}); --calibrate: self-check '{calibrated['self_check']}', passing band "
        f"{calibrated['passing_band']}, strict {calibrated['passing_band_strict']}, recommended threshold "
        f"{calibrated['recommended_threshold']} over {len(calibrated['sweep'])} thresholds (launches "
        f"{launches['calibrate']})",
        flush=True,
    )
    behavioral_pair = [launches["behavioral"][k] for k in ("spectral", "epilogue")]
    if len(calibrated["sweep"]) != 19 or min(behavioral_pair) < 1 or launches["behavioral"]["contrast"]:
        fail("cli.evaluate's behavioral modes did not run through the kernels")

    # -- 9.4 cli.audit on phase 7's directory plus three planted clips
    t0 = time.perf_counter()
    audit_dir = root / "audit"
    for sub in ("cough", "non_cough"):
        (audit_dir / sub).mkdir(parents=True)
        for p in sorted((data / sub).glob("*.wav")):
            (audit_dir / sub / p.name).symlink_to(p)
    planted = {
        "planted_silent.wav": (np.zeros(2 * SR, np.float32), "silent"),
        "planted_clipped.wav": (np.clip(rng.standard_normal(2 * SR) * 2, -1, 1).astype(np.float32), "clipped"),
        "planted_dc.wav": ((0.4 + 0.05 * rng.standard_normal(2 * SR)).astype(np.float32), "dc_offset"),
    }
    for name, (wave, _) in planted.items():
        audio_io.write_wav(audit_dir / "cough" / name, wave, SR)
    out = counted("audit", lambda: run_cli(audit_cli.main, [
        "--data-dir", str(audit_dir), "--model", best, "--report", str(root / "audit.jsonl"),
    ], echo=False))
    audit_counts = json.loads(out.strip().splitlines()[-2])
    recs = {Path(r["path"]).name: r for r in map(json.loads, (root / "audit.jsonl").read_text().splitlines())}
    flagged = {name: flag in recs[name]["flags"] for name, (_, flag) in planted.items()}
    n_audit_batches = -(-audit_counts["total"] // 256)
    print(
        f"cli.audit --model ({audit_counts['total']} clips, {n_audit_batches} batches; launches {launches['audit']}): "
        f"{json.dumps(audit_counts)}; planted clips flagged {flagged}",
        flush=True,
    )
    if not all(flagged.values()):
        fail("cli.audit missed a planted clip")
    once_each("audit", n_audit_batches)
    seconds["9.4 audit"] = time.perf_counter() - t0

    # -- 9.5 cli.extract_segments --mode energy on phase 7's 10-minute recording
    t0 = time.perf_counter()
    rec_dir = root / "recordings"
    rec_dir.mkdir()
    (rec_dir / "recording.wav").symlink_to(files["recording"])
    kept, seg_reports = {}, {}
    for where in ("cuda", "cpu"):
        out_dir = root / f"segments_{where}"
        seg_reports[where] = json.loads(counted(f"segments_{where}", lambda: run_cli(segments_cli.main, [
            "--input-dir", str(rec_dir), "--output-dir", str(out_dir), "--mode", "energy", "--threshold-db", "-20",
            "--model", best, "--min-confidence", "0.5", "--device", where,
        ], echo=False)).strip().splitlines()[-1])
        kept[where] = sorted(p.name for p in out_dir.glob("*.wav"))
    wave = audio_io.load_mono_16k(files["recording"])
    spans = segments_cli.find_energy_bursts(wave, SR, -20.0)
    n_seg_batches = -(-len(spans) // segments_cli.SCORE_BATCH)
    print(
        f"cli.extract_segments --mode energy --threshold-db -20 --model --min-confidence 0.5 on the 10-minute "
        f"recording: "
        f"{seg_reports['cuda']['candidates']} candidates (first at "
        f"{[round(lo / SR, 3) for lo, _ in spans[:5]]} s), {seg_reports['cuda']['written']} kept on the card, "
        f"{seg_reports['cpu']['written']} on the CPU; the same files {kept['cuda'] == kept['cpu']}; launches "
        f"{launches['segments_cuda']}",
        flush=True,
    )
    if kept["cuda"] != kept["cpu"] or seg_reports["cuda"]["candidates"] != len(spans):
        fail("cli.extract_segments on the card keeps other segments than on the CPU")
    once_each("segments_cuda", n_seg_batches)
    seconds["9.5 extract_segments"] = time.perf_counter() - t0

    # -- 9.6 cli.export --pt --program --fold-bn; the .pt2 loaded on the card
    t0 = time.perf_counter()
    exported = root / "export"
    run_cli(export_cli.main, [
        "--model", best, "--output-dir", str(exported), "--pt", "--program", "--fold-bn", "--batch-size", "256",
    ], echo=False)
    seconds["9.6 export"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    loaded = model_export.load_serialized(str(exported / "serving.pt2"))
    variables, config = _load_checkpoint(best)
    eager = model_export.make_serving_fn(fold_batchnorm(variables, config.model.model_type), config)
    w = torch.from_numpy(make_audio(rng, 256, SR)).to(dev)
    with torch.no_grad():
        got = counted("exported_program", lambda: loaded(w))
        want = eager(w)
    once_each("exported_program")
    export_err = float((got - want).abs().max())
    pt_err = float(np.abs(StreamingDetector(str(exported / "model.pt")).scores_for(w) - want[:, 1].cpu().numpy()).max())
    graph = (exported / "serving.graph.txt").read_text()
    ops_in_graph = [op for op in ("cdt.power_mel", "cdt.mel_epilogue") if op in graph]
    with torch.no_grad():
        program_ms = cuda_ms(lambda: loaded(w), 20)
        eager_ms = cuda_ms(lambda: eager(w), 20)
    print(
        f"[{smi}] cli.export --pt --program --fold-bn: serving.pt2 loaded on the card at B=256 vs the eager serving "
        f"function max abs {export_err:.3e} (limit 1e-6), launches {launches['exported_program']}, custom ops in "
        f"the graph {ops_in_graph}; model.pt served by StreamingDetector vs eager max abs {pt_err:.3e}; CUDA events: "
        f"program {program_ms:.4f} ms, eager {eager_ms:.4f} ms",
        flush=True,
    )
    if not (export_err <= 1e-6 and pt_err <= 1e-6 and len(ops_in_graph) == 2):
        fail("the exported program disagrees with the eager serving function")
    seconds["9.6 exported program"] = time.perf_counter() - t0

    total = time.perf_counter() - t_phase
    print(
        "tools phase by sub-step (s): " + ", ".join(f"{k} {v:.3f}" for k, v in seconds.items())
        + f"; phase total {total:.3f} s (budget 35 s)",
        flush=True,
    )
    return {"launches": launches, "seconds": total}


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def parallel_phase(smi: str, trained: dict, files: dict) -> dict:
    """Phase 10, training and scoring across ranks and devices (budget 45 s,
    under build/smoke_parallel/); returns what the kernels' JSON line adds."""
    import torch.distributed as dist
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from cough_detector_tpu_torch import parallel
    from cough_detector_tpu_torch.cli import evaluate as evaluate_cli
    from cough_detector_tpu_torch.cli import featurize as featurize_cli
    from cough_detector_tpu_torch.cli import train as train_cli
    from cough_detector_tpu_torch.data import ShardLoader, audio_io, dequantize, pack_arrays
    from cough_detector_tpu_torch.ops import frontend_kernel
    from cough_detector_tpu_torch.stream import StreamingDetector, offline
    from cough_detector_tpu_torch.stream.detector import _load_checkpoint
    from cough_detector_tpu_torch.train import checkpoint

    t_phase = time.perf_counter()
    root = Path(__file__).resolve().parent / "build" / "smoke_parallel"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    shards, best = trained["shards"], str(trained["best_model"])
    n_train, n_val, bs = 2048, 256, 32
    steps_per_run = {1: n_train // bs + -(-n_val // bs)}  # train + eval steps an epoch
    steps_per_run[2] = 2 * steps_per_run[1]
    seconds, launches = {}, {}
    skip = {"train_clips_per_sec", "val_clips_per_sec", "wall_s", "t"}

    def counted(name: str, fn):
        frontend_kernel.SPECTRAL_LAUNCHES = frontend_kernel.EPILOGUE_LAUNCHES = 0
        out = fn()
        torch.cuda.synchronize()
        launches[name] = {"spectral": frontend_kernel.SPECTRAL_LAUNCHES, "epilogue": frontend_kernel.EPILOGUE_LAUNCHES}
        return out

    def each(name: str, n: int) -> None:
        if set(launches[name].values()) != {n}:
            fail(f"{name}: front-end launches {launches[name]}, not {n} of each")

    def train_argv(out: str, *extra: str, epochs: int = 2, corpus: Path = shards) -> list:
        return ["--shards", str(corpus), "--output-dir", out, "--model-type", "residual",
                "--epochs", str(epochs), "--batch-size", str(bs), *extra]

    def trained_in_process(name: str, out: Path, *extra: str, epochs: int = 2, corpus: Path = shards) -> str:
        argv = train_argv(str(out), *extra, epochs=epochs, corpus=corpus)
        return counted(name, lambda: run_cli(train_cli.main, argv, echo=False))

    def records(out: Path) -> list:
        return [json.loads(line) for line in (out / "metrics.jsonl").read_text().splitlines()]

    def same_run(a: Path, b: Path) -> bool:
        """Bit-equal best and latest checkpoints (parameters, moments) and
        metrics.jsonl records."""
        for name in ("best_model", "latest_model"):
            ta, tb = (checkpoint.load_checkpoint(str(o / name))[0] for o in (a, b))
            if any(not torch.equal(tb["model"][k], v) for k, v in ta["model"].items()):
                return False
            pairs = zip(ta["optimizer"]["mu"] + ta["optimizer"]["nu"], tb["optimizer"]["mu"] + tb["optimizer"]["nu"])
            if not all(torch.equal(x, y) for x, y in pairs):
                return False
        strip = lambda rs: [{k: v for k, v in r.items() if k not in skip} for r in rs]  # noqa: E731
        return strip(records(a)) == strip(records(b))

    def step_ms(out: Path, pipelined: bool = False) -> float:
        """The batch-32 step's ms from epoch 1's record: a synchronous run's
        train pass over its steps; a pipelined run's wall_s delta over its
        train and eval steps (its rates denominate over a window that holds
        epoch 0's tail)."""
        r = records(out)
        if pipelined:
            return (r[-1]["wall_s"] - r[-2]["wall_s"]) / steps_per_run[1] * 1e3
        return bs / r[-1]["train_clips_per_sec"] * 1e3

    def probes(text: str, pattern: str) -> list:
        return [m.groups() for m in re.finditer(pattern, text)]

    def idle_share(fn):
        """fn() under torch.profiler, a training run of one epoch: (its
        result, the device's idle share over its "cdt.epoch" range)."""
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            out = fn()
        events = prof.events()
        span = [e for e in events if e.device_type == DeviceType.CPU and e.name == "cdt.epoch"]
        if len(span) != 1:
            return out, None
        lo, hi = span[0].time_range.start, span[0].time_range.end
        return out, 1 - busy_ms(events, lo, hi) / ((hi - lo) / 1e3)

    def probed(fn):
        """fn() with the CDT_DEBUG_STEP_METRICS probes (train/loop.py) on:
        the checks of the ranks read them. They copy every batch to the host
        a step, so no run whose time is reported takes them."""
        os.environ["CDT_DEBUG_STEP_METRICS"] = "1"
        try:
            return fn()
        finally:
            os.environ.pop("CDT_DEBUG_STEP_METRICS", None)

    def blocking(key: str, label: str, fn):
        """fn, noting (label, ms) of each call, the time it holds the
        caller, in saves_ms[key]."""
        def run(*args, **kwargs):
            t = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                saves_ms[key].append((label, (time.perf_counter() - t) * 1e3))
        return run

    # -- 10.a the plain trainer, then NCCL at world size 1 through cli.train --distributed.
    # The plain run's saves go through the background writer: the seconds
    # the loop's thread spends queueing them and draining the writer are
    # held against the synchronous saves' in 10.d.
    t0 = time.perf_counter()
    saves_ms = {"background": [], "synchronous": []}
    submit, drain = checkpoint._submit, checkpoint.drain_pending_saves
    checkpoint._submit = blocking("background", "queue", submit)
    checkpoint.drain_pending_saves = blocking("background", "drain", drain)
    try:
        trained_in_process("plain", root / "plain")
    finally:
        checkpoint._submit, checkpoint.drain_pending_saves = submit, drain
    each("plain", steps_per_run[2])
    seconds["10.a plain trainer"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    torchrun_env = {"RANK": "0", "WORLD_SIZE": "1", "LOCAL_RANK": "0", "LOCAL_WORLD_SIZE": "1",
                    "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(free_port())}
    os.environ.update(torchrun_env)
    try:
        nccl_graphed = "Steps: captured CUDA graphs" in trained_in_process("nccl_world1", root / "nccl", "--distributed")
        if dist.is_initialized():
            fail("cli.train --distributed left its process group initialized")
        # The routed gather at world size 1 (NCCL's reduce-scatter) vs index_select.
        os.environ["MASTER_PORT"] = str(free_port())
        if not parallel.maybe_initialize_distributed() or dist.get_backend() != "nccl":
            fail("maybe_initialize_distributed did not join an NCCL group on the card")
        val_d = torch.from_numpy(ShardLoader(str(shards / "val"), bs).corpus()).cuda()
        idx = torch.from_numpy(np.random.default_rng(SEED).integers(0, n_val, bs)).cuda()
        gather_ok = torch.equal(parallel.routed_gather(val_d, idx, parallel.process_group()),
                                val_d.index_select(0, idx))
        dist.destroy_process_group()
    finally:
        for k in torchrun_env:
            os.environ.pop(k, None)
    nccl_same = same_run(root / "plain", root / "nccl")
    each("nccl_world1", steps_per_run[2])
    print(
        f"[{smi}] NCCL at world size 1 (cli.train --distributed, 2 epochs of phase 6's corpus): bit-equal to the "
        f"plain trainer (best and latest checkpoints, moments, metrics.jsonl with its losses) {nccl_same}; routed "
        f"gather vs index_select {gather_ok}; launches {launches['nccl_world1']} (steps {steps_per_run[2]}); "
        f"steps on captured graphs, the NCCL all-reduces inside them {nccl_graphed}",
        flush=True,
    )
    if not (nccl_same and gather_ok and nccl_graphed):
        fail("NCCL at world size 1 does not reproduce the plain trainer")
    seconds["10.a NCCL world 1"] = time.perf_counter() - t0

    # -- 10.b two ranks on cuda:0 over gloo, the corpus sharded by rows, in
    # two pairs side by side. On phase 6's whole corpus (one epoch of 72
    # steps: the ranks' eager, host-staged steps are the phase's longest
    # path, and every check below holds on one epoch) the inputs are held
    # exact: each rank's rows by CRC, the epochs' batch matrices, the rows
    # built, the launches, rank 0 alone
    # writing; and the losses of the first 5 steps within rtol 1e-5. Later
    # losses drift apart by summation order, as any reordered sum does, one
    # process with BatchNorm's two-pass sums in place of cuDNN's too: Adam's
    # early steps move a weight by the learning rate whatever its gradient's
    # size, so a sign that rounding flips moves it the other way
    # (tools/rank_drift_probe.py). The epochs' counts and losses are held on
    # the second pair, the first 64 + 32 clips (2 + 1 steps an epoch), the
    # geometry of tests/test_distributed.py's problem, whose bounds these are.
    t0 = time.perf_counter()
    sub = root / "corpus_96"
    for split, n in (("train", 64), ("val", 32)):
        loader = ShardLoader(str(shards / split), bs)
        pack_arrays(dequantize(loader.corpus()[:n]), loader._labels[:n], str(sub / split))
    budgets = {"gloo": 40 << 20, "gloo_96": 2 << 20}  # past one device's budget, within two's
    corpora = {"gloo": shards, "gloo_96": sub}
    pair_epochs = {"gloo": 1, "gloo_96": 2}
    procs, logs = [], []
    for name in ("gloo", "gloo_96"):
        port = free_port()
        for r in range(2):
            env = dict(os.environ, CDT_DEBUG_STEP_METRICS="1")
            env.update({"RANK": str(r), "WORLD_SIZE": "2", "LOCAL_RANK": str(r), "LOCAL_WORLD_SIZE": "2",
                        "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port)})
            logs.append(open(root / f"{name}_rank{r}.log", "w"))
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "cough_detector_tpu_torch.cli.train", "--distributed",
                 "--dist-backend", "gloo", "--device", "cuda:0", "--device-corpus-budget", str(budgets[name]),
                 *train_argv(str(root / name), epochs=pair_epochs[name], corpus=corpora[name])],
                cwd=Path(__file__).resolve().parent, env=env, stdout=logs[-1], stderr=subprocess.STDOUT,
            ))
    done_at = {}
    try:
        # The one-process references with the probes on, while the ranks start.
        plain_out = probed(lambda: trained_in_process("plain_probed", root / "plain_probed", epochs=1))
        plain_sub = probed(lambda: trained_in_process("plain_96", root / "plain_96", corpus=sub))
        done_at["references"] = time.perf_counter() - t0
        deadline = time.monotonic() + 300
        for i in (2, 3, 0, 1):  # the slice's pair, then the whole corpus's
            procs[i].wait(timeout=max(1.0, deadline - time.monotonic()))
            done_at["64 + 32 pair" if i == 3 else "whole-corpus pair"] = time.perf_counter() - t0
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in logs:
            f.close()
    if any(p.returncode != 0 for p in procs):
        fail("a gloo rank failed: " + " | ".join(
            (root / f"{n}_rank{r}.log").read_text()[-3000:] for n in ("gloo", "gloo_96") for r in range(2)))
    row_pat, mats_pat = r"ROW_HASHES lo=(\d+) (\[.*\])", r"SCAN_MATS epoch=(\d+) crc=(\d+)"
    built_pat = r"Input rows built \(rank \d+\): train (\d+), val (\d+)"
    loss_pat = r"STEP_LOSSES epoch=(\d+) (\[.*\])"
    exact = ("tp", "fp", "fn", "tn", "train_acc", "val_acc", "precision", "recall", "f1")
    pairs = {}
    for name, ref, ref_dir, n_steps in (("gloo", plain_out, "plain_probed", steps_per_run[1]),
                                        ("gloo_96", plain_sub, "plain_96", 6)):
        ranks = [(root / f"{name}_rank{r}.log").read_text() for r in range(2)]
        want_rows = probes(ref, row_pat)
        rows_ok = bool(want_rows)
        for text in ranks:
            got = probes(text, row_pat)
            rows_ok &= len(got) == len(want_rows) and all(
                json.loads(full)[int(lo) : int(lo) + len(json.loads(part))] == json.loads(part)
                for (_, full), (lo, part) in zip(want_rows, got)
            )
        built = [tuple(map(int, probes(t, built_pat)[0])) for t in [ref] + ranks]
        s0, d0 = (np.array(json.loads(probes(t, loss_pat)[0][1])) for t in (ref, ranks[0]))
        step_errs = np.abs(d0 - s0) / np.abs(s0) if len(d0) == len(s0) else np.array([np.inf])
        recs_s, recs_d = records(root / ref_dir), records(root / name)
        rank_launches = [tuple(map(int, probes(t, r"KERNEL_LAUNCHES rank=\d+ spectral=(\d+) epilogue=(\d+)")[0]))
                         for t in ranks]
        for r, n in enumerate(rank_launches):
            launches[f"{name}_rank{r}"] = {"spectral": n[0], "epilogue": n[1]}
        pairs[name] = {
            "sharded": all("sharded by rows over 2 ranks" in t for t in ranks),
            "eager_steps": all("Steps: eager (gloo's collectives cannot be captured)" in t for t in ranks),
            "rows": rows_ok,
            "mats": all(probes(t, mats_pat) == probes(ref, mats_pat) for t in ranks),
            "built": tuple(a + b for a, b in zip(built[1], built[2])) == built[0],
            "launches": all(n == (n_steps,) * 2 for n in rank_launches),
            "rank0_only": "Epoch 0" in ranks[0] and "Epoch 0" not in ranks[1] and sorted(
                p.name for p in (root / name).iterdir()) == sorted(p.name for p in (root / ref_dir).iterdir()),
            "step_errs": step_errs,
            "counts": len(recs_d) == pair_epochs[name] and all(rd[k] == rs[k] for rs, rd in zip(recs_s, recs_d) for k in exact),
            "epoch_err": max(abs(rd[k] - rs[k]) / abs(rs[k]) for rs, rd in zip(recs_s, recs_d)
                             for k in ("train_loss", "val_loss")),
            "built_rows": built, "rank_launches": rank_launches,
        }
    full, small = pairs["gloo"], pairs["gloo_96"]
    exact_checks = ("sharded", "eager_steps", "rows", "mats", "built", "launches", "rank0_only")
    gloo_ms = step_ms(root / "gloo")
    print(
        f"[{smi}] two ranks on cuda:0 over gloo (cli.train --distributed --dist-backend gloo, every step through "
        f"routed_gather), phase 6's 2048 + 256 clips, one epoch of {steps_per_run[1]} steps: "
        + ", ".join(f"{k} {full[k]}" for k in exact_checks)
        + f" (rows built {full['built_rows'][1]} + {full['built_rows'][2]} = {full['built_rows'][0]}; launches "
        f"{full['rank_launches']}, steps {steps_per_run[1]}); epoch-0 step losses relative, steps 0-4 "
        f"{np.array2string(full['step_errs'][:5], precision=3)} (limit 1e-5), all {len(full['step_errs'])} max "
        f"{full['step_errs'].max():.3e}; epoch losses max-relative {full['epoch_err']:.3e}, counts equal "
        f"{full['counts']} (summation order, not held); the first 64 + 32 clips, 6 steps: "
        + ", ".join(f"{k} {small[k]}" for k in exact_checks)
        + f"; step losses relative {np.array2string(small['step_errs'], precision=3)} (limit 1e-5), "
        f"counts/accuracy/F1 exact {small['counts']}, epoch losses max-relative {small['epoch_err']:.3e} "
        f"(limit 1e-3); done after (s) " + ", ".join(f"{k} {v:.3f}" for k, v in done_at.items()),
        flush=True,
    )
    if not (all(full[k] and small[k] for k in exact_checks) and full["step_errs"][:5].max() <= 1e-5
            and small["step_errs"].max() <= 1e-5 and small["counts"] and small["epoch_err"] <= 1e-3):
        fail("two ranks over gloo do not reproduce the one-process run")
    seconds["10.b two ranks over gloo"] = time.perf_counter() - t0

    # -- 10.c chunked windows against the resident corpus, one process
    # (1 epoch, then a resume to 2 through the background writer)
    t0 = time.perf_counter()
    chunk_budget = 16_384_000  # windows of 8 steps: 8 an epoch, 1 for validation
    chunked = ("--device-corpus", "chunked", "--device-corpus-budget", str(chunk_budget))
    trained_in_process("chunked", root / "chunked", *chunked, epochs=1)
    each("chunked", steps_per_run[1])
    # The resumed epoch under torch.profiler, and one more resident epoch
    # resumed in a copy of the plain run.
    _, chunk_idle = idle_share(lambda: trained_in_process(
        "chunked_resume", root / "chunked", *chunked, "--resume", str(root / "chunked" / "latest_model")))
    each("chunked_resume", steps_per_run[1])
    chunked_same = same_run(root / "plain", root / "chunked")
    chunk_wall = records(root / "chunked")[0]["wall_s"]
    plain_recs = records(root / "plain")
    plain_wall = plain_recs[0]["wall_s"]
    shutil.copytree(root / "plain", root / "plain_profiled")
    _, plain_idle = idle_share(lambda: run_cli(train_cli.main, train_argv(
        str(root / "plain_profiled"), "--resume", str(root / "plain_profiled" / "latest_model"), epochs=3),
        echo=False))
    fmt = lambda v: "not measured" if v is None else f"{v:.3f}"  # noqa: E731
    print(
        f"[{smi}] chunked windows (budget {chunk_budget} bytes: 8 windows of 8 steps an epoch, each uploaded on a "
        f"side stream while the window before runs), 1 epoch + a resume to 2: bit-equal to the resident run "
        f"{chunked_same}; epoch-0 wall {chunk_wall:.3f} s chunked, {plain_wall:.3f} s resident; device idle share "
        f"over a profiled epoch {fmt(chunk_idle)} chunked, {fmt(plain_idle)} resident (the probes off)",
        flush=True,
    )
    if not chunked_same:
        fail("chunked windows do not reproduce the resident run")
    seconds["10.c chunked"] = time.perf_counter() - t0

    # -- 10.d the checkpoint writer: the background thread against synchronous saves
    t0 = time.perf_counter()
    # each save committed at once, on the loop's thread
    checkpoint._submit = blocking("synchronous", "save", lambda fn: fn())
    checkpoint.drain_pending_saves = blocking("synchronous", "drain", drain)
    try:
        trained_in_process("sync_saves", root / "sync")
    finally:
        checkpoint._submit, checkpoint.drain_pending_saves = submit, drain
    sync_same = same_run(root / "plain", root / "sync")
    sync_recs = records(root / "sync")
    walls = {
        "background": [plain_recs[0]["wall_s"], plain_recs[1]["wall_s"] - plain_recs[0]["wall_s"]],
        "synchronous": [sync_recs[0]["wall_s"], sync_recs[1]["wall_s"] - sync_recs[0]["wall_s"]],
    }
    print(
        f"[{smi}] checkpoint writes over 2 epochs (the probes off): the loop's thread held by saves "
        + "; ".join(f"{k} {sum(ms for _, ms in v):.3f} ms (" + ", ".join(f"{n} {ms:.3f}" for n, ms in v) + ")"
                    for k, v in saves_ms.items())
        + " (the drains: before each epoch's snapshot and before train() returns); epoch walls "
        "(metrics.jsonl; epoch 1's holds epoch 0's saves; the background run is the phase's first) "
        + "; ".join(f"{k} {v[0]:.3f} s, {v[1]:.3f} s" for k, v in walls.items())
        + f"; the synchronous run bit-equal to the background one {sync_same}; the resumed chunked run above went "
        f"through the background writer",
        flush=True,
    )
    if not sync_same:
        fail("synchronous checkpoint saves change the run")
    seconds["10.d checkpoint writer"] = time.perf_counter() - t0
    plain_ms, nccl_ms = step_ms(root / "plain", True), step_ms(root / "nccl", True)
    print(
        f"[{smi}] train step at batch 32 (metrics.jsonl, epoch 1; the one-process runs pipelined: wall_s delta over "
        f"the epoch's train and eval steps): plain {plain_ms:.4f} ms, NCCL at world size 1 "
        f"{nccl_ms:.4f} ms (both with the probes off), two ranks on one card over gloo {gloo_ms:.4f} ms (epoch 0, "
        f"its only one; 16 rows a rank, phase 6's corpus, with the probes' copy of every batch to the host; gloo stages every collective "
        f"through host memory: its time is the host transport's, not NCCL's between cards)",
        flush=True,
    )

    # -- 10.e a mesh of ["cuda:0", "cuda:0"] against one device
    t0 = time.perf_counter()
    mesh = ["cuda:0", "cuda:0"]
    variables, config = _load_checkpoint(best)
    rng = np.random.default_rng(SEED + 10)
    audio = make_audio(rng, 256, 20 * CHUNK)
    detections = {}
    for name, m in (("detector_one", False), ("detector_mesh", mesh)):
        det = StreamingDetector(variables=variables, config=config, num_streams=256, chunk_size=CHUNK,
                                confidence_threshold=0.0, mesh=m)
        detections[name] = counted(name, lambda: det.process_chunk(audio))
    det_same, det_err = same_events(detections["detector_mesh"], detections["detector_one"], 1e-5)
    scoring_ticks = sum(windows_completed(20, CHUNK, SR, SR // 4))  # ticks that launch the kernels
    each("detector_mesh", 2 * scoring_ticks)
    wave = audio_io.load_mono_16k(files["recording"])
    events = {
        name: counted(name, lambda: offline.score_recording(wave, variables, config, threshold=0.5, mesh=m))
        for name, m in (("offline_one", False), ("offline_mesh", mesh))
    }
    off_same, off_err = same_events(
        [(0, *e) for e in events["offline_mesh"]], [(0, *e) for e in events["offline_one"]], 1e-5
    )
    n_windows = (len(wave) - SR) // (SR // 4) + 1
    each("offline_mesh", 2 * -(-n_windows // 1024))
    val = str(shards / "val")
    summaries = {
        name: json.loads(counted(name, lambda: run_cli(evaluate_cli.main, ["--model", best, "--data-dir", val, *flag],
                                                       echo=False)).strip().splitlines()[-1])
        for name, flag in (("evaluate_one", ["--single-device"]), ("evaluate_mesh", ["--mesh", ",".join(mesh)]))
    }
    eval_same = all(summaries["evaluate_mesh"][k] == summaries["evaluate_one"][k] for k in ("tp", "fp", "fn", "tn"))
    each("evaluate_mesh", 2)
    clips = root / "clips16"
    for sub in ("cough", "non_cough"):
        (clips / sub).mkdir(parents=True)
        for p in sorted((files["data"] / sub).glob("*.wav"))[:8]:
            (clips / sub / p.name).symlink_to(p)
    feats = {}
    for name, flag in (("featurize_one", []), ("featurize_mesh", ["--mesh", ",".join(mesh)])):
        counted(name, lambda: run_cli(featurize_cli.main, [
            "--data-dir", str(clips), "--output", str(root / f"{name}.npz"), "--num-workers", "4", *flag,
        ], echo=False))
        feats[name] = np.load(root / f"{name}.npz")["features"]
    feat_err = float(np.abs(feats["featurize_mesh"] - feats["featurize_one"]).max())
    each("featurize_mesh", 2)
    print(
        f"[{smi}] a mesh of {mesh} against one device: 256 detector streams x 20 ticks, {len(detections['detector_one'])} "
        f"events equal {det_same} (confidences max abs {det_err:.3e}, limit 1e-5; launches {launches['detector_mesh']}); "
        f"the 10-minute recording through score_recording: {len(events['offline_one'])} events equal {off_same} "
        f"(max abs {off_err:.3e}, limit 1e-5; launches {launches['offline_mesh']}); cli.evaluate on the 256 validation "
        f"shards: counts equal {eval_same} ({json.dumps({k: summaries['evaluate_mesh'][k] for k in ('tp', 'fp', 'fn', 'tn')})}, "
        f"loss {summaries['evaluate_mesh']['loss']:.6f} vs {summaries['evaluate_one']['loss']:.6f}); cli.featurize on 16 "
        f"clips: max abs {feat_err:.3e} (limit 1e-6)",
        flush=True,
    )
    if not (det_same and detections["detector_one"] and off_same and eval_same and feat_err <= 1e-6):
        fail("a mesh of two devices does not score as one device")
    seconds["10.e mesh"] = time.perf_counter() - t0

    total = time.perf_counter() - t_phase
    print(
        "parallel phase by sub-step (s): " + ", ".join(f"{k} {v:.3f}" for k, v in seconds.items())
        + f"; phase total {total:.3f} s (budget 45 s)",
        flush=True,
    )
    return {
        "launches": launches, "seconds": total,
        "pair_96": {"out": root / "gloo_96", "corpus": corpora["gloo_96"], "budget": budgets["gloo_96"]},
        "step_ms": {"plain": plain_ms, "nccl_world1": nccl_ms, "gloo_two_ranks": gloo_ms},
        "epoch_wall_s": {"resident": plain_wall, "chunked": chunk_wall, **walls},
        "saves_block_ms": {k: sum(ms for _, ms in v) for k, v in saves_ms.items()},
        "idle_share": {"resident": plain_idle, "chunked": chunk_idle},
    }


def graphs_phase(smi: str, trained: dict, weights: dict, cfg) -> dict:
    """Phase 11, captured programs (budget 30 s, seconds printed by sub-step,
    under build/smoke_graphs/): on the card the tick and the train and eval
    steps run as CUDA graphs (utils/graphs.py); here each is held against its
    eager version on the card. The tick: a graphed and an eager 256-stream
    detector (the residual model at full width, phase 5's random weights,
    threshold 0) over 44 ticks of 1600 samples in float32, int16 and μ-law,
    with reset_streams at tick 15 and set_thresholds at tick 25: every
    tick's packed tensor bit-equal, events equal, both launch counters one
    a scoring tick, the graphs one a (dtype, fill) key; then p50 / p99 of
    tick_async + collect_events on the host clock over 2 x 20 ticks each,
    in turns, and the device's idle share over 20 ticks under the profiler.
    Training: train() for 2 epochs on phase 6's corpus on the graphs and
    eagerly: losses, parameters (BatchNorm statistics too) and Adam's
    moments bit-equal, 144 launches of each kernel each; each run's epoch
    walls, and the idle share over one more profiled epoch of each; the
    batch-32 step by CUDA events and the host clock over 30 steps, graphed
    and eager. Resume (phase 6), chunked windows and NCCL at world size 1
    (phase 10) run on the graphs in their own phases."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from cough_detector_tpu_torch.config import Config, FeatureConfig, TrainConfig
    from cough_detector_tpu_torch.data import ShardLoader
    from cough_detector_tpu_torch.models import create_model, init_weights
    from cough_detector_tpu_torch.ops import frontend_kernel
    from cough_detector_tpu_torch.serve.server import quantize_i16, quantize_mulaw
    from cough_detector_tpu_torch.stream import StreamingDetector, ring
    from cough_detector_tpu_torch.train import checkpoint, loop, steps

    t_phase = time.perf_counter()
    seconds = {}
    dev = torch.device("cuda")
    root = Path(__file__).resolve().parent / "build" / "smoke_graphs"
    shutil.rmtree(root, ignore_errors=True)
    rng = np.random.default_rng(SEED + 11)

    def launches() -> tuple:
        return frontend_kernel.SPECTRAL_LAUNCHES, frontend_kernel.EPILOGUE_LAUNCHES

    def zero_launches() -> None:
        frontend_kernel.SPECTRAL_LAUNCHES = frontend_kernel.EPILOGUE_LAUNCHES = 0

    # -- 11.1 the tick, graphed and eager
    t0 = time.perf_counter()
    n_streams, n_ticks = 256, 44
    audio = make_audio(rng, n_streams, n_ticks * CHUNK)
    quantizers = {"float32": lambda x: x, "int16": quantize_i16, "mulaw": quantize_mulaw}
    window, hop = cfg.features.segment_samples, SR // 4
    scoring = sum(windows_completed(n_ticks, CHUNK, window, hop))

    def detector(graphed: bool):
        det = StreamingDetector(variables=weights, config=cfg, device="cuda", num_streams=n_streams,
                                chunk_size=CHUNK, confidence_threshold=0.0)
        if not graphed:
            det._step = ring.make_stream_step(det._score_fn, cfg.features, det.stream_config, graphed=False)
        return det

    dets = {"graph": detector(True), "eager": detector(False)}

    def run(det, q) -> tuple:
        det.reset()
        out = []
        zero_launches()
        for t in range(n_ticks):
            if t == 15:
                det.reset_streams([3, 100, 255])
            if t == 25:
                det.set_thresholds([7, 200, 201], [1.1, 0.3, None])
            ev = det.tick_async(q(audio[:, t * CHUNK : (t + 1) * CHUNK]))
            out.append((ev["packed"].cpu().numpy(), det.collect_events(ev)))
        return out, launches()

    tick_ok, tick_launches = True, {}
    for fmt, q in quantizers.items():
        (g, g_n), (e, e_n) = run(dets["graph"], q), run(dets["eager"], q)
        same_packed = all(np.array_equal(a[0], b[0]) for a, b in zip(g, e))
        same_events = [a[1] for a in g] == [b[1] for b in e]
        n_events = sum(len(a[1]) for a in g)
        tick_launches[fmt] = {"graph": g_n, "eager": e_n}
        ok = same_packed and same_events and n_events > 0 and g_n == e_n == (scoring, scoring)
        tick_ok &= ok
        print(
            f"graphed tick [{fmt}] {n_streams} streams x {n_ticks} ticks (reset_streams at 15, set_thresholds at "
            f"25): packed bit-equal to the eager tick {same_packed}, events equal {same_events} ({n_events}); "
            f"launches graph {g_n}, eager {e_n}, expected {scoring} each",
            flush=True,
        )
    progs = dets["graph"].tick_programs()[0]
    fills = ring.tick_fills(CHUNK, window, hop)
    keys_ok = progs.graphed and len(progs.keys) == len(quantizers) * len(fills)
    replay_launches = [sum(v) for v in zip(*progs.launches().values())]
    print(
        f"graphed tick keys: {len(progs.keys)} ({len(fills)} fills x {len(quantizers)} dtypes; fills {fills}); "
        f"replays {sum(progs.replays().values())}, launches through replays (captured x replays) "
        f"{replay_launches}",
        flush=True,
    )
    if not (tick_ok and keys_ok):
        fail("the graphed tick differs from the eager tick, or its keys are not the predicted ones")

    lat = {"graph": [], "eager": []}
    for rep in range(2):
        for name, det in dets.items():
            for t in range(20):
                chunk = audio[:, (t % n_ticks) * CHUNK : (t % n_ticks + 1) * CHUNK]
                t1 = time.perf_counter()
                det.collect_events(det.tick_async(chunk))
                lat[name].append(time.perf_counter() - t1)
    idle = {}
    for name, det in dets.items():
        def span(det=det) -> float:
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            for t in range(20):
                det.collect_events(det.tick_async(audio[:, t * CHUNK : (t + 1) * CHUNK]))
            torch.cuda.synchronize()
            return (time.perf_counter() - t1) * 1e3

        plain_ms = span()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            span()
        busy = busy_ms(prof.events())
        idle[name] = None if busy == 0 else 1 - busy / plain_ms
    tick_ms = {
        name: {"p50": float(np.percentile(v, 50) * 1e3), "p99": float(np.percentile(v, 99) * 1e3)}
        for name, v in lat.items()
    }
    for name in dets:
        print(
            f"[{smi}] {n_streams}-stream tick, {name}: tick_async + collect_events p50 "
            f"{tick_ms[name]['p50']:.4f} ms, p99 {tick_ms[name]['p99']:.4f} ms (host clock, 2 x 20 ticks in "
            f"turns); device idle share over 20 ticks "
            f"{'not measured' if idle[name] is None else format(idle[name], '.3f')}",
            flush=True,
        )
    seconds["tick"] = time.perf_counter() - t0

    # -- 11.2 training, graphed and eager, on phase 6's corpus
    t0 = time.perf_counter()
    shards = trained["shards"]
    real_graphed = loop._graphed_steps

    def trained_run(name: str, graphed: bool, epochs: int, resume=None, out=None):
        out = out or root / name
        loop._graphed_steps = real_graphed if graphed else (lambda dev, group: False)
        try:
            loop.train(None, str(out), config=Config(train=TrainConfig(epochs=epochs)), shards_dir=str(shards),
                       resume=resume)
        finally:
            loop._graphed_steps = real_graphed
        return out

    def records(out: Path) -> list:
        return [json.loads(line) for line in (out / "metrics.jsonl").read_text().splitlines()]

    runs, train_launches, walls = {}, {}, {}
    for name in ("graph", "eager"):
        zero_launches()
        runs[name] = trained_run(name, name == "graph", 2)
        train_launches[name] = launches()
        w = [r["wall_s"] for r in records(runs[name])]
        walls[name] = [w[0]] + [b - a for a, b in zip(w, w[1:])]
    skip = {"train_clips_per_sec", "val_clips_per_sec", "wall_s", "t"}
    strip = lambda rs: [{k: v for k, v in r.items() if k not in skip} for r in rs]  # noqa: E731
    same = {"records": strip(records(runs["graph"])) == strip(records(runs["eager"]))}
    for ck in ("best_model", "latest_model"):
        ta, tb = (checkpoint.load_checkpoint(str(runs[n] / ck))[0] for n in ("graph", "eager"))
        same[ck + " parameters and BN stats"] = all(torch.equal(tb["model"][k], v) for k, v in ta["model"].items())
        same[ck + " moments"] = all(
            torch.equal(x, y) for x, y in zip(ta["optimizer"]["mu"] + ta["optimizer"]["nu"],
                                             tb["optimizer"]["mu"] + tb["optimizer"]["nu"])
        )
    want = 2 * (64 + 8)
    print(
        f"train() 2 epochs of phase 6's corpus on the graphs vs eagerly: {same}; launches graph "
        f"{train_launches['graph']}, eager {train_launches['eager']}, expected {want} each; losses "
        f"{[(r['train_loss'], r['val_loss']) for r in records(runs['graph'])]}",
        flush=True,
    )
    if not (all(same.values()) and set(train_launches["graph"] + train_launches["eager"]) == {want}):
        fail("the graphed training run differs from the eager one")

    epoch_idle = {}
    for name in ("graph", "eager"):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            trained_run(name, name == "graph", 3, resume=str(runs[name] / "latest_model"),
                        out=root / f"{name}_profiled")
        events = prof.events()
        span = [e for e in events if e.device_type == DeviceType.CPU and e.name == "cdt.epoch"]
        if len(span) == 1:
            lo, hi = span[0].time_range.start, span[0].time_range.end
            epoch_idle[name] = 1 - busy_ms(events, lo, hi) / ((hi - lo) / 1e3)
        else:
            epoch_idle[name] = None
    for name in ("graph", "eager"):
        print(
            f"[{smi}] train() {name}: epoch walls (metrics.jsonl wall_s, both runs pipelined; epoch 0 holds the "
            f"loop's set-up{' and the captures' if name == 'graph' else ' and epoch 1, whose eager steps wait on the card one by one before epoch 0 is recorded'}"
            f") {[round(w, 3) for w in walls[name]]} s; idle "
            f"share over one profiled epoch "
            f"{'not measured' if epoch_idle[name] is None else format(epoch_idle[name], '.3f')}",
            flush=True,
        )

    # The batch-32 step alone: 30 steps on the resident corpus, graphed and eager.
    corpus_d = torch.from_numpy(ShardLoader(str(shards / "train"), 32, feature_config=FeatureConfig()).corpus()).to(dev)
    tcfg = TrainConfig()
    cw = torch.tensor([1.0, 1.0], device=dev)
    feature_fn, eval_fn = loop.make_feature_fns(Config(), dev, use_time_shift=True)
    idx = np.random.default_rng(SEED).integers(0, corpus_d.shape[0], (40, 32)).astype(np.int64)
    labels = (idx % 2).astype(np.int64)
    step_ms = {}
    with loop.deterministic(dev):
        for name in ("graph", "eager", "graph", "eager"):
            model = init_weights(create_model("residual"), torch.Generator().manual_seed(SEED)).to(dev)
            opt = steps.make_optimizer(model.parameters(), tcfg, 64)
            rand = steps.StepRandom(dev)
            programs = steps.StepPrograms(model, opt, cw, rand, feature_fn, eval_fn)
            idx_d, labels_d = torch.from_numpy(idx).to(dev), torch.from_numpy(labels).to(dev)

            def one(s: int, name=name, model=model, opt=opt, rand=rand, programs=programs):
                if name == "graph":
                    programs.train(corpus_d, idx[s], labels[s], None, SEED, 0, s)
                else:
                    steps.train_step(model, opt, corpus_d.index_select(0, idx_d[s]), labels_d[s], cw,
                                     rand.key(SEED, 0, s), feature_fn=feature_fn)

            for s in range(10):  # the graph's capture, and warm caches
                one(s)
            torch.cuda.synchronize()
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            t1 = time.perf_counter()
            start.record()
            for s in range(10, 40):
                one(s)
            end.record()
            enqueue = time.perf_counter() - t1
            torch.cuda.synchronize()
            wall = time.perf_counter() - t1
            step_ms.setdefault(name, []).append(
                {"events": start.elapsed_time(end) / 30, "host": wall * 1e3 / 30, "enqueue": enqueue * 1e3 / 30}
            )
            if name == "graph":
                step_launches = [sum(v) for v in zip(*programs.programs.launches().values())]
    for name, ms in step_ms.items():
        print(
            f"[{smi}] batch-32 train step, {name}, 30 steps on the resident corpus, two turns: CUDA events "
            f"{[round(m['events'], 4) for m in ms]} ms, host clock to a synchronize "
            f"{[round(m['host'], 4) for m in ms]} ms, host enqueue {[round(m['enqueue'], 4) for m in ms]} ms a step",
            flush=True,
        )
    seconds["training"] = time.perf_counter() - t0
    total = time.perf_counter() - t_phase
    print(
        "captured-programs phase by sub-step (s): " + ", ".join(f"{k} {v:.3f}" for k, v in seconds.items())
        + f"; phase total {total:.3f} s (budget 30 s)",
        flush=True,
    )
    return {
        "tick_launches": tick_launches, "tick_replay_launches": replay_launches,
        "train_launches": train_launches, "step_replay_launches": step_launches,
        "tick_ms": tick_ms, "tick_idle": idle, "epoch_walls": walls, "epoch_idle": epoch_idle,
        "step_ms": step_ms,
    }


def pipeline_phase(smi: str, trained: dict, files: dict) -> dict:
    """Phase 12, pipelined epochs and the scoring programs (budget 30 s,
    seconds printed by sub-step, under build/smoke_pipeline/). Training:
    train() for 3 epochs on phase 6's corpus pipelined one deep (the loop's
    own choice for one process with a resident corpus) and synchronous
    (`loop._PIPELINED` False), then both with an early stop forced at epoch
    1 by patience: per-step losses, parameters with BatchNorm statistics,
    moments, both checkpoints and metrics.jsonl (less timings) bit-equal,
    launches one a finished epoch's step (none of a discarded epoch's), the
    in-memory model and optimizer count the last finished epoch's; every
    epoch e+1's first replay before epoch e's fetch when pipelined; the
    epoch walls, the host time from epoch e's metrics in hand to e+1's
    first replay (negative pipelined, below every synchronous one), and the
    device idle share from epoch 0's results to epoch 1's in a profiled
    2-epoch run of each and against the unprofiled epoch walls.
    Scoring: each path as captured programs against its eager function
    (graphs.Programs calling it on its static buffers), bit for bit: phase
    7's 10-minute recording through score_recording (events, window
    probabilities; windows/s of the call and of a 1024-window batch, peak
    device memory), cli.evaluate on phase 6's 256 validation shards,
    cli.featurize on 16 clips with and without --augment, extract-segments'
    scorer on two sets of candidates and CoughDetectorInference.predict;
    each path's keys, replays and launches through replays."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from cough_detector_tpu_torch.cli import evaluate as evaluate_cli
    from cough_detector_tpu_torch.cli import extract_segments as segments_cli
    from cough_detector_tpu_torch.cli import featurize as featurize_cli
    from cough_detector_tpu_torch.config import Config, TrainConfig
    from cough_detector_tpu_torch.data import audio_io
    from cough_detector_tpu_torch.models import model_from_config, place_model
    from cough_detector_tpu_torch.ops import frontend, frontend_kernel
    from cough_detector_tpu_torch.stream import CoughDetectorInference, offline
    from cough_detector_tpu_torch.stream.detector import _load_checkpoint
    from cough_detector_tpu_torch.train import checkpoint, loop, steps
    from cough_detector_tpu_torch.utils import graphs

    t_phase = time.perf_counter()
    seconds = {}
    dev = torch.device("cuda")
    root = Path(__file__).resolve().parent / "build" / "smoke_pipeline"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    shards, best = trained["shards"], str(trained["best_model"])
    n_steps = 2048 // 32 + 256 // 32  # train + eval steps an epoch
    skip = {"train_clips_per_sec", "val_clips_per_sec", "wall_s", "t"}

    def launches() -> tuple:
        return frontend_kernel.SPECTRAL_LAUNCHES, frontend_kernel.EPILOGUE_LAUNCHES

    def zero_launches() -> None:
        frontend_kernel.SPECTRAL_LAUNCHES = frontend_kernel.EPILOGUE_LAUNCHES = 0

    def records(out: Path) -> list:
        return [json.loads(line) for line in (out / "metrics.jsonl").read_text().splitlines()]

    # -- 12.1 pipelined epochs against the synchronous loop
    t0 = time.perf_counter()
    log = []  # (host start, host end, "train" / "eval" / "fetch") of each step call and fetch
    real = dict(call=graphs.Programs.__call__, fetch=graphs.fetch, accumulate=loop._accumulate,
                model=loop.model_from_config, optimizer=steps.make_optimizer)

    def logged(kind_of, fn):
        def call(*args, **kwargs):
            t = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                kind = kind_of(args)
                if kind is not None:
                    log.append((t, time.perf_counter(), kind))
        return call

    def train_run(name: str, pipelined: bool, tcfg, profiled: bool = False) -> dict:
        held = {"losses": []}
        log.clear()

        def accumulate(pending):
            t = time.perf_counter()
            acc, losses = real["accumulate"](pending)
            held["losses"].append(losses)
            log.append((t, time.perf_counter(), "accumulate"))
            return acc, losses

        def model(*args, **kwargs):
            held["model"] = real["model"](*args, **kwargs)
            return held["model"]

        def optimizer(*args, **kwargs):
            held["optimizer"] = real["optimizer"](*args, **kwargs)
            return held["optimizer"]

        loop._PIPELINED = pipelined
        graphs.Programs.__call__ = logged(lambda a: a[1][0] if a[0].name == "step" else None, real["call"])
        graphs.fetch = logged(lambda a: "fetch", real["fetch"])
        loop._accumulate, loop.model_from_config, steps.make_optimizer = accumulate, model, optimizer
        zero_launches()
        try:
            with (profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) if profiled
                  else contextlib.nullcontext()) as prof:
                loop.train(None, str(root / name), config=Config(train=tcfg), shards_dir=str(shards))
        finally:
            loop._PIPELINED = True
            graphs.Programs.__call__, graphs.fetch = real["call"], real["fetch"]
            loop._accumulate, loop.model_from_config, steps.make_optimizer = (
                real["accumulate"], real["model"], real["optimizer"])
        held.update(out=root / name, launches=launches(), log=list(log), prof=prof)
        return held

    def same_runs(a: dict, b: dict) -> dict:
        same = {"losses": a["losses"] == b["losses"], "launches": a["launches"] == b["launches"]}
        strip = lambda rs: [{k: v for k, v in r.items() if k not in skip} for r in rs]  # noqa: E731
        same["metrics.jsonl"] = strip(records(a["out"])) == strip(records(b["out"]))
        for ck in ("best_model", "latest_model"):
            (ta, ea, _, _), (tb, eb, _, _) = (checkpoint.load_checkpoint(str(r["out"] / ck)) for r in (a, b))
            same[ck] = ea == eb and ta["step"] == tb["step"] and all(
                torch.equal(tb["model"][k], v) for k, v in ta["model"].items()) and all(
                torch.equal(x, y) for x, y in zip(ta["optimizer"]["mu"] + ta["optimizer"]["nu"],
                                                  tb["optimizer"]["mu"] + tb["optimizer"]["nu"]))
        return same

    def in_memory_is_latest(run: dict) -> bool:
        tree = checkpoint.load_checkpoint(str(run["out"] / "latest_model"))[0]
        opt = run["optimizer"]
        return opt.count == tree["optimizer"]["count"] and all(
            torch.equal(v.cpu(), tree["model"][k]) for k, v in run["model"].state_dict().items()) and all(
            torch.equal(x.cpu(), y) for x, y in zip(opt.mu + opt.nu, tree["optimizer"]["mu"] + tree["optimizer"]["nu"]))

    def first_replays(run: dict) -> list:
        """Host start of each dispatched epoch's first train replay."""
        kinds = [None] + [c[2] for c in run["log"]]
        return [c[0] for prev, c in zip(kinds, run["log"]) if c[2] == "train" and prev != "train"]

    def epoch_gaps(run: dict) -> list:
        """Host ms from each epoch's metrics in hand (its validation rows
        folded) to the next epoch's first train replay: negative when the
        next epoch was dispatched before."""
        in_hand = [c[1] for c in run["log"] if c[2] == "accumulate"][1::2]
        return [(b - a) * 1e3 for a, b in zip(in_hand, first_replays(run)[1:])]

    def dispatched_before_fetch(run: dict) -> bool:
        """Every epoch e+1's first train replay came before epoch e's fetch."""
        fetches = [c[0] for c in run["log"] if c[2] == "fetch"]
        firsts = first_replays(run)
        return 0 < len(fetches) <= len(firsts) and all(f > s for f, s in zip(fetches, firsts[1:]))

    def epoch_1(run: dict):
        """A profiled 2-epoch run's device busy ms and span ms from epoch 0's
        "cdt.epoch" range's end to epoch 1's, and the busy ms inside epoch
        1's own range (a synchronous epoch's range holds its work and no
        more: one epoch's device time)."""
        events = run["prof"].events()
        spans = sorted((e.time_range.start, e.time_range.end) for e in events
                       if e.device_type == DeviceType.CPU and e.name == "cdt.epoch")
        if len(spans) != 2:
            return None
        lo, hi = spans[0][1], spans[1][1]
        return dict(busy=busy_ms(events, lo, hi), span=(hi - lo) / 1e3, own=busy_ms(events, *spans[1]))

    three, stop = TrainConfig(epochs=3), TrainConfig(epochs=3, patience=1, early_stop_min_delta=1e9)
    runs = {(mode, name): train_run(f"{mode}_{name}", mode == "pipelined", tcfg)
            for name, tcfg in (("three", three), ("stop", stop)) for mode in ("pipelined", "synchronous")}
    ok = True
    for name, n_epochs in (("three", 3), ("stop", 2)):
        p, s = runs[("pipelined", name)], runs[("synchronous", name)]
        same = same_runs(p, s)
        memory = {"pipelined": in_memory_is_latest(p), "synchronous": in_memory_is_latest(s)}
        epochs_ok = [r["epoch"] for r in records(p["out"])] == list(range(n_epochs))
        counts_ok = set(p["launches"]) == {n_epochs * n_steps} and p["optimizer"].count == n_epochs * 64
        before = dispatched_before_fetch(p)
        ok &= all(same.values()) and all(memory.values()) and epochs_ok and counts_ok and before
        print(
            f"train() {'3 epochs' if name == 'three' else 'an early stop forced at epoch 1 (3 asked)'} of phase 6's "
            f"corpus, pipelined vs synchronous: {same}; epochs {len(records(p['out']))}; launches pipelined "
            f"{p['launches']}, synchronous {s['launches']}, expected {n_epochs * n_steps} each; the in-memory model "
            f"(BN statistics too), moments and count {p['optimizer'].count} the last finished epoch's {memory}; every "
            f"epoch e+1's first replay before epoch e's fetch (pipelined) {before}",
            flush=True,
        )
    seconds["12.1 runs"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    profiled = {mode: epoch_1(train_run(f"{mode}_profiled", mode == "pipelined", TrainConfig(epochs=2),
                                        profiled=True))
                for mode in ("pipelined", "synchronous")}
    # One epoch's device time, from the synchronous epoch's range (its work and no more).
    epoch_busy = None if profiled["synchronous"] is None else profiled["synchronous"]["own"]
    walls, gaps, idle = {}, {}, {}
    for mode in ("pipelined", "synchronous"):
        w = [r["wall_s"] for r in records(runs[(mode, "three")]["out"])]
        walls[mode] = [w[0]] + [b - a for a, b in zip(w, w[1:])]
        gaps[mode] = epoch_gaps(runs[(mode, "three")])
        prof_idle = None if profiled[mode] is None else 1 - profiled[mode]["busy"] / profiled[mode]["span"]
        wall_idle = None if epoch_busy is None else [1 - epoch_busy / (x * 1e3) for x in walls[mode][1:]]
        idle[mode] = {"profiled": prof_idle, "unprofiled_walls": wall_idle}
        print(
            f"[{smi}] train() {mode}, 3 epochs: epoch walls (metrics.jsonl wall_s; epoch 0 holds the set-up and the "
            f"captures) {[round(x, 4) for x in walls[mode]]} s; host ms from epoch e's metrics in hand to e+1's first "
            f"replay (negative: e+1 dispatched before) {[round(g, 3) for g in gaps[mode]]}; device idle share from "
            f"epoch 0's results to epoch 1's in a profiled 2-epoch run "
            f"{'not measured' if prof_idle is None else format(prof_idle, '.3f')} (the profiler's host cost in it); "
            f"against epochs 1-2's unprofiled walls, with one epoch's device time "
            f"{'not measured' if epoch_busy is None else format(epoch_busy, '.3f') + ' ms'} (the synchronous "
            f"profiled epoch's): {'not measured' if wall_idle is None else [round(x, 3) for x in wall_idle]}",
            flush=True,
        )
    shorter = max(gaps["pipelined"]) < min(gaps["synchronous"])
    if not (ok and shorter):
        fail("pipelined epochs differ from the synchronous loop, or e+1 was not dispatched before e's fetch")
    seconds["12.1 profiled runs"] = time.perf_counter() - t0

    # -- 12.2 the scoring programs against their eager functions
    t0 = time.perf_counter()
    made = []
    real_init = graphs.Programs.__init__

    def init(self, *args, **kwargs):
        real_init(self, *args, **kwargs)
        made.append(self)

    class Eager(graphs.Programs):
        """The function called on the static buffers, no graph."""

        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            self.graphed = False

    def scored(mode: str, fn):
        """fn() with the paths' programs graphed or eager: (its result, the
        launches it counted, the Programs it made)."""
        made.clear()
        graphs.Programs.__init__ = init
        saved = graphs.Programs
        if mode == "eager":
            graphs.Programs = Eager
        zero_launches()
        try:
            out = fn()
            torch.cuda.synchronize()
        finally:
            graphs.Programs = saved
            graphs.Programs.__init__ = real_init
        return out, launches(), list(made)

    wave = audio_io.load_mono_16k(files["recording"])
    variables, config = _load_checkpoint(best)
    n_windows = (len(wave) - SR) // 4000 + 1
    results, paths = {}, {}
    call_s, peak = {"graph": [], "eager": []}, {}
    for mode in ("graph", "eager", "graph", "eager"):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t1 = time.perf_counter()
        out = scored(mode, lambda: offline.score_recording(wave, variables, config, threshold=0.0))
        call_s[mode].append(time.perf_counter() - t1)
        peak[mode] = torch.cuda.max_memory_allocated() - base
        results.setdefault(("offline", mode), out)
    for mode in ("graph", "eager"):
        results[("offline probabilities", mode)] = scored(mode, lambda: offline.window_probs(wave, variables, config))
    val = str(shards / "val")
    for mode in ("graph", "eager"):
        results[("evaluate", mode)] = scored(mode, lambda: json.loads(run_cli(
            evaluate_cli.main, ["--model", best, "--data-dir", val, "--batch-size", "64"],
            echo=False).strip().splitlines()[-1]))
    clips = root / "clips16"
    for sub in ("cough", "non_cough"):
        (clips / sub).mkdir(parents=True)
        for p in sorted((files["data"] / sub).glob("*.wav"))[:8]:
            (clips / sub / p.name).symlink_to(p)
    for aug in ((), ("--augment",)):
        for mode in ("graph", "eager"):
            npz = root / f"features_{mode}{len(aug)}.npz"

            def feats(npz=npz, aug=aug):
                run_cli(featurize_cli.main, ["--data-dir", str(clips), "--output", str(npz), "--num-workers", "4",
                                             "--batch-size", "4", "--seed", "5", *aug], echo=False)
                return np.load(npz)["features"]

            results[("featurize" + "".join(aug), mode)] = scored(mode, feats)
    segments = offline.frame_windows(torch.from_numpy(wave), SR, 4000)[:600].numpy()
    window_feats = frontend.extract_features_fast(
        frontend.peak_normalize(torch.from_numpy(segments[:4]).to(dev)), config.features, device=dev).cpu().numpy()
    for mode in ("graph", "eager"):
        def segment_scores():  # two recordings' candidates, 300 and 290 windows
            scorer = segments_cli._make_scorer(best, "cuda")
            return np.concatenate([scorer(segments[:300]), scorer(segments[300:590])])

        def predicted():
            facade = CoughDetectorInference(best, verbose=False)
            return [facade.predict(x)[1] for x in (window_feats[0][None], window_feats[:, None], window_feats[1][None])]

        results[("extract_segments", mode)] = scored(mode, segment_scores)
        results[("predict", mode)] = scored(mode, predicted)
    scoring_ok, scoring_launches, replay_launches = True, {}, {}
    for path in dict.fromkeys(k for k, _ in results):
        (g, g_n, g_progs), (e, e_n, _) = results[(path, "graph")], results[(path, "eager")]
        if isinstance(g, np.ndarray):
            same = g.shape == e.shape and np.array_equal(g, e)
        else:
            same = g == e
        graphed = bool(g_progs) and all(p.graphed for p in g_progs)
        keys = [k for p in g_progs for k in p.keys]
        replays = sum(sum(p.replays().values()) for p in g_progs)
        through = [sum(n) for n in zip(*[v for p in g_progs for v in p.launches().values()])] or [0, 0]
        scoring_launches[path], replay_launches[path] = g_n, through
        scoring_ok &= same and graphed and g_n == e_n
        print(
            f"scoring programs [{path}]: graphed bit-equal to eager {same}; programs {[p.name for p in g_progs]} "
            f"on graphs {graphed}; keys {keys}; replays {replays}; launches graphed {g_n}, eager {e_n}, through "
            f"replays (captured x replays) {through}",
            flush=True,
        )
    if not (scoring_ok and results[("offline", "graph")][0] and not np.array_equal(
            results[("featurize", "graph")][0], results[("featurize--augment", "graph")][0])):
        fail("a scoring path's programs differ from its eager function")

    # A 1024-window batch, its program's replay against the eager function.
    model = place_model(model_from_config(config.model), dev)
    model.load_state_dict({k: torch.as_tensor(v) for k, v in variables.items()})
    batch = offline.frame_windows(torch.from_numpy(wave).to(dev), SR, 4000)[:1024].contiguous()

    def score(static):
        feats = frontend.extract_features_fast(frontend.peak_normalize(static["windows"]), config.features, device=dev)
        return (torch.softmax(model(feats), dim=-1)[:, 1],)

    progs = graphs.Programs(dev, name="offline score", pool=graphs.scoring_pool(dev))
    batch_ms = {}
    with torch.no_grad():
        for mode in ("graph", "eager", "graph", "eager"):
            if mode == "graph":
                ms = cuda_ms(lambda: progs(((1024, SR), "float32"), score, {"windows": batch}, copy=(False,)), 20)
            else:
                ms = cuda_ms(lambda: score({"windows": batch}), 20)
            batch_ms.setdefault(mode, []).append(ms)
    print(
        f"[{smi}] score_recording, the 10-minute recording ({n_windows} windows, 3 batches of 1024), two calls each "
        f"in turns: graphed {[round(n_windows / s) for s in call_s['graph']]} windows/s over the call "
        f"({[round(s, 4) for s in call_s['graph']]} s; the captures included), eager "
        f"{[round(n_windows / s) for s in call_s['eager']]} ({[round(s, 4) for s in call_s['eager']]} s); one "
        f"1024-window batch by CUDA events: graphed {[round(m, 4) for m in batch_ms['graph']]} ms, eager "
        f"{[round(m, 4) for m in batch_ms['eager']]} ms; peak device memory over a call above what was allocated "
        f"before it (the call's first key captured) graphed {peak['graph'] / 2**20:.1f} MiB, eager "
        f"{peak['eager'] / 2**20:.1f} MiB",
        flush=True,
    )
    seconds["12.2 scoring programs"] = time.perf_counter() - t0
    total = time.perf_counter() - t_phase
    print(
        "pipelined-epochs and scoring-programs phase by sub-step (s): "
        + ", ".join(f"{k} {v:.3f}" for k, v in seconds.items()) + f"; phase total {total:.3f} s (budget 30 s)",
        flush=True,
    )
    return {
        "train_launches": {name: runs[("pipelined", name)]["launches"] for name in ("three", "stop")},
        "scoring_launches": scoring_launches, "scoring_replay_launches": replay_launches,
        "epoch_walls": walls, "epoch_gaps_ms": gaps, "idle": idle, "call_s": call_s, "batch_ms": batch_ms,
        "peak_bytes": peak,
    }


def bench_phase(smi: str, yard: dict) -> dict:
    """Phase 13, the port's bench (budget 45 s, seconds printed by sub-step,
    under build/smoke_bench/); returns what the kernels' JSON line adds.

    The bench's own entry points, in process: the headline at B = 16384 in
    "high" (with the ingest-inclusive record), "serve" and bf16, each record
    checked for its keys and for naming this card, the launches over the
    timed replays one each a replay, and "high"'s logits on 256 rows held
    against the plain version (frontend_kernel_reference, then the eager
    model) within 1e-3; the pair's device time inside the headline program
    by torch.profiler, beside its bound at B = 16384. The front end at
    B = 70,000, past grid y's 65,535 clips: rows 65,000-69,999 against the
    plain version on those rows alone. The serving bench at 256 and 20,480
    streams, every fill key's replays equal to the timed ticks it ran (no
    capture inside the timed loops). And `python -m
    cough_detector_tpu_torch.cli.bench --daemon --backend native --loadgen
    native --streams 512 --seconds 5` as a subprocess, started first and run
    beside the in-process steps (its cadence is not held here: the
    daemon-ramp command measures the socket tier on an idle card), its last
    line parsed. Each path's launches are counted from 0."""
    from cough_detector_tpu_torch.cli import bench
    from cough_detector_tpu_torch.config import default_config
    from cough_detector_tpu_torch.ops import frontend, frontend_kernel

    t_phase = time.perf_counter()
    root = Path(__file__).resolve().parent / "build" / "smoke_bench"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    seconds, launches = {}, {}
    card = torch.cuda.get_device_name(0)
    fcfg = default_config("residual").features

    def counted(name: str, fn):
        frontend_kernel.SPECTRAL_LAUNCHES = frontend_kernel.EPILOGUE_LAUNCHES = 0
        out = fn()
        torch.cuda.synchronize()
        launches[name] = {"spectral": frontend_kernel.SPECTRAL_LAUNCHES, "epilogue": frontend_kernel.EPILOGUE_LAUNCHES}
        return out

    def released() -> None:
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()

    def program_device_ms(replay, kernel: str, iters: int = 3):
        """Mean device time of `kernel` inside `iters` replays of a captured
        program, from torch.profiler; None where it recorded no launch of
        it (a profile may not see into a graph)."""
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                replay()
            torch.cuda.synchronize()
        times = [e.time_range.elapsed_us() for e in prof.events()
                 if e.device_type == DeviceType.CUDA and kernel in e.name]
        return sum(times) / len(times) / 1e3 if times else None

    # -- 13.0 the daemon bench in its own process, beside the steps below
    daemon_out = open(root / "daemon.out", "w")
    daemon_err = open(root / "daemon.err", "w")
    daemon = subprocess.Popen(
        [sys.executable, "-m", "cough_detector_tpu_torch.cli.bench", "--daemon", "--backend", "native",
         "--loadgen", "native", "--streams", "512", "--seconds", "5"],
        cwd=Path(__file__).resolve().parent, stdout=daemon_out, stderr=daemon_err,
    )
    try:
        # -- 13.1 the headline in each mode at B = 16384
        t0 = time.perf_counter()
        batch, n_iters = 16384, 20
        heads = {}
        # TF32 off going in (the "high" claim): each mode must leave it off.
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
        for mode in bench.MODES:
            h = counted(f"headline_{mode}", lambda: bench.main(batch=batch, n_iters=n_iters, mode=mode,
                                                              fresh_h2d=mode == "high"))
            recs = [h.record] + ([h.ingest_record] if mode == "high" else [])
            keys_ok = all(
                {"metric", "value", "unit", "vs_baseline", "device"} <= set(r) and r["device"] == card
                and r["value"] > 0 and r["vs_baseline"] == round(r["value"] / 10_000.0, 3)
                and r.get("mode", "high") == mode for r in recs
            )
            want = {"spectral": n_iters, "epilogue": n_iters}
            # around the call: the warm call's eager run, the 20 timed replays
            # (and the ingest program's warm call and 4 replays)
            around = 1 + n_iters + (5 if mode == "high" else 0)
            heads[mode] = dict(
                records=recs, keys_ok=keys_ok, launches_ok=h.launches == want
                and set(launches[f"headline_{mode}"].values()) == {around},
                event_ms=h.event_ms,
                tf32=(torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32),
            )
            if mode == "high":
                with torch.no_grad():
                    want_logits = h.model(frontend_kernel.frontend_kernel_reference(h.waves[:256], fcfg))
                heads[mode]["logits_err"] = rel_err(h.logits[:256].float(), want_logits)
                heads[mode]["finite"] = bool(torch.isfinite(h.logits).all()) and tuple(h.logits.shape) == (batch, 2)
                heads[mode]["device_ms"] = {
                    part: program_device_ms(h.replay, f"{part}_kernel") for part in ("spectral", "epilogue")
                }
            del h
            released()
        high = heads["high"]
        bounds = {"spectral": yard["bound_a"](batch), "epilogue": yard["bound_b"](batch)}
        for mode, r in heads.items():
            print(f"[{smi}] bench headline [{mode}] B={batch}: " + "; ".join(json.dumps(x) for x in r["records"])
                  + f"; CUDA events {r['event_ms']:.4f} ms a replay; keys and device {r['keys_ok']}; launches over "
                  f"the timed replays one each a replay {r['launches_ok']} (around the call "
                  f"{launches[f'headline_{mode}']}); TF32 flags after {r['tf32']}", flush=True)
        print(
            f"[{smi}] bench headline [high] logits on rows 0-255 of the timed program vs the plain version "
            f"(frontend_kernel_reference, then the eager model): max-relative {high['logits_err']:.3e} (limit 1e-3); "
            "the pair inside the program (torch.profiler device ms a replay, beside its bound at B=16384): "
            + ", ".join(f"{part} {'not measured' if ms is None else format(ms, '.4f')} (bound "
                        f"{bounds[part]['bound_ms']:.4f} ms by {bounds[part]['bound_by']})"
                        for part, ms in high["device_ms"].items()),
            flush=True,
        )
        if not (all(r["keys_ok"] and r["launches_ok"] and r["tf32"] == (False, False) for r in heads.values())
                and high["finite"] and high["logits_err"] <= TOL):
            fail("the bench's headline did not hold its records, launches or parity")
        seconds["13.1 headline x3 + ingest"] = time.perf_counter() - t0

        # -- 13.2 the front end past 65,535 clips
        t0 = time.perf_counter()
        big = 70_000
        gen = torch.Generator(device="cuda").manual_seed(SEED)
        base = torch.from_numpy(make_audio(np.random.default_rng(SEED + 13), 256, fcfg.segment_samples)).cuda()
        waves_big = base.repeat(-(-big // 256), 1)[:big]
        waves_big = waves_big * torch.empty((big, 1), device="cuda").uniform_(0.25, 1.0, generator=gen)
        waves_big += torch.randn(waves_big.shape, device="cuda", generator=gen) * 0.01
        feats_big = counted("features_b70000", lambda: frontend.extract_features_fast(waves_big, fcfg))
        rows = slice(65_000, 70_000)
        big_err = rel_err(feats_big[rows], frontend_kernel.frontend_kernel_reference(waves_big[rows].contiguous(), fcfg))
        big_ok = tuple(feats_big.shape) == (big, fcfg.num_features, fcfg.num_frames) and bool(
            torch.isfinite(feats_big).all())
        print(
            f"[{smi}] front end at B={big} ({waves_big.numel() * 4 / 1e9:.2f} GB of waveforms; launch A's "
            f"{frontend_kernel.spectral_grid(big, fcfg.num_frames)} blocks on grid x): shape {tuple(feats_big.shape)}, "
            f"rows 65000-69999 vs frontend_kernel_reference on those rows alone max-relative {big_err:.3e} (limit 1e-3); "
            f"launches {launches['features_b70000']}",
            flush=True,
        )
        if not (big_ok and big_err <= TOL and set(launches["features_b70000"].values()) == {1}):
            fail(f"the front end at B={big} does not hold: {big_err:.3e}, {launches['features_b70000']}")
        del waves_big, feats_big, base
        released()
        seconds["13.2 B=70000"] = time.perf_counter() - t0

        # -- 13.3 the serving bench at 256 and 20,480 streams
        t0 = time.perf_counter()
        serving = {}
        for s in (256, 20480):
            run = counted(f"serving_{s}", lambda: bench.serving_bench(num_streams=s))
            scoring = sum(windows_completed(len(run.fills), CHUNK, SR, SR // 4))
            serving[s] = dict(
                record=run.record, no_capture=bool(run.timed_by_fill) and run.timed_by_fill == run.replays_by_fill,
                launches_ok=set(launches[f"serving_{s}"].values()) == {scoring}, scoring=scoring,
                keys_ok=run.record["device"] == card and run.record["num_streams"] == s,
            )
            del run
            released()
        for s, r in serving.items():
            print(f"[{smi}] bench --serving {s} streams: {json.dumps(r['record'])}; every fill key's replays equal "
                  f"its timed ticks {r['no_capture']}; launches {launches[f'serving_{s}']} (scoring ticks "
                  f"{r['scoring']})", flush=True)
        if not all(r["no_capture"] and r["launches_ok"] and r["keys_ok"] for r in serving.values()):
            fail("the serving bench captured inside its timed loops, or miscounted its launches")
        seconds["13.3 serving 256 + 20480"] = time.perf_counter() - t0

        # -- 13.4 the daemon bench's subprocess
        t0 = time.perf_counter()
        try:
            rc = daemon.wait(timeout=120)
        except subprocess.TimeoutExpired:
            rc = None
    finally:
        if daemon.poll() is None:
            daemon.kill()
            daemon.wait()
        daemon_out.close()
        daemon_err.close()
    out_lines = (root / "daemon.out").read_text().strip().splitlines()
    rec = json.loads(out_lines[-1]) if out_lines and out_lines[-1].startswith("{") else {}
    daemon_ok = (rc == 0 and rec.get("metric") == "serving_daemon_socket_tier" and rec.get("ticks", 0) > 0
                 and rec.get("device") == card and (rec.get("backend"), rec.get("loadgen")) == ("native", "native"))
    print(f"[{smi}] bench --daemon --backend native --loadgen native --streams 512 --seconds 5 (a subprocess beside "
          f"13.1-13.3): exit {rc}, last line {json.dumps(rec)}", flush=True)
    if not daemon_ok:
        fail("the daemon bench failed: " + (root / "daemon.err").read_text()[-3000:])
    seconds["13.4 daemon wait"] = time.perf_counter() - t0

    total = time.perf_counter() - t_phase
    print(
        "bench phase by sub-step (s): " + ", ".join(f"{k} {v:.3f}" for k, v in seconds.items())
        + f"; phase total {total:.3f} s (budget 45 s)",
        flush=True,
    )
    return {"launches": launches, "batch": batch, "program_device_ms": high["device_ms"], "bounds": bounds}


class Stamped(io.StringIO):
    """A stdout that notes the host time each line arrives (rank 0's lines
    of a mesh call come through the launcher's reader as the rank prints)."""

    def __init__(self):
        super().__init__()
        self.stamps = []

    def write(self, s: str) -> int:
        now = time.perf_counter()
        self.stamps += [now] * s.count("\n")
        return super().write(s)

    def first(self, prefix: str) -> float:
        """Host time of the first whole line that starts with `prefix`."""
        return next(t for t, line in zip(self.stamps, self.getvalue().splitlines()) if line.startswith(prefix))


def mesh_phase(smi: str, par: dict) -> dict:
    """Phase 14, training over a mesh (budget 30 s, seconds printed by
    sub-step, under build/smoke_mesh/); returns what the kernels' JSON line
    adds.

    On phase 10's 64 + 32-clip corpus, 2 epochs, with the config phase 10's
    second gloo pair ran: train(device="cuda:0") against train(mesh=
    ["cuda:0"]) (a mesh of one device is the one-process run, pipelined:
    metrics.jsonl less timings, best and latest checkpoints' tensors and
    moments bit-equal, launches one a step); train(mesh=["cuda:0",
    "cuda:0"]), whose call starts two gloo ranks on the card, with the row
    probes on, bit-equal to that pair (cli.train --distributed under
    torchrun's environment), each rank's launches from its log one a train
    and eval step, rank 0 alone writing; `python -m
    cough_detector_tpu_torch.cli.train --mesh cuda:0,cuda:0 --compile-cache
    DIR` as a subprocess, without the probes, started first and run beside
    the rest (a process takes ~9 s to import torch on the card's host, so
    two mesh calls in turn would spend most of the phase starting),
    bit-equal to the pair too. The host time from each in-process call's
    entry to rank 0 joining the process group, to its "Steps:" line (the
    model built and the corpus on the card) and to its first step (its
    first row probe); the epoch walls (metrics.jsonl)."""
    from cough_detector_tpu_torch.config import Config
    from cough_detector_tpu_torch.ops import frontend_kernel
    from cough_detector_tpu_torch.train import checkpoint, train

    t_phase = time.perf_counter()
    seconds, launches, starts = {}, {}, {}
    root = Path(__file__).resolve().parent / "build" / "smoke_mesh"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    pair = par["pair_96"]
    corpus, budget = pair["corpus"], pair["budget"]
    config = Config.from_json((pair["out"] / "config.json").read_text())
    n_steps = 2 * (64 // 32 + 32 // 32)  # 2 epochs of 2 train and 1 eval steps
    skip = {"train_clips_per_sec", "val_clips_per_sec", "wall_s", "t"}

    def records(out: Path) -> list:
        return [json.loads(line) for line in (out / "metrics.jsonl").read_text().splitlines()]

    def walls(out: Path) -> list:
        w = [r["wall_s"] for r in records(out)]
        return [w[0]] + [b - a for a, b in zip(w, w[1:])]

    def same_run(a: Path, b: Path) -> bool:
        """metrics.jsonl less timings, and the best and latest checkpoints'
        parameters, BatchNorm statistics and moments, bit for bit."""
        strip = lambda rs: [{k: v for k, v in r.items() if k not in skip} for r in rs]  # noqa: E731
        if strip(records(a)) != strip(records(b)):
            return False
        for ck in ("best_model", "latest_model"):
            ta, tb = (checkpoint.load_checkpoint(str(o / ck))[0] for o in (a, b))
            if ta["model"].keys() != tb["model"].keys() or any(
                    not torch.equal(tb["model"][k], v) for k, v in ta["model"].items()):
                return False
            if not all(torch.equal(x, y) for x, y in zip(ta["optimizer"]["mu"] + ta["optimizer"]["nu"],
                                                         tb["optimizer"]["mu"] + tb["optimizer"]["nu"])):
                return False
        return True

    def run(name: str, fn, probes: bool = False) -> Stamped:
        """fn() with its output stamped and the launch counters from 0 (the
        parent's: a mesh of two launches in its ranks); with `probes`, the
        row probes on and each rank's output under <root>/<name>_logs."""
        out = Stamped()
        env = {"CDT_DEBUG_STEP_METRICS": "1", "CDT_RANK_LOG_DIR": str(root / f"{name}_logs")} if probes else {}
        os.environ.update(env)
        frontend_kernel.SPECTRAL_LAUNCHES = frontend_kernel.EPILOGUE_LAUNCHES = 0
        t = time.perf_counter()
        try:
            with contextlib.redirect_stdout(out):
                fn()
            torch.cuda.synchronize()
        finally:
            for k in env:
                os.environ.pop(k, None)
        launches[name] = {"spectral": frontend_kernel.SPECTRAL_LAUNCHES, "epilogue": frontend_kernel.EPILOGUE_LAUNCHES}
        starts[name] = {"steps_line_s": out.first("Steps:") - t}
        if probes:
            starts[name]["joined_s"] = out.first("Rank 0 of 2 joined") - t
            starts[name]["first_step_s"] = out.first("ROW_HASHES") - t
        return out

    # -- 14.c (started first) cli.train --mesh cuda:0,cuda:0 as a subprocess, the probes off
    t_cli = time.perf_counter()
    cli_out = root / "cli_mesh"
    cli_log = open(root / "cli_mesh.log", "w")
    cli_proc = subprocess.Popen(
        [sys.executable, "-m", "cough_detector_tpu_torch.cli.train", "--shards", str(corpus), "--output-dir",
         str(cli_out), "--model-type", "residual", "--epochs", "2", "--batch-size", "32",
         "--device-corpus-budget", str(budget), "--mesh", "cuda:0,cuda:0", "--compile-cache",
         str(root / "compile_cache")],
        cwd=Path(__file__).resolve().parent, stdout=cli_log, stderr=subprocess.STDOUT,
    )
    try:
        # -- 14.a a mesh of one device against the plain call (one process, pipelined)
        t0 = time.perf_counter()
        for name, kw in (("one_device", dict(device="cuda:0")), ("mesh_one", dict(mesh=["cuda:0"]))):
            run(name, lambda: train(None, str(root / name), config=config, shards_dir=str(corpus), **kw))
        one_same = same_run(root / "one_device", root / "mesh_one")
        one_launches_ok = launches["one_device"] == launches["mesh_one"] == {"spectral": n_steps, "epilogue": n_steps}
        one_walls = walls(root / "mesh_one")
        print(
            f"[{smi}] train(mesh=['cuda:0']) vs train(device='cuda:0'), phase 10's 64 + 32 clips, 2 epochs: bit-equal "
            f"(metrics.jsonl less timings, best and latest checkpoints with moments) {one_same}; launches "
            f"{launches['mesh_one']} (steps {n_steps}); entry to the 'Steps:' line "
            f"{starts['one_device']['steps_line_s']:.3f} s and {starts['mesh_one']['steps_line_s']:.3f} s; epoch "
            f"walls {[round(w, 4) for w in walls(root / 'one_device')]} and {[round(w, 4) for w in one_walls]} s "
            f"(pipelined one deep)",
            flush=True,
        )
        if not (one_same and one_launches_ok):
            fail("a mesh of one device does not reproduce the one-device run")
        seconds["14.a mesh of one device"] = time.perf_counter() - t0

        # -- 14.b a mesh of two ranks on cuda:0 against phase 10's torchrun-environment gloo pair
        t0 = time.perf_counter()
        two = run("mesh_two", lambda: train(None, str(root / "mesh_two"), config=config, shards_dir=str(corpus),
                                            device_corpus_budget=budget, mesh=["cuda:0", "cuda:0"]), probes=True)
        logs = [(root / "mesh_two_logs" / f"rank{r}.log").read_text() for r in range(2)]
        per_rank = [
            {"spectral": int(m.group(1)), "epilogue": int(m.group(2))} if m else None
            for m in (re.search(r"KERNEL_LAUNCHES rank=\d+ spectral=(\d+) epilogue=(\d+)", t) for t in logs)
        ]
        launches.update({f"mesh_two_rank{r}": n for r, n in enumerate(per_rank)})
        two_checks = {
            "bit_equal_to_the_pair": same_run(pair["out"], root / "mesh_two"),
            "gloo_eager": all("Steps: eager (gloo's collectives cannot be captured)" in t for t in logs),
            "sharded": all("sharded by rows over 2 ranks" in t for t in logs),
            "launches": per_rank == [{"spectral": n_steps, "epilogue": n_steps}] * 2,
            "parent_launched_none": launches["mesh_two"] == {"spectral": 0, "epilogue": 0},
            "rank0_only": "Epoch 0" in logs[0] and "Epoch 0" not in logs[1] and "Epoch 0" in two.getvalue()
            and sorted(p.name for p in (root / "mesh_two").iterdir()) == sorted(p.name for p in pair["out"].iterdir()),
        }
        mesh_walls = walls(root / "mesh_two")
        st = starts["mesh_two"]
        print(
            f"[{smi}] train(mesh=['cuda:0', 'cuda:0']) (two gloo ranks started by the call, the row probes on; the "
            f"cli.train subprocess starting beside it), the same 2 epochs: "
            + ", ".join(f"{k} {v}" for k, v in two_checks.items())
            + f"; launches a rank {per_rank} (steps {n_steps}: one of each kernel a train and eval step); from entry, "
            f"rank 0 joined the group {st['joined_s']:.3f} s, its 'Steps:' line {st['steps_line_s']:.3f} s, its "
            f"first step {st['first_step_s']:.3f} s (one process: {starts['mesh_one']['steps_line_s']:.3f} s to its "
            f"'Steps:' line); epoch walls {[round(w, 4) for w in mesh_walls]} s synchronous on each rank, against "
            f"{[round(w, 4) for w in one_walls]} s for the one-process run pipelined one deep (2 epochs: "
            f"{sum(mesh_walls):.3f} s and {sum(one_walls):.3f} s)",
            flush=True,
        )
        if not all(two_checks.values()):
            fail("train(mesh=['cuda:0', 'cuda:0']) does not reproduce the gloo pair: "
                 + " | ".join(t[-3000:] for t in logs))
        seconds["14.b mesh of two ranks"] = time.perf_counter() - t0

        # -- 14.c the subprocess's end
        t0 = time.perf_counter()
        cli_rc = cli_proc.wait(timeout=max(1.0, 180 - (time.perf_counter() - t_cli)))
    except subprocess.TimeoutExpired:
        cli_rc = None
    finally:
        if cli_proc.poll() is None:
            cli_proc.kill()
            cli_proc.wait()
        cli_log.close()
    cli_wall = time.perf_counter() - t_cli
    cli_text = (root / "cli_mesh.log").read_text()
    cli_same = cli_rc == 0 and same_run(pair["out"], cli_out)
    print(
        f"[{smi}] python -m cough_detector_tpu_torch.cli.train --mesh cuda:0,cuda:0 --compile-cache DIR (a "
        f"subprocess beside 14.a-14.b): exit {cli_rc}, bit-equal to the gloo pair {cli_same}; spawn to exit "
        f"{cli_wall:.3f} s; epoch walls {[round(w, 4) for w in walls(cli_out)] if cli_rc == 0 else None} s without "
        f"the probes",
        flush=True,
    )
    if not (cli_same and "one rank a device" in cli_text):
        fail("cli.train --mesh does not reproduce the gloo pair: " + cli_text[-3000:])
    seconds["14.c cli.train --mesh wait"] = time.perf_counter() - t0

    total = time.perf_counter() - t_phase
    print(
        "mesh phase by sub-step (s): " + ", ".join(f"{k} {v:.3f}" for k, v in seconds.items())
        + f"; phase total {total:.3f} s (budget 30 s)",
        flush=True,
    )
    return {"launches": launches, "seconds": total, "starts": starts, "cli_wall_s": cli_wall,
            "epoch_wall_s": {"mesh_two_ranks": mesh_walls, "one_process_pipelined": one_walls}}


def coverage_configs() -> dict:
    """name -> (config, batches). The configs the JAX launcher sends to its
    Pallas kernel that the card once ran on the torch chain: more than 128
    mels and n_fft 2048 at 16 and 22.05 kHz (launch A's FFT plan), clips
    past 4 s (launch B's tile past one block), a hop of 4, and contrast
    configs past the contrast launch's old limits (its FFT plan at n_fft
    1024 and 2048); each at B = 17 and 256. Then, at B = 17, those that
    reach what no config above does: launch B on a non-portable cluster
    (15 blocks, one an SM) with PCEN and delta-deltas, and the contrast
    launch's level 2 (its rows in the output), in one 60 s config; the
    contrast launch at a hop of 4; its FFT plan at n_fft 4096 (458-bin bands); the FFT plans'
    radix-3 and radix-5 stages at n_fft 2000 and 3000 with contrast and at
    n_fft 768 on 256 mels; their radix-7 stages at n_fft 1792 and 2744 with
    contrast and 896 on 256 mels, and at 44.1 kHz as users set it, a 40 ms
    window with contrast (n_fft 1764) and a 20 ms one (n_fft 882: launch A's
    frame of 441 points, odd), a 10 ms hop; their radix-11 stages at n_fft
    1760 and 2662 with contrast and 880 on 256 mels (110 and 55 ms windows
    at 16 kHz); an odd n_fft, launch A two frames a row of n_fft points: 30
    ms at 44.1 kHz (1323) with and without contrast, 50 ms with contrast
    (2205), and n_fft 1125 (57 frames: launch A's lone last frame, paired
    with zeros); a prime factor of 13, the FFT plans' generic prime stage
    (fft_stage_prime): n_fft 1664 (2^7 13) and 2704 (2^4 13^2) with
    contrast, 832 (2^6 13) on 256 mels and 31 ms at 44.1 kHz (1365, odd);
    a prime factor past the generic stage's cap (kFftMaxPrime), the FFT
    plans' Bluestein stage: n_fft 2096 (2^4 131, a 131 ms window) and 2192
    (2^4 137) with contrast, 2192 and 1048 (2^3 131) on 256 mels and 1965
    (3 5 131, odd) at 44.1 kHz on 256 mels; bands past the FFT plan's
    band_value_sorted (kWideBand), its block_tails: n_fft 5296 (2^4 331, a
    581-bin band) and 6144 (666) with contrast, 4608 with 8 bands (563),
    8192 at 44.1 kHz with contrast (868); Bluestein's rows over two and
    four warps of a block: n_fft 6544 (2^4 409, m 825) and the prime 1987
    at hop 496 (m 3993, the widest) with contrast. The GEMM plans where the FFT
    plans do not fit: a 25 ms hop with contrast (the shipped window; launch
    A's span from device memory, the contrast launch's level 1), and the
    prime n_fft 2129 (133 ms; past Bluestein's 1997) on
    256 mels with contrast (launch A's span from device memory over two
    mel groups, the contrast launch's level 3, its power rows in device
    memory). Last, two
    10 s clips for launch B's cluster route's other branches: PCEN with
    delta-deltas and 20 MFCCs (its 32-MFCC DCT), and 36 MFCCs of 40 mels
    with delta-deltas (two DCT passes, the MFCC and delta tiles after the
    mel tile); and a 120 s clip at 128 mels with PCEN and
    delta-deltas, past a cluster of 16: launch B in device memory."""
    from cough_detector_tpu_torch.config import FeatureConfig

    both, one = (17, 256), (17,)
    return {
        "mels160": (FeatureConfig(n_mels=160, f_max=8000.0), both),
        "mels256": (FeatureConfig(n_mels=256, f_max=8000.0), both),
        "nfft2048": (FeatureConfig(n_fft=2048, win_length=2048, hop_length=512, n_mels=128, f_max=8000.0), both),
        "librosa22k": (FeatureConfig(sample_rate=22050, n_fft=2048, win_length=2048, hop_length=512, n_mels=128,
                                     f_max=11025.0), both),
        "clip5s_128": (FeatureConfig(segment_duration=5.0, n_mels=128, f_max=8000.0), both),
        "clip10s": (FeatureConfig(segment_duration=10.0), both),
        "hop4": (FeatureConfig(hop_length=4), both),
        "nfft1024_contrast": (FeatureConfig(n_fft=1024, win_length=1024, hop_length=256, n_mels=128, f_max=8000.0,
                                            use_spectral_contrast=True), both),
        "nfft2048_contrast": (FeatureConfig(n_fft=2048, win_length=2048, hop_length=512, n_mels=128, f_max=8000.0,
                                            use_spectral_contrast=True), both),
        "bands17": (FeatureConfig(use_spectral_contrast=True, n_contrast_bands=17), both),
        "clip60s_128_all_flags": (FeatureConfig(segment_duration=60.0, n_mels=128, f_max=8000.0, use_pcen=True,
                                                use_pre_emphasis=True, use_delta_delta=True,
                                                use_spectral_contrast=True), one),
        "hop4_contrast": (FeatureConfig(hop_length=4, use_spectral_contrast=True), one),
        "nfft4096_contrast": (FeatureConfig(n_fft=4096, win_length=4096, hop_length=1024, n_mels=128, f_max=8000.0,
                                            use_spectral_contrast=True), one),
        "nfft2000_contrast": (FeatureConfig(n_fft=2000, win_length=2000, hop_length=500, n_mels=128, f_max=8000.0,
                                            use_spectral_contrast=True), one),
        "nfft3000_contrast": (FeatureConfig(n_fft=3000, win_length=3000, hop_length=750, n_mels=128, f_max=8000.0,
                                            use_spectral_contrast=True), one),
        "nfft768_mels256": (FeatureConfig(n_fft=768, win_length=768, hop_length=192, n_mels=256, f_max=8000.0), one),
        "nfft1792_contrast": (FeatureConfig(n_fft=1792, win_length=1792, hop_length=448, n_mels=128, f_max=8000.0,
                                            use_spectral_contrast=True), one),
        "nfft2744_contrast": (FeatureConfig(n_fft=2744, win_length=2744, hop_length=686, n_mels=128, f_max=8000.0,
                                            use_spectral_contrast=True), one),
        "nfft896_mels256": (FeatureConfig(n_fft=896, win_length=896, hop_length=224, n_mels=256, f_max=8000.0), one),
        "sr44k_nfft1764_contrast": (FeatureConfig(sample_rate=44100, n_fft=1764, win_length=1764, hop_length=441,
                                                  n_mels=128, f_max=22050.0, use_spectral_contrast=True), one),
        "sr44k_nfft882": (FeatureConfig(sample_rate=44100, n_fft=882, win_length=882, hop_length=441, n_mels=128,
                                        f_max=22050.0), one),
        "nfft1760_contrast": (FeatureConfig(n_fft=1760, win_length=1760, hop_length=440, n_mels=128, f_max=8000.0,
                                            use_spectral_contrast=True), one),
        "nfft2662_contrast": (FeatureConfig(n_fft=2662, win_length=2662, hop_length=665, n_mels=128, f_max=8000.0,
                                            use_spectral_contrast=True), one),
        "nfft880_mels256": (FeatureConfig(n_fft=880, win_length=880, hop_length=220, n_mels=256, f_max=8000.0), one),
        "sr44k_nfft1323": (FeatureConfig(sample_rate=44100, n_fft=1323, win_length=1323, hop_length=441, n_mels=128,
                                         f_max=22050.0), one),
        "sr44k_nfft1323_contrast": (FeatureConfig(sample_rate=44100, n_fft=1323, win_length=1323, hop_length=441,
                                                  n_mels=128, f_max=22050.0, use_spectral_contrast=True), one),
        "sr44k_nfft2205_contrast": (FeatureConfig(sample_rate=44100, n_fft=2205, win_length=2205, hop_length=441,
                                                  n_mels=128, f_max=22050.0, use_spectral_contrast=True), one),
        "nfft1125": (FeatureConfig(n_fft=1125, win_length=1125, hop_length=281, n_mels=128, f_max=8000.0), one),
        "nfft1664_contrast": (FeatureConfig(n_fft=1664, win_length=1664, hop_length=416, n_mels=128, f_max=8000.0,
                                            use_spectral_contrast=True), one),
        "nfft2704_contrast": (FeatureConfig(n_fft=2704, win_length=2704, hop_length=676, n_mels=128, f_max=8000.0,
                                            use_spectral_contrast=True), one),
        "nfft832_mels256": (FeatureConfig(n_fft=832, win_length=832, hop_length=208, n_mels=256, f_max=8000.0), one),
        "sr44k_nfft1365": (FeatureConfig(sample_rate=44100, n_fft=1365, win_length=1365, hop_length=441, n_mels=128,
                                         f_max=22050.0), one),
        "nfft2096_contrast": (FeatureConfig(n_fft=2096, win_length=2096, hop_length=524, n_mels=128, f_max=8000.0,
                                            use_spectral_contrast=True), one),
        "nfft2192_contrast": (FeatureConfig(n_fft=2192, win_length=2192, hop_length=548, n_mels=128, f_max=8000.0,
                                            use_spectral_contrast=True), one),
        "nfft5296_contrast": (FeatureConfig(n_fft=5296, win_length=5296, hop_length=1324, n_mels=128, f_max=8000.0,
                                            use_spectral_contrast=True), one),
        "nfft6144_contrast": (FeatureConfig(n_fft=6144, win_length=6144, hop_length=1536, n_mels=128, f_max=8000.0,
                                            use_spectral_contrast=True), one),
        "nfft6544_contrast": (FeatureConfig(n_fft=6544, win_length=6544, hop_length=1636, n_mels=128, f_max=8000.0,
                                            use_spectral_contrast=True), one),
        "nfft1987_contrast": (FeatureConfig(n_fft=1987, win_length=1987, hop_length=496, n_mels=128, f_max=8000.0,
                                            use_spectral_contrast=True), one),
        "sr44k_nfft8192_contrast": (FeatureConfig(sample_rate=44100, n_fft=8192, win_length=8192, hop_length=2048,
                                                  n_mels=128, f_max=22050.0, use_spectral_contrast=True), one),
        "nfft4608_bands8_contrast": (FeatureConfig(n_fft=4608, win_length=4608, hop_length=1152, n_mels=128,
                                                   f_max=8000.0, n_contrast_bands=8, use_spectral_contrast=True), one),
        "nfft2192_mels256": (FeatureConfig(n_fft=2192, win_length=2192, hop_length=548, n_mels=256, f_max=8000.0), one),
        "nfft1048_mels256": (FeatureConfig(n_fft=1048, win_length=1048, hop_length=262, n_mels=256, f_max=8000.0), one),
        "sr44k_nfft1965_mels256": (FeatureConfig(sample_rate=44100, n_fft=1965, win_length=1965, hop_length=441,
                                                 n_mels=256, f_max=22050.0), one),
        "hop400_contrast": (FeatureConfig(hop_length=400, use_spectral_contrast=True), one),
        "nfft2129_mels256_contrast": (FeatureConfig(n_fft=2129, win_length=2129, hop_length=532, n_mels=256,
                                                    f_max=8000.0, use_spectral_contrast=True), one),
        "clip10s_pcen_dd20": (FeatureConfig(segment_duration=10.0, use_pcen=True, use_delta_delta=True, n_mfcc=20), one),
        "clip10s_mels40_mfcc36_dd": (FeatureConfig(segment_duration=10.0, n_mels=40, n_mfcc=36, use_delta_delta=True),
                                     one),
        "clip120s_128_pcen_dd": (FeatureConfig(segment_duration=120.0, n_mels=128, f_max=8000.0, use_pcen=True,
                                               use_delta_delta=True), one),
    }


def spectral_model(fk, w: torch.Tensor, cfg) -> tuple:
    """(the CPU model of launch A's plan at cfg on w, its tolerance, its
    name): the FFT plan's or the 3xTF32 GEMM's."""
    if fk.spectral_plan(cfg) == fk.PLAN_FFT:
        return fk.power_mel_fft_reference(w, cfg), FFT_TOL, "FFT model"
    return fk.power_mel_split_reference(w, cfg), SPLIT_TOL, "3xTF32 model"


def contrast_model(fk, w: torch.Tensor, cfg) -> tuple:
    """The same for the contrast launch."""
    if fk.contrast_level(cfg) == fk.CONTRAST_FFT:
        return fk.spectral_contrast_fft_reference(w, cfg), FFT_TOL, "FFT model"
    return fk.spectral_contrast_split_reference(w, cfg), SPLIT_TOL, "3xTF32 model"


def plan_name(fk, part: str, cfg) -> str:
    if part == "spectral":
        return "fft" if fk.spectral_plan(cfg) == fk.PLAN_FFT else "gemm"
    return "fft" if fk.contrast_level(cfg) == fk.CONTRAST_FFT else "gemm"


def coverage_phase(smi: str, rng: np.random.Generator) -> dict:
    """Phase 3's every-config checks (budget 15 s, seconds printed): each
    config of coverage_configs through extract_features_fast on the card,
    every launch it needs once a call (counted around the call, the FFT
    plans' kernels by their own counters too, fk.PLAN_COUNTERS), its
    features within 1e-3 of the plain versions and of the torch chain; each
    launch alone against its plain version (1e-3) and the CPU model of its
    plan (FFT_TOL for the FFT plans, SPLIT_TOL for the 3xTF32 GEMM); each
    launch's shared memory and plan against its Python mirror. Then the
    main path at full width on mels160, clip10s, nfft2048,
    nfft2048_contrast, sr44k_nfft1764_contrast, sr44k_nfft1323_contrast,
    nfft2704_contrast and nfft2192_contrast (Bluestein's stage):
    features into the residual model (290,370
    parameters, seeded weights) through a captured graphs.Programs program,
    one eager call and two replays, the launches counted through the
    replays, the logits within 1e-3 of the same weights eagerly."""
    from cough_detector_tpu_torch.models import count_parameters, create_model, place_model
    from cough_detector_tpu_torch.ops import frontend, frontend_kernel as fk
    from cough_detector_tpu_torch.utils import graphs

    t_phase = time.perf_counter()
    dev = torch.device("cuda")
    lib = fk.build()
    counters = fk.LAUNCH_COUNTERS

    def counts(names=counters) -> tuple:
        return tuple(getattr(fk, c) for c in names)

    def zero() -> None:
        for c in counters + fk.PLAN_COUNTERS:
            setattr(fk, c, 0)

    # Keyed by launch and plan: "spectral" (the GEMM) and "spectral_fft".
    max_abs = {"spectral": 0.0, "spectral_fft": 0.0, "epilogue": 0.0, "epilogue_cluster": 0.0, "contrast": 0.0,
               "contrast_fft": 0.0}
    model_err = {"spectral": 0.0, "spectral_fft": 0.0, "contrast": 0.0, "contrast_fft": 0.0}
    launches, plans = {}, {}
    for name, (cfg, batches) in coverage_configs().items():
        t_cfg = time.perf_counter()
        base = dataclasses.replace(cfg, use_spectral_contrast=False)
        hop, kpad = cfg.hop_length, fk._support(base)[2]
        t = cfg.num_frames
        a_args = (cfg.n_fft, hop, kpad, cfg.n_mels)
        b_args = (t, cfg.n_mels, cfg.n_mfcc, int(cfg.use_pcen), int(cfg.use_delta_delta))
        mirrors = {
            "spectral smem": (lib.cdt_frontend_smem_a(*a_args), fk.spectral_smem_bytes(base)),
            "spectral plan": (lib.cdt_frontend_plan_a(*a_args), fk.spectral_plan(base)),
            "epilogue smem": (lib.cdt_frontend_smem_b(*b_args), fk.epilogue_smem_bytes(cfg)),
            "epilogue blocks": (lib.cdt_frontend_plan_b(*b_args), fk.epilogue_blocks(cfg)),
        }
        if cfg.use_spectral_contrast:
            geo = fk._geometry(cfg)
            args = (cfg.n_fft, hop, geo.kpad, geo.n_pow, t, cfg.n_contrast_bands)
            mirrors["contrast smem"] = (lib.cdt_frontend_smem_c(*args), fk.contrast_smem_bytes(cfg))
            mirrors["contrast level"] = (lib.cdt_frontend_plan_c(*args), fk.contrast_level(cfg))
        if any(a != b for a, b in mirrors.values()):
            fail(f"a launch's plan disagrees with its Python mirror on {name}: {mirrors}")
        plans[name] = {k: v[0] for k, v in mirrors.items()}
        keys = {"spectral": "spectral" + ("_fft" if plan_name(fk, "spectral", base) == "fft" else ""),
                "epilogue": "epilogue" + ("_cluster" if fk.epilogue_blocks(cfg) >= 2 else ""),
                "contrast": "contrast" + ("_fft" if cfg.use_spectral_contrast and plan_name(fk, "contrast", cfg) == "fft" else "")}
        want_moved = (1, 1, int(cfg.use_spectral_contrast))
        # The FFT plans' kernels among them (fk.PLAN_COUNTERS).
        want_fft = (int(keys["spectral"] == "spectral_fft"), int(keys["contrast"] == "contrast_fft"))
        for b in batches:
            w = make_audio_bulk(rng, b, cfg.segment_samples, dev)
            before, before_fft = counts(), counts(fk.PLAN_COUNTERS)
            got = frontend.extract_features_fast(w, cfg)
            torch.cuda.synchronize()
            moved = tuple(x - y for x, y in zip(counts(), before))
            moved_fft = tuple(x - y for x, y in zip(counts(fk.PLAN_COUNTERS), before_fft))
            mel_want = fk.power_mel_reference(w, base)
            plain = fk.mel_epilogue_reference(mel_want, base)
            if cfg.use_spectral_contrast:
                con_want = fk.spectral_contrast_reference(w, cfg)
                plain = torch.cat([plain, con_want], dim=1)
            chain = frontend.extract_features(w, cfg)
            errs = {"plain": rel_err(got, plain), "chain": rel_err(got, chain)}
            parts = {
                "spectral": (fk.power_mel_fused(w, base), mel_want, spectral_model(fk, w, base)),
                "epilogue": (fk.mel_epilogue_fused(mel_want.contiguous(), base),
                             fk.mel_epilogue_reference(mel_want, base), None),
            }
            if cfg.use_spectral_contrast:
                parts["contrast"] = (fk.spectral_contrast_fused(w, cfg), con_want, contrast_model(fk, w, cfg))
            torch.cuda.synchronize()
            limits = {}
            for part, (k_out, want, model) in parts.items():
                errs[part] = rel_err(k_out, want)
                max_abs[keys[part]] = max(max_abs[keys[part]], (k_out - want).abs().max().item())
                if model is not None:
                    out, tol, label = model
                    errs[f"{part} vs {label}"] = rel_err(k_out, out)
                    limits[f"{part} vs {label}"] = tol
                    model_err[keys[part]] = max(model_err[keys[part]], errs[f"{part} vs {label}"])
            ok = (
                moved == want_moved and moved_fft == want_fft and got.shape == (b, cfg.num_features, t)
                and bool(torch.isfinite(got).all()) and all(v <= limits.get(k, TOL) for k, v in errs.items())
            )
            print(
                f"[{smi}] config {name} B={b}: launches a call "
                f"{dict(zip(counters + fk.PLAN_COUNTERS, moved + moved_fft))}; max-relative "
                + ", ".join(f"{k} {v:.3e}" + (f" (limit {limits[k]:g})" if k in limits else "") for k, v in errs.items())
                + f"; plans {mirrors}; {time.perf_counter() - t_cfg:.3f} s into the config",
                flush=True,
            )
            if not ok:
                fail(f"config {name} B={b}: launches {moved} (want {want_moved}), FFT plans' {moved_fft} (want "
                     f"{want_fft}) or errors {errs} off")
            launches[(name, b)] = moved

    # The main path on eight of them at full width, through a captured program.
    torch.manual_seed(SEED)
    model = create_model("residual")
    if count_parameters(model) != 290370:
        fail(f"residual model has {count_parameters(model)} parameters, expected 290370")
    model = place_model(model, dev)
    main_path = {}
    for name in ("mels160", "clip10s", "nfft2048", "nfft2048_contrast", "sr44k_nfft1764_contrast",
                 "sr44k_nfft1323_contrast", "nfft2704_contrast", "nfft2192_contrast"):
        cfg = coverage_configs()[name][0]
        w = make_audio_bulk(rng, 256, cfg.segment_samples, dev)

        def score(static, cfg=cfg):
            return (model(frontend.extract_features_fast(static["waves"], cfg, device=dev)),)

        progs = graphs.Programs(dev, name=f"coverage {name}")
        with torch.no_grad():
            zero()
            for _ in range(3):  # one eager call (and the capture), two replays
                (logits,) = progs(name, score, {"waves": w})
            torch.cuda.synchronize()
            counted, counted_fft = counts(), counts(fk.PLAN_COUNTERS)
            eager = model(frontend.extract_features_fast(w, cfg, device=dev))
        err = rel_err(logits, eager)
        main_path[name] = dict(zip(counters + fk.PLAN_COUNTERS, counted + counted_fft))
        print(
            f"[{smi}] main path {name}: residual logits (256, {cfg.num_features}, {cfg.num_frames}) features through "
            f"a captured program, 1 eager call + {progs.replays()[name]} replays: launches {main_path[name]}; logits "
            f"vs eager max-relative {err:.3e}",
            flush=True,
        )
        want = (3, 3, 3 if cfg.use_spectral_contrast else 0)
        base = dataclasses.replace(cfg, use_spectral_contrast=False)
        want_fft = (3 * (plan_name(fk, "spectral", base) == "fft"),
                    3 * (cfg.use_spectral_contrast and plan_name(fk, "contrast", cfg) == "fft"))
        if (counted != want or counted_fft != want_fft or progs.replays()[name] != 2 or not err <= TOL
                or not bool(torch.isfinite(logits).all())):
            fail(f"the main path on {name}: launches {counted} (want {want}), FFT plans' {counted_fft} (want "
                 f"{want_fft}), logits vs eager {err:.3e}")
    print(f"every-config checks: {time.perf_counter() - t_phase:.3f} s (budget 15 s)", flush=True)
    return dict(max_abs=max_abs, model_err=model_err, launches=launches, main_path=main_path, plans=plans)


def main() -> None:
    # Host seconds from each phase's start to the next's, printed before the
    # summary: where the smoke run's time goes (its target is 260 s).
    starts = [("1-2 card and build", time.perf_counter())]
    imports_s = time.time() - T_IMPORTS

    def phase(name: str) -> None:
        starts.append((name, time.perf_counter()))

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
    from cough_detector_tpu_torch.data import native_loader
    from cough_detector_tpu_torch.models import count_parameters, create_model
    from cough_detector_tpu_torch.ops import filters, frontend, frontend_kernel
    from cough_detector_tpu_torch.serve import DetectionClient, DetectionServer, native_ingest
    from cough_detector_tpu_torch.stream import StreamingDetector
    from cough_detector_tpu_torch.utils import kernel_build, native_build

    # -- 2. build: the CUDA kernel, the two C++ libraries and the bench's load
    # generator, all at once; beside them (their threads wait on the
    # compilers), host work of later phases: phase 6's corpus, phase 7's
    # resample banks and data directory (cli.prepare_data's process), phase
    # 3's DFT tables, and the profiler's start that phase 4's first device
    # time paid ----
    def timed(fn):
        t0 = time.perf_counter()
        fn()
        return time.perf_counter() - t0

    def kernel() -> float:
        """The build started before the imports: its seconds, then the
        library loaded as every caller loads it."""
        KERNEL_BUILD[0].join()
        if "error" in KERNEL_BUILD[1]:
            raise KERNEL_BUILD[1]["error"]
        frontend_kernel.build()
        return KERNEL_BUILD[1]["seconds"]

    t0 = time.perf_counter()
    prepare = start_prepare_data()
    atexit.register(prepare.kill)  # a run that fails first leaves it no orphan
    made = []
    with concurrent.futures.ThreadPoolExecutor(8) as pool:
        builds = {
            kernel_build.library_path("frontend_kernel").name: pool.submit(kernel),
            native_build.library_path("cdt_loader").name: pool.submit(timed, native_loader.require),
            native_build.library_path("cdt_ingest").name: pool.submit(timed, native_ingest.require),
            native_build.executable_path("cdt_loadgen").name: pool.submit(
                timed, lambda: native_build.build_executable("cdt_loadgen")),
        }
        host = {
            "phase 6's corpus": pool.submit(timed, lambda: made.extend(training_corpus())),
            "phase 7's resample banks": pool.submit(timed, resample_banks),
            "phase 3's DFT tables": pool.submit(timed, coverage_tables),
            "the profiler's start": pool.submit(timed, start_profiler),
        }
        build_s = {name: f.result() for name, f in builds.items()}
        host_s = {name: f.result() for name, f in host.items()}
    print(
        "build: " + ", ".join(f"{name} {s:.3f} s" for name, s in build_s.items())
        + f" (the first started before the imports; together {time.perf_counter() - t0:.3f} s from here); "
        "host work beside it: "
        + ", ".join(f"{name} {s:.3f} s" for name, s in host_s.items()),
        flush=True,
    )

    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED)
    shipped = FeatureConfig()

    def waves(b: int) -> torch.Tensor:
        return torch.from_numpy(make_audio(rng, b, shipped.segment_samples)).to(dev)

    phase("3 kernels vs plain")
    keep_config_tables()
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
        kpad = frontend_kernel._support(cfg)[2]
        smem = {
            "spectral": (lib.cdt_frontend_smem_a(cfg.n_fft, cfg.hop_length, kpad, cfg.n_mels),
                         frontend_kernel.spectral_smem_bytes(cfg)),
            "epilogue": (lib.cdt_frontend_smem_b(cfg.num_frames, cfg.n_mels, cfg.n_mfcc, int(cfg.use_pcen),
                                                 int(cfg.use_delta_delta)),
                         frontend_kernel.epilogue_smem_bytes(cfg)),
        }
        print(f"shared memory a block [{name}] (kernel, Python mirror): {smem}", flush=True)
        if any(c != py for c, py in smem.values()):
            fail(f"the Python mirror of the kernels' shared memory disagrees on {name}: {smem}")
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

    # The contrast launch (launch C) against its plain version (the gemm
    # rows) and its 3xTF32 model, and its shared memory against the Python
    # mirror the card route reads. Budget 10 s.
    t0 = time.perf_counter()
    contrast = FeatureConfig(use_spectral_contrast=True)

    def ties_batch(b: int) -> torch.Tensor:
        """Four sine sweeps, a digitally silent clip, a clip silent in its
        first half, a click train (its frames repeat; silent frames tie in
        every bin), then noise with bursts."""
        n = shipped.segment_samples
        w = make_audio(rng, b, n)
        w[:4] = make_sweeps(rng, 4, n)
        w[4] = 0.0
        w[5, : n // 2] = 0.0
        w[6] = 0.0
        w[6, :: shipped.hop_length] = 0.5
        return torch.from_numpy(w).to(dev)

    contrast_checks = [
        ("shipped + contrast", contrast, waves(1)), ("shipped + contrast", contrast, waves(17)),
        ("shipped + contrast", contrast, waves(256)), ("shipped + contrast", contrast, waves(1024)),
        ("all flags", FeatureConfig(use_pcen=True, use_pre_emphasis=True, use_delta_delta=True,
                                    use_spectral_contrast=True), waves(17)),
        ("n_fft=256", dataclasses.replace(n_fft_256, use_spectral_contrast=True), waves(17)),
        ("n_fft=1024", FeatureConfig(n_fft=1024, use_spectral_contrast=True), waves(17)),
        ("4 bands", FeatureConfig(n_contrast_bands=4, use_spectral_contrast=True), waves(17)),
        ("8 bands", FeatureConfig(n_contrast_bands=8, use_spectral_contrast=True), waves(17)),
        ("sweeps, silence, ties", contrast, ties_batch(17)),
    ]
    max_abs["contrast"] = max_abs["contrast_fft"] = 0.0
    contrast_split_err = 0.0
    for name, cfg, w in contrast_checks:
        b, geo = w.shape[0], frontend_kernel._geometry(cfg)
        args = (cfg.n_fft, cfg.hop_length, geo.kpad, geo.n_pow, cfg.num_frames, cfg.n_contrast_bands)
        smem = (lib.cdt_frontend_smem_c(*args), frontend_kernel.contrast_smem_bytes(cfg))
        plan = (lib.cdt_frontend_plan_c(*args), frontend_kernel.contrast_level(cfg))
        if smem[0] != smem[1] or plan[0] != plan[1]:
            fail(f"the Python mirror of the contrast launch's plan disagrees on {name}: {smem}, {plan}")
        got = frontend_kernel.spectral_contrast_fused(w, cfg)
        torch.cuda.synchronize()
        want = frontend_kernel.spectral_contrast_reference(w, cfg)
        err = rel_err(got, want)
        model, model_tol, label = contrast_model(frontend_kernel, w, cfg)
        split = rel_err(got, model)
        one_pass = rel_err(got, frontend_kernel.spectral_contrast_split_reference(w, cfg, passes=1))
        fft = plan[0] == frontend_kernel.CONTRAST_FFT
        key = "contrast_fft" if fft else "contrast"
        max_abs[key] = max(max_abs[key], (got - want).abs().max().item())
        if not fft:
            contrast_split_err = max(contrast_split_err, split)
        silent_ok = name != "sweeps, silence, ties" or bool((got[4] == 0).all())
        print(
            f"kernel vs plain [contrast, {name}, B={b}, plan {plan[0]}]: max-relative {err:.3e}, vs its {label} "
            f"{split:.3e} (limit {model_tol:g}), vs one TF32 pass's model {one_pass:.3e}; shape {tuple(got.shape)}; shared memory a block (kernel, Python mirror) {smem}",
            flush=True,
        )
        ok = got.shape == (b, cfg.n_contrast_bands + 1, cfg.num_frames) and bool(torch.isfinite(got).all())
        if not (ok and silent_ok and err <= TOL and split <= model_tol):
            fail(f"contrast kernel disagrees with its plain version or its model on {name} B={b}: {err:.3e}, {split:.3e}")

    print(f"contrast launch checks {time.perf_counter() - t0:.3f} s (budget 10 s)", flush=True)

    # Every config the JAX launcher sends to its Pallas kernel, through the
    # launches (a 160-mel and a 17-band config among them, which the card
    # once ran on the torch chain).
    covered = coverage_phase(smi, rng)

    phase("4 times")
    # -- 4. times ----------------------------------------------------------------
    def library_mel_fn(cfg: FeatureConfig):
        """cuFFT power spectrum and a mel matmul, (B, T, n_mels): the library
        yardstick of the spectral launch at cfg."""
        fb = torch.from_numpy(
            filters.mel_filterbank(cfg.n_fft // 2 + 1, cfg.n_mels, cfg.sample_rate, cfg.f_min, cfg.f_max)
        ).to(dev)
        window = torch.hann_window(cfg.win_length, device=dev)

        def library_mel(w: torch.Tensor) -> torch.Tensor:
            spec = torch.stft(
                w, cfg.n_fft, cfg.hop_length, cfg.win_length, window,
                center=True, pad_mode="reflect", return_complex=True,
            )
            return (spec.real**2 + spec.imag**2).transpose(1, 2) @ fb

        return library_mel

    library_mel = library_mel_fn(shipped)

    def library(w: torch.Tensor) -> torch.Tensor:
        return frontend.stack_features(library_mel(w), shipped)

    t_frames, n_mels = shipped.num_frames, shipped.n_mels

    def bound(flops: float, nbytes: float, peak: float = PEAK_FP32_FLOPS) -> dict:
        t_ops, t_bytes = flops / peak, nbytes / PEAK_HBM_BYTES
        return dict(
            bound_ms=max(t_ops, t_bytes) * 1e3,
            bound_by="operations" if t_ops >= t_bytes else "bytes",
        )

    def spectral_work(cfg: FeatureConfig, b: int) -> tuple:
        """Launch A's least work for b clips. Operations a frame: a real FFT
        of n_fft points (2.5 n log2 n, at the FP32 CUDA-core peak, as cuFFT
        runs it), the window's multiplies over its nonzero taps, the power
        of the bins any mel band reads (3 a bin) and the mel over the
        filterbank's nonzero entries (a multiply-add each). Bytes: the
        waveform read and the power mel written once."""
        k = frontend_kernel._constants(cfg, dev)
        nnz = int(torch.count_nonzero(k.fb))
        taps = int(np.count_nonzero(filters.padded_window(cfg.win_length, cfg.n_fft)))
        frame = 2.5 * cfg.n_fft * math.log2(cfg.n_fft) + taps + 3 * k.n_used + 2 * nnz
        return b * cfg.num_frames * frame, 4 * b * (cfg.segment_samples + cfg.n_mels * cfg.num_frames)

    def spectral_gemm_ceiling_ms(cfg: FeatureConfig, b: int) -> float:
        """Launch A's GEMM design's own ceiling: its DFT over the window's
        nonzero taps (a multiply-add each for re and im of the used bins),
        the power and the mel matmul, at the TF32 tensor-core peak."""
        k = frontend_kernel._constants(cfg, dev)
        t, n_used = cfg.num_frames, k.n_used
        flops = 4 * t * (k.j1 - k.j0) * n_used + 3 * t * n_used + 2 * t * n_used * cfg.n_mels
        return b * flops / PEAK_TF32_FLOPS * 1e3

    def epilogue_work(cfg: FeatureConfig, b: int) -> tuple:
        """Launch B's operations and bytes for b clips: the DCT matmul, plus
        about 8 elementwise operations per log-mel value (log, scale, max,
        dB clamp and scale) and 10 per MFCC value (z-norm sums and scale,
        deltas); the power mel read once, the features written once, the
        DCT table read once."""
        t, m, c = cfg.num_frames, cfg.n_mels, cfg.n_mfcc
        flops = b * (2 * t * m * c + 8 * m * t + 10 * c * t)
        return flops, 4 * b * (m + cfg.num_features) * t + 4 * m * c

    def contrast_work(cfg: FeatureConfig, b: int) -> tuple:
        """The contrast launch's least work for b clips: for each frame a
        real FFT of each window (2.5 n log2 n for n = n_fft, at the FP32
        CUDA-core peak, as cuFFT runs it) after the window's multiplies, 3
        an element for the bands' power, 6 for the magnitude (square, add,
        sqrt) and the centroid's sums, each band's two tails as selections
        (a compare a bin for each, then an add a selected bin) and 5 a value
        for the z-norm; bytes: the waveform read and the rows written once."""
        geo = frontend_kernel._geometry(cfg)
        rows = cfg.n_contrast_bands + 1
        fft = 2 * (2.5 * cfg.n_fft * np.log2(cfg.n_fft) + cfg.n_fft)
        tails = sum(2 * n + top + bot for n, top, bot in zip(geo.widths, geo.tops, geo.bots))
        flops = cfg.num_frames * (fft + 3 * geo.n_pow + 6 * geo.n_freqs + tails + 5 * rows)
        return b * flops, 4 * b * (cfg.segment_samples + rows * cfg.num_frames)

    def bound_a(b: int) -> dict:
        """The spectral launch's bound for b clips of the shipped config."""
        return bound(*spectral_work(shipped, b))

    yard = dict(library_mel=library_mel, bound_a=bound_a, bound_b=lambda b: bound(*epilogue_work(shipped, b)))

    t0 = time.perf_counter()
    timing, parts_s = {}, {}  # host seconds by part, printed with the total
    for b, iters in ((256, 50), (4096, 10)):
        t_b = time.perf_counter()
        w = make_audio_bulk(rng, b, SR, dev)
        mel = frontend_kernel.power_mel_fused(w, shipped)
        mel_err = rel_err(mel, frontend_kernel.power_mel_reference(w, shipped))
        if not mel_err <= TOL:
            fail(f"spectral kernel disagrees with its plain version at B={b}: {mel_err:.3e}")
        lib_err = rel_err(library(w), frontend_kernel.extract_features_fused(w, shipped))
        spectral = dict(
            ms=cuda_ms(lambda: frontend_kernel.power_mel_fused(w, shipped), iters),
            plain_ms=cuda_ms(lambda: frontend_kernel.power_mel_reference(w, shipped), iters),
            library_ms=cuda_ms(lambda: library_mel(w), iters),
            precision="3xTF32",
            **bound_a(b),
            gemm_ceiling_ms=spectral_gemm_ceiling_ms(shipped, b),
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
        parts_s[f"B={b} events"] = time.perf_counter() - t_b
        if b == 256:  # the card's own time, beside the events' host-bound one
            t_b = time.perf_counter()
            spectral["device_ms"] = device_ms(lambda: frontend_kernel.power_mel_fused(w, shipped), iters, "spectral_kernel")
            epilogue["device_ms"] = device_ms(lambda: frontend_kernel.mel_epilogue_fused(mel, shipped), iters, "epilogue_kernel")
            parts_s[f"B={b} profiler"] = time.perf_counter() - t_b
        timing[b] = dict(spectral=spectral, epilogue=epilogue)
        print(f"spectral kernel vs plain at B={b}: max-relative {mel_err:.3e}", flush=True)
        for part, tm in (("spectral", spectral), ("epilogue", epilogue)):
            lib_ms = "none" if tm["library_ms"] is None else f"{tm['library_ms']:.4f} ms"
            gemm = (
                f"; its GEMM design's ceiling {tm['gemm_ceiling_ms']:.4f} ms (TF32 tensor cores, "
                f"{100 * tm['gemm_ceiling_ms'] / tm['ms']:.1f}% of it)"
                if "gemm_ceiling_ms" in tm else ""
            )
            dev_ms = (
                f"; device time (profiler) {tm['device_ms']:.4f} ms, "
                f"{100 * tm['bound_ms'] / tm['device_ms']:.1f}% of bound"
                if "device_ms" in tm else ""
            )
            print(
                f"times {part} B={b}: kernel {tm['ms']:.4f} ms, plain {tm['plain_ms']:.4f} ms, "
                f"library {lib_ms}; bound {tm['bound_ms']:.4f} ms by {tm['bound_by']}; "
                f"kernel at {100 * tm['bound_ms'] / tm['ms']:.1f}% of bound{gemm}{dev_ms}",
                flush=True,
            )
        print(
            f"times pair B={b}: kernels {pair['ms']:.4f} ms, plain {pair['plain_ms']:.4f} ms, "
            f"library {pair['library_ms']:.4f} ms (torch.stft + matmuls + torch epilogue; "
            f"vs kernels max-relative {lib_err:.2e}); operations {spectral_work(shipped, b)[0] / 1e9:.3f} "
            f"GFLOP spectral (FFT count) at {PEAK_FP32_FLOPS / 1e12:.0f} TFLOP/s FP32, "
            f"{epilogue_work(shipped, b)[0] / 1e9:.3f} GFLOP epilogue, bytes at "
            f"{PEAK_HBM_BYTES / 1e12:.2f} TB/s",
            flush=True,
        )

    print(f"shipped-config launch times: {time.perf_counter() - t0:.3f} s ("
          + ", ".join(f"{k} {v:.3f}" for k, v in parts_s.items()) + ")", flush=True)

    # Each launch at B = 1024 on configs the card once ran on the torch
    # chain, beside its bound and torch.stft + mel (the spectral launch's
    # library yardstick), its plain version and, for the contrast launch,
    # the fft rows: launch A's FFT plan on n_fft 2048 at 16 and 22.05 kHz
    # and on n_fft 1024 (nfft1024_contrast's base), 2000 and 3000 and on
    # n_fft 768 at 256 mels (radix-3 and radix-5 stages), on n_fft 1792,
    # 2744, 896 at 256 mels and 44.1 kHz at 1764 and 882 (radix 7), on
    # n_fft 880 at 256 mels (radix 11) and at 44.1 kHz on the odd 1323 (two
    # frames a row), its GEMM plan on 10 s clips; the contrast launch's FFT
    # plan on n_fft 1024, 2048, 4096, 2000, 3000, 1792, 2744, 1760 and 2662
    # (radix 11) and 44.1 kHz at 1764, 1323 and 2205 (odd); both FFT plans
    # on a prime factor of 13 (fft_stage_prime): launch A on n_fft 832 at
    # 256 mels and 44.1 kHz at the odd 1365, the contrast launch on n_fft
    # 1664 and 2704; both FFT plans on a prime factor past the cap
    # (Bluestein's stage): launch A on 2192 and 1048 at 256 mels and 44.1
    # kHz at the odd 1965 on 256 mels, the contrast launch on 2192 and
    # 2096; the contrast launch's bands by the block (block_tails) on n_fft
    # 5296, 6144, 4608 with 8 bands and 8192 at 44.1 kHz; Bluestein's
    # widest windows at 16 kHz: launch A on n_fft 5296 and 6544, the
    # contrast launch on 6544. The GEMM plans
    # these n_fft took until their FFT plans
    # are not timed here (PERF.md keeps their times; tools/spectral_probe.py
    # and tools/contrast_probe.py time the GEMM on n_fft past the FFT
    # plans' cap beside both).
    # Where the FFT plan's threshold and its 128-mel rule are set (n_fft
    # 1024, 256 mels), the GEMM plan too, called through its C function.
    # A contrast config's pair is its base's: only its contrast launch is
    # timed. Launch B alone on the other configs its cluster route takes (5 s
    # at 128 mels, 10 s with PCEN, delta-deltas and 20 MFCCs; a hop of 4 at
    # B = 256 and 60 s at 128 mels with every flag at B = 64, on
    # non-portable clusters) and in device memory (120 s, B = 32).
    t0 = time.perf_counter()
    coverage_timing = {}
    covered_cfgs = dict(coverage_configs())
    for name in ("nfft1024", "nfft2000", "nfft3000", "nfft1792", "nfft2744", "sr44k_nfft1764", "nfft5296", "nfft6544"):
        cfg = covered_cfgs[f"{name}_contrast"][0]
        covered_cfgs[name] = (dataclasses.replace(cfg, use_spectral_contrast=False), ())
    epilogue_only = {"clip5s_128": 1024, "clip10s_pcen_dd20": 1024, "hop4": 256, "clip60s_128_all_flags": 64,
                     "clip120s_128_pcen_dd": 32}
    # Launch A's widest Bluestein windows, and launch C's and its widest
    # bands': the launch and its library call alone (their plain versions,
    # 54-312 ms a call at B = 1024, and A's epilogue, PERF.md keeps; phase 3
    # holds each against its plain version).
    spectral_only = ("nfft5296", "nfft6544")
    no_plain = (*spectral_only, "nfft6544_contrast", "nfft5296_contrast", "nfft6144_contrast",
                "sr44k_nfft8192_contrast", "nfft4608_bands8_contrast")
    for name in ("mels256", "nfft2048", "librosa22k", "nfft1024", "clip10s", "nfft2000", "nfft3000", "nfft768_mels256",
                 "nfft896_mels256", "nfft1792", "nfft2744", "sr44k_nfft1764", "sr44k_nfft882", "nfft880_mels256",
                 "sr44k_nfft1323", "nfft832_mels256", "sr44k_nfft1365", "nfft1024_contrast", "nfft2048_contrast",
                 "nfft4096_contrast", "nfft2000_contrast", "nfft3000_contrast", "nfft1792_contrast", "nfft2744_contrast",
                 "sr44k_nfft1764_contrast", "nfft1760_contrast", "nfft2662_contrast", "sr44k_nfft1323_contrast",
                 "sr44k_nfft2205_contrast", "nfft1664_contrast", "nfft2704_contrast", "nfft2192_mels256",
                 "nfft1048_mels256", "sr44k_nfft1965_mels256", "nfft2192_contrast", "nfft2096_contrast",
                 "nfft5296_contrast", "nfft6144_contrast", "sr44k_nfft8192_contrast", "nfft4608_bands8_contrast",
                 "nfft5296", "nfft6544", "nfft6544_contrast", *epilogue_only):
        t_cfg = time.perf_counter()
        cfg = covered_cfgs[name][0]
        base = dataclasses.replace(cfg, use_spectral_contrast=False)
        batch = epilogue_only.get(name, 1024)
        # 64 clips repeated to the batch: the times do not depend on the
        # content.
        w = make_audio_bulk(rng, min(batch, 64), cfg.segment_samples, dev).repeat(max(batch // 64, 1), 1)
        rows = {}
        if name in epilogue_only:
            mel = frontend_kernel.power_mel_fused(w, base)
        elif not cfg.use_spectral_contrast:
            mel = frontend_kernel.power_mel_fused(w, base)
            lib_mel = library_mel_fn(cfg)
            rows["spectral"] = dict(
                ms=cuda_ms(lambda: frontend_kernel.power_mel_fused(w, base), 5),
                plain_ms=None if name in no_plain else cuda_ms(
                    lambda: frontend_kernel.power_mel_reference(w, base), 2, warmup=1),
                library_ms=cuda_ms(lambda: lib_mel(w), 5),
                **bound(*spectral_work(base, 1024)),
                plan=plan_name(frontend_kernel, "spectral", base),
            )
            if rows["spectral"]["plan"] == "gemm":
                rows["spectral"]["gemm_ceiling_ms"] = spectral_gemm_ceiling_ms(base, 1024)
            if name in ("mels256", "nfft1024"):  # its GEMM plan too, through its C function
                k = frontend_kernel._constants(base, dev)
                gemm_out = torch.empty_like(mel)

                def gemm_plan() -> None:
                    err = lib.cdt_frontend_spectral(
                        w.data_ptr(), 1024, w.shape[1], base.num_frames, base.n_fft, base.hop_length, k.j0, k.kpad,
                        k.table.data_ptr(), k.n_bins, base.n_mels, k.mel_tiles, k.n_groups, 0, 0.0,
                        gemm_out.data_ptr(), torch.cuda.current_stream().cuda_stream,
                    )
                    if err:
                        fail(f"the GEMM plan's launch failed on {name}: cudaError {err}")

                rows["spectral"]["gemm_plan_ms"] = cuda_ms(gemm_plan, 5)
                rows["spectral"]["gemm_ceiling_ms"] = spectral_gemm_ceiling_ms(base, 1024)
                if not rel_err(gemm_out, mel) <= TOL:
                    fail(f"launch A's two plans disagree on {name}: {rel_err(gemm_out, mel):.3e}")
        else:
            out = frontend_kernel.spectral_contrast_fused(w, cfg)
            rows["contrast"] = dict(
                ms=cuda_ms(lambda: frontend_kernel.spectral_contrast_fused(w, cfg), 5),
                # The gemm rows take 17-312 ms a call at B = 1024: one timed call.
                plain_ms=None if name in no_plain else cuda_ms(
                    lambda: frontend_kernel.spectral_contrast_reference(w, cfg), 1, warmup=1),
                library_ms=cuda_ms(lambda: frontend.spectral_contrast(w, cfg, method="fft"), 2, warmup=1),
                level=frontend_kernel.contrast_level(cfg),
                plan=plan_name(frontend_kernel, "contrast", cfg),
                **bound(*contrast_work(cfg, 1024)),
            )
            if name == "nfft1024_contrast":
                # Its GEMM plan too, through its C function (at LayoutC's level).
                geo, kc = frontend_kernel._geometry(cfg), frontend_kernel._contrast_constants(cfg, dev)
                gemm_level = frontend_kernel._contrast_gemm_plan(cfg)[0]
                scratch = torch.empty((1024, 128, geo.n_pow), device=dev) if gemm_level == 3 else None
                gemm_out = torch.empty_like(out)

                def gemm_plan() -> None:
                    err = lib.cdt_frontend_contrast(
                        w.data_ptr(), 1024, w.shape[1], cfg.num_frames, cfg.n_fft, cfg.hop_length, geo.j0, geo.kpad,
                        geo.pow_k0, geo.pow_ks, kc.table.data_ptr(), geo.n_pow, geo.n_freqs, kc.freqs.data_ptr(),
                        float(cfg.sample_rate / 2.0), kc.bands.data_ptr(), cfg.n_contrast_bands,
                        None if scratch is None else scratch.data_ptr(), gemm_out.data_ptr(),
                        torch.cuda.current_stream().cuda_stream,
                    )
                    if err:
                        fail(f"the contrast launch's GEMM plan failed on {name}: cudaError {err}")

                rows["contrast"]["gemm_plan_ms"] = cuda_ms(gemm_plan, 3, warmup=1)
                if not rel_err(gemm_out, out) <= TOL:
                    fail(f"the contrast launch's two plans disagree on {name}: {rel_err(gemm_out, out):.3e}")
        if (not cfg.use_spectral_contrast and name not in spectral_only) or name in epilogue_only:
            rows["epilogue"] = dict(
                ms=cuda_ms(lambda: frontend_kernel.mel_epilogue_fused(mel, base), 5),
                plain_ms=cuda_ms(lambda: frontend_kernel.mel_epilogue_reference(mel, base), 2, warmup=1),
                library_ms=None,
                blocks_a_clip=frontend_kernel.epilogue_blocks(base),
                batch=batch,
                **bound(*epilogue_work(base, batch)),
            )
            if not rel_err(frontend_kernel.mel_epilogue_fused(mel, base),
                           frontend_kernel.mel_epilogue_reference(mel, base)) <= TOL:
                fail(f"launch B disagrees with its plain version on {name} B={batch}")
        coverage_timing[name] = rows
        for part, tm in rows.items():
            lib_ms = "none" if tm["library_ms"] is None else f"{tm['library_ms']:.4f} ms"
            gemm = (
                f"; its GEMM design's ceiling {tm['gemm_ceiling_ms']:.4f} ms"
                if "gemm_ceiling_ms" in tm else ""
            ) + (f"; the GEMM plan {tm['gemm_plan_ms']:.4f} ms" if "gemm_plan_ms" in tm else "")
            plan = tm.get("plan", "one")
            if part == "epilogue":
                n = tm["blocks_a_clip"]
                plan = "device memory" if n == 0 else "one block" if n == 1 else f"a cluster of {n} blocks"
            print(
                f"[{smi}] times {part} B={batch} [{name}, {plan} plan]: kernel {tm['ms']:.4f} ms, "
                f"plain {'not timed' if tm['plain_ms'] is None else format(tm['plain_ms'], '.4f') + ' ms'}, "
                f"library {lib_ms}; bound {tm['bound_ms']:.4f} ms by {tm['bound_by']}; "
                f"kernel at {100 * tm['bound_ms'] / tm['ms']:.1f}% of bound{gemm}; {time.perf_counter() - t_cfg:.3f} s "
                "into the config",
                flush=True,
            )
    print(f"every-config launch times: {time.perf_counter() - t0:.3f} s", flush=True)

    # The epilogue launch on the other layouts it takes, at B = 4096, on one
    # batch of waves.
    w = make_audio_bulk(rng, 4096, SR, dev)
    for name, cfg in (("n_fft=256", n_fft_256), ("pcen", FeatureConfig(use_pcen=True))):
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

    # The contrast launch at B = 32-4096 beside its bound, its plain version
    # (the gemm rows), the fft rows (cuFFT: its library yardstick), the
    # torch chain with contrast, the pair alone and the hybrid (all three
    # launches). Its bound counts the operations the function needs, not
    # those of its design: for each frame a real FFT of each window (2.5 n
    # log2 n for n = n_fft, at the FP32 CUDA-core peak, as cuFFT runs it)
    # after the window's multiplies, 3 an element for the bands' power, 6
    # for the magnitude (square, add, sqrt) and the centroid's sums, each
    # band's two tails as selections (a compare a bin for each, then an add
    # a selected bin) and 5 a value for the z-norm; bytes: the waveform read
    # and the rows written once. The GEMM design's own ceiling, its DFT as
    # a GEMM over both windows' nonzero taps at the TF32 tensor-core peak,
    # is printed beside, and the ceiling of the products its GEMM plan
    # issues: three TF32 products over a 128-row tile a clip, the power
    # passes over their k-steps, the magnitude passes over kpad, 256 columns
    # a pass. Budget 10 s.
    t0 = time.perf_counter()
    geo = frontend_kernel._geometry(contrast)
    taps4 = int(np.count_nonzero(filters.padded_window(contrast.win_length, contrast.n_fft)))
    taps5 = int(np.count_nonzero(filters.padded_window(contrast.n_fft, contrast.n_fft)))
    flops_c = contrast_work(contrast, 1)[0]
    gemm_c = t_frames * (2 * taps4 * 2 * geo.n_pow + 2 * taps5 * 2 * geo.n_freqs)
    issued_c = 3 * 2 * 128 * 256 * (8 * geo.pow_ks * geo.pow_passes + geo.kpad * (geo.n_passes - geo.pow_passes))
    base_c = dataclasses.replace(contrast, use_spectral_contrast=False)

    def bound_c(b: int) -> dict:
        return bound(*contrast_work(contrast, b))

    contrast_timing = {}
    for b, iters in ((32, 20), (256, 20), (1024, 10), (4096, 3)):
        w = waves(b)
        tm = dict(
            ms=cuda_ms(lambda: frontend_kernel.spectral_contrast_fused(w, contrast), iters),
            plain_ms=cuda_ms(lambda: frontend_kernel.spectral_contrast_reference(w, contrast), iters),
            library_ms=cuda_ms(lambda: frontend.spectral_contrast(w, contrast, method="fft"), iters),
            chain_ms=cuda_ms(lambda: frontend.extract_features(w, contrast), iters),
            pair_ms=cuda_ms(lambda: frontend_kernel.extract_features_fused(w, base_c), iters),
            hybrid_ms=cuda_ms(lambda: frontend_kernel.extract_features_fused(w, contrast), iters),
            precision="3xTF32",
            gemm_ceiling_ms=b * gemm_c / PEAK_TF32_FLOPS * 1e3,
            issued_ceiling_ms=b * issued_c / PEAK_TF32_FLOPS * 1e3,
            **bound_c(b),
        )
        if b in (256, 1024):
            tm["device_ms"] = device_ms(
                lambda: frontend_kernel.spectral_contrast_fused(w, contrast), iters, "contrast_kernel")
        tm["max_rel_vs_plain"] = rel_err(frontend_kernel.spectral_contrast_fused(w, contrast),
                                         frontend_kernel.spectral_contrast_reference(w, contrast))
        if not tm["max_rel_vs_plain"] <= TOL:
            fail(f"contrast kernel disagrees with its plain version at B={b}: {tm['max_rel_vs_plain']:.3e}")
        contrast_timing[b] = tm
        dev_ms = (
            f"; device time (profiler) {tm['device_ms']:.4f} ms, {100 * tm['bound_ms'] / tm['device_ms']:.1f}% of bound"
            if "device_ms" in tm else ""
        )
        print(
            f"[{smi}] times contrast B={b}: kernel {tm['ms']:.4f} ms (vs plain max-relative "
            f"{tm['max_rel_vs_plain']:.2e}), plain (gemm rows) {tm['plain_ms']:.4f} ms, "
            f"fft rows {tm['library_ms']:.4f} ms; bound {tm['bound_ms']:.4f} ms by {tm['bound_by']} "
            f"({b * flops_c / 1e9:.4f} GFLOP at {PEAK_FP32_FLOPS / 1e12:.0f} TFLOP/s FP32); kernel at "
            f"{100 * tm['bound_ms'] / tm['ms']:.1f}% of bound{dev_ms}; its GEMM design's ceiling "
            f"{tm['gemm_ceiling_ms']:.4f} ms ({b * gemm_c / 1e9:.3f} GFLOP at {PEAK_TF32_FLOPS / 1e12:.0f} "
            f"TFLOP/s TF32), {100 * tm['gemm_ceiling_ms'] / tm['ms']:.1f}% of it; the 3xTF32 products it issues "
            f"{tm['issued_ceiling_ms']:.4f} ms at that peak ({b * issued_c / 1e9:.3f} GFLOP), "
            f"{100 * tm['issued_ceiling_ms'] / tm['ms']:.1f}% of it. Hybrid (three launches) {tm['hybrid_ms']:.4f} "
            f"ms, the pair alone {tm['pair_ms']:.4f} ms, the torch chain with contrast {tm['chain_ms']:.4f} ms",
            flush=True,
        )
    print(f"contrast launch times: {time.perf_counter() - t0:.3f} s (budget 10 s)", flush=True)

    phase("5 serving")
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
        liveness_seconds=float("inf"), backend="native",
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

    phase("6 training")
    # -- 6. the training path -------------------------------------------------------
    trained = train_phase(smi, tuple(made))

    phase("7 files")
    # -- 7. files to detections ----------------------------------------------------------
    files = files_phase(smi, trained["shard"], yard, prepare)

    phase("8 daemon")
    # -- 8. the serving daemon and the native tiers -------------------------------
    daemon = daemon_phase(smi, trained["best_model"], files["data"], files["decode"], trained["shard"])

    phase("9 tools")
    # -- 9. spectral contrast through the hybrid, and the tools between training and serving
    tools = tools_phase(smi, trained, files)

    phase("10 parallel")
    # -- 10. training and scoring across ranks and devices --------------------------------
    par = parallel_phase(smi, trained, files)

    phase("11 graphs")
    # -- 11. captured programs: the graphed tick and steps against the eager ones --------
    graphed = graphs_phase(smi, trained, weights, cfg)

    phase("12 pipelined")
    # -- 12. pipelined epochs and the scoring programs ------------------------------------
    pipelined = pipeline_phase(smi, trained, files)

    phase("13 bench")
    # -- 13. the port's bench --------------------------------------------------------------
    benched = bench_phase(smi, yard)

    phase("14 mesh")
    # -- 14. training over a mesh -----------------------------------------------------------
    meshed = mesh_phase(smi, par)

    phase("15 summary")
    # -- 15. summary ---------------------------------------------------------------
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
            "daemon_launches": daemon["launches"][part],
            "offline_launches": files["offline_launches"][part],
            "offline_batch": 1024,
            "offline_batch_ms": files["b1024"][part]["ms"],
            "offline_batch_device_ms": files["b1024"][part]["device_ms"],
            "offline_batch_bound_ms": files["b1024"][part]["bound"]["bound_ms"],
            "tools_launches": {path: n[part] for path, n in tools["launches"].items()},
            "parallel_launches": {path: n[part] for path, n in par["launches"].items()},
            "graphed_launches": {
                "tick_per_format": {fmt: n["graph"][i] for fmt, n in graphed["tick_launches"].items()},
                "tick_captured_x_replays": graphed["tick_replay_launches"][i],
                "train_2_epochs": graphed["train_launches"]["graph"][i],
                "step_captured_x_replays": graphed["step_replay_launches"][i],
            },
            "pipelined_launches": {
                "train_3_epochs": pipelined["train_launches"]["three"][i],
                "early_stop_2_of_3_epochs": pipelined["train_launches"]["stop"][i],
            },
            "scoring_launches": {path: n[i] for path, n in pipelined["scoring_launches"].items()},
            "scoring_captured_x_replays": {path: n[i] for path, n in pipelined["scoring_replay_launches"].items()},
            "bench_launches": {path: n[part] for path, n in benched["launches"].items()},
            "bench_batch": benched["batch"],
            "bench_program_device_ms": benched["program_device_ms"][part],
            "bench_bound_ms": benched["bounds"][part]["bound_ms"],
            "bench_bound_by": benched["bounds"][part]["bound_by"],
            "mesh_launches": {path: n[part] for path, n in meshed["launches"].items()},
            # Launch A's GEMM plan here; its FFT plan has its own entry below.
            "coverage_main_path_launches": {name: n[f"{part.upper()}_LAUNCHES"]
                                            for name, n in covered["main_path"].items()
                                            if part == "epilogue" or covered["plans"][name]["spectral plan"] < 2},
            "coverage_launches_a_call": {f"{name} B={b}": n[i] for (name, b), n in covered["launches"].items()
                                         if part == "epilogue" or covered["plans"][name]["spectral plan"] < 2},
            "coverage_max_abs_err": covered["max_abs"][part],
            "coverage_b1024": {name: rows[part] for name, rows in coverage_timing.items()
                               if part in rows and rows[part].get("plan", "gemm") == "gemm"},
        }
        for i, part in enumerate(("spectral", "epilogue"))
    ]
    kernels[0]["max_rel_vs_3xtf32_model"] = split_err
    kernels[0]["coverage_max_rel_vs_3xtf32_model"] = covered["model_err"]["spectral"]
    # The contrast launch's path is the contrast config's: phase 9 drives
    # each of its paths with the counters set to 0 just before.
    contrast_launches = {
        path: n["contrast"] for path, n in tools["launches"].items() if n["contrast"]
    }
    kernels.append({
        "name": "frontend_contrast",
        "route": "cuda",
        "source": "cough_detector_tpu_torch/csrc/frontend_kernel.cu",
        "replaces": "cough_detector_tpu/ops/pallas/frontend_kernel.py:326",
        "launches": sum(contrast_launches.values()),
        "tools_launches": contrast_launches,
        "max_abs_err": max_abs["contrast"],
        "max_rel_vs_3xtf32_model": contrast_split_err,
        "batch": main_b,
        **{k: contrast_timing[main_b][k] for k in (
            "ms", "plain_ms", "library_ms", "bound_ms", "bound_by", "device_ms", "precision")},
        "library": "spectral_contrast(method='fft'): cuFFT and torch.topk",
        "by_batch": contrast_timing,
        "coverage_launches_a_call": {f"{name} B={b}": n[2] for (name, b), n in covered["launches"].items()
                                     if n[2] and covered["plans"][name]["contrast level"] < 4},
        "coverage_max_abs_err": covered["max_abs"]["contrast"],
        "coverage_max_rel_vs_3xtf32_model": covered["model_err"]["contrast"],
        "coverage_b1024": {name: rows["contrast"] for name, rows in coverage_timing.items()
                           if "contrast" in rows and rows["contrast"]["plan"] == "gemm"},
    })
    # The FFT plans (spectral_fft_kernel, contrast_fft_kernel): their main
    # paths are the captured ones of phase 3 on n_fft 2048 (with contrast for
    # launch C), on 44.1 kHz at n_fft 1764 (the radix-7 stages) and 1323
    # (odd: launch A's two frames a row) with contrast, on n_fft 2704 with
    # contrast (fft_stage_prime) and on 2192 with contrast (Bluestein's
    # stage), the counters set to 0 just before each; their times phase 4's
    # at B = 1024 on n_fft 2048.
    for part, cfg_name, launch_name, kernel, counter in (
        ("spectral", "nfft2048", "frontend_spectral_fft", "spectral_fft_kernel", "SPECTRAL_FFT_LAUNCHES"),
        ("contrast", "nfft2048_contrast", "frontend_contrast_fft", "contrast_fft_kernel", "CONTRAST_FFT_LAUNCHES"),
    ):
        row = coverage_timing[cfg_name][part]
        paths = (cfg_name, "sr44k_nfft1764_contrast", "sr44k_nfft1323_contrast", "nfft2704_contrast",
                 "nfft2192_contrast")
        kernels.append({
            "name": launch_name,
            "route": "cuda",
            "source": f"cough_detector_tpu_torch/csrc/frontend_kernel.cu ({kernel})",
            "replaces": "cough_detector_tpu/ops/pallas/frontend_kernel.py:278" if part == "spectral"
                        else "cough_detector_tpu/ops/pallas/frontend_kernel.py:326",
            "launches": sum(covered["main_path"][name][counter] for name in paths),
            "main_path_launches": {name: covered["main_path"][name][counter] for name in paths},
            "main_path": f"coverage {' and '.join(paths)}, captured: 1 eager call + 2 replays each",
            "max_abs_err": max(covered["max_abs"][f"{part}_fft"], max_abs.get(f"{part}_fft", 0.0)),
            "max_rel_vs_fft_model": covered["model_err"][f"{part}_fft"],
            "fft_model_tol": FFT_TOL,
            "batch": 1024,
            "config": cfg_name,
            **{k: row[k] for k in ("ms", "plain_ms", "library_ms", "bound_ms", "bound_by")},
            "coverage_launches_a_call": {
                f"{name} B={b}": n[0 if part == "spectral" else 2] for (name, b), n in covered["launches"].items()
                if covered["plans"][name].get("spectral plan" if part == "spectral" else "contrast level", -1)
                == (2 if part == "spectral" else 4)
            },
            "coverage_b1024": {name: rows[part] for name, rows in coverage_timing.items()
                               if part in rows and rows[part].get("plan") == "fft"},
        })
    # Launch B's cluster route (epilogue_cluster_kernel): its main path is
    # the captured one of phase 3 on 10 s clips, the counters set to 0 just
    # before; its time phase 4's at B = 1024 on that config.
    row = coverage_timing["clip10s"]["epilogue"]
    kernels.append({
        "name": "frontend_epilogue_cluster",
        "route": "cuda",
        "source": "cough_detector_tpu_torch/csrc/frontend_kernel.cu (epilogue_cluster_kernel)",
        "replaces": "cough_detector_tpu/ops/pallas/frontend_kernel.py:278",
        "launches": covered["main_path"]["clip10s"]["EPILOGUE_LAUNCHES"],
        "main_path": "coverage clip10s, captured: 1 eager call + 2 replays",
        "max_abs_err": covered["max_abs"]["epilogue_cluster"],
        "config": "clip10s",
        **{k: row[k] for k in ("batch", "ms", "plain_ms", "library_ms", "bound_ms", "bound_by", "blocks_a_clip")},
        "coverage_launches_a_call": {f"{name} B={b}": n[1] for (name, b), n in covered["launches"].items()
                                     if covered["plans"][name]["epilogue blocks"] >= 2},
        "coverage_times": {name: rows["epilogue"] for name, rows in coverage_timing.items()
                           if rows.get("epilogue", {}).get("blocks_a_clip", 1) != 1},
    })
    phase("end")
    print("phase seconds: " + ", ".join(f"{a} {t1 - t0:.1f}" for (a, t0), (_, t1) in zip(starts, starts[1:]))
          + f"; total {starts[-1][1] - starts[0][1]:.1f} s, after {imports_s:.1f} s of imports", flush=True)
    print(json.dumps({"kernels": without_ceilings(kernels)}))
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
