"""Model evaluation CLI, the port of `cough_detector_tpu/cli/evaluate.py`.

    python -m cough_detector_tpu_torch.cli.evaluate --model CKPT
        (--data-dir D | --behavioral | --calibrate) [--device cuda] ...

Three modes (reference: src/train.py:114-180; IMPROVEMENT_PLAN.md:199-216,
316-324):

1. Dataset metrics (default): loss, accuracy, precision/recall/F1 and the
   confusion matrix over a labeled cough/non_cough directory or a packed
   shard directory; one JSON summary line.
2. --behavioral: false positives per minute on synthetic silence, voiced
   speech and cough confusables, and the matched detection rate on
   synthetic coughs, through the streaming detector.
3. --calibrate: each scenario scored once, the engine's threshold and
   debounce rule replayed over a threshold sweep, the band meeting every
   target and a recommended threshold (the value `cli.serve --threshold`
   takes). A self-check pins the replay to the live engine at
   --threshold before any sweep number is printed.

`--model` is a checkpoint directory of the port's trainer or a reference
`.pt`. Runs on the card unless given `--device cpu`. Dataset mode splits
each batch over a mesh of devices (`--mesh`, or every visible card when
there are several), padded to a multiple of them with the padded rows
masked, unless `--single-device` is given; the counts equal one device's.
Every batch pads to one shape, and each device's features and logits run
as its replica's captured program (utils.graphs, the JAX CLI's jitted
`step`).
"""

from __future__ import annotations

import argparse
import json


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Evaluate a cough detector")
    p.add_argument("--model", type=str, required=True,
                   help="Checkpoint: the trainer's directory or a reference .pt")
    p.add_argument("--data-dir", type=str, default=None,
                   help="Labeled cough/non_cough directory or packed shard "
                        "directory (dataset mode)")
    p.add_argument("--batch-size", type=int, default=256)
    p.add_argument("--num-workers", type=int, default=8)
    p.add_argument("--behavioral", action="store_true",
                   help="Run the synthetic behavioral protocol instead")
    p.add_argument("--calibrate", action="store_true",
                   help="Sweep detection thresholds over the behavioral "
                        "scenarios and report the operating band meeting "
                        "all targets + a recommended threshold")
    p.add_argument("--single-device", action="store_true",
                   help="Dataset mode on --device alone, not split over the "
                        "visible cards")
    p.add_argument("--mesh", type=str, default=None, metavar="DEV,DEV,...",
                   help="Devices dataset-mode batches split over (e.g. "
                        "cuda:0,cuda:1; a device may repeat); default every "
                        "visible card with --device cuda")
    p.add_argument("--threshold", type=float, default=0.7)
    p.add_argument("--grid-step", type=float, default=0.05,
                   help="--calibrate threshold sweep granularity over "
                        "[0.05, 0.99]")
    p.add_argument("--minutes", type=float, default=2.0,
                   help="Synthetic audio minutes per behavioral scenario")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device; 'cpu' to evaluate on the CPU")
    return p


def _dataset_eval(args) -> None:
    import copy
    from pathlib import Path

    import numpy as np
    import torch

    from .. import parallel
    from ..data.datasets import BatchLoader, CoughDataset
    from ..data.shards import MANIFEST, ShardLoader
    from ..models import model_from_config, place_model
    from ..stream.detector import _load_checkpoint
    from ..train import steps
    from ..train.loop import _accumulate, make_feature_fns
    from ..utils import graphs
    from ..utils.device import resolve_device

    mesh = None if args.single_device else parallel.resolve_mesh(parallel.mesh_arg(args.mesh), args.device)
    devices = [resolve_device(args.device)] if mesh is None else mesh.devices
    variables, config = _load_checkpoint(args.model)
    model = model_from_config(config.model)
    model.load_state_dict({k: torch.as_tensor(v) for k, v in variables.items()})
    replicas = [place_model(copy.deepcopy(model), d) for d in devices]
    if (Path(args.data_dir) / MANIFEST).exists():
        # A packed shard directory (cli.pack): decode-free bulk scoring.
        loader = ShardLoader(args.data_dir, args.batch_size, feature_config=config.features)
        n_clips = loader.n_clips
    else:
        ds = CoughDataset(args.data_dir)
        n_clips = len(ds)
        loader = BatchLoader(ds, args.batch_size, config.features, num_workers=args.num_workers)
    if n_clips == 0:
        raise SystemExit(f"No clips under {args.data_dir}")

    features = [make_feature_fns(config, d, use_time_shift=False)[1] for d in devices]
    # A replica's graphs hold its parameters' addresses: programs of its own.
    programs = [graphs.Programs(d, name="evaluate", pool=graphs.scoring_pool(d)) for d in devices]
    home = devices[0]
    class_weights = torch.ones(2, device=home)
    # Every batch pads to one shape, a multiple of the devices, under a mask
    # that keeps the padded rows out of the loss and the counts. Each device
    # scores its block; the metrics come from the joined logits.
    pad_to = -(-args.batch_size // len(devices)) * len(devices)
    bounds = [(0, pad_to)] if mesh is None else mesh.blocks(pad_to)
    pending = []
    with torch.no_grad():
        for waves, labels in loader:
            n = len(labels)
            waves = np.pad(waves, ((0, pad_to - n), (0, 0)))
            labels = torch.from_numpy(np.pad(labels, (0, pad_to - n)).astype(np.int64)).to(home)
            mask = None if n == pad_to else torch.from_numpy((np.arange(pad_to) < n).astype(np.float32)).to(home)
            logits = []
            for replica, feature_fn, progs, (lo, hi) in zip(replicas, features, programs, bounds):
                w = waves[lo:hi]
                (out,) = progs(
                    (w.shape, str(w.dtype)),
                    lambda s, replica=replica, feature_fn=feature_fn: (replica(feature_fn(s["waves"])),),
                    {"waves": w},
                )
                logits.append(out.to(home))
            pending.append(steps.eval_metrics(torch.cat(logits), labels, class_weights, mask))
    print(json.dumps(_accumulate(pending)[0].summary()))


def match_detections(det_times, event_starts, span: float = 3.0):
    """Match detection timestamps to known event windows.

    A detection at time t matches event i iff
    event_starts[i] <= t <= event_starts[i] + span; repeated detections of
    one event count once, and detections matching no event are spurious, so
    a double fire on one cough cannot mask a miss elsewhere.

    Returns (matched_indices, n_spurious).
    """
    matched = set()
    spurious = 0
    for t in det_times:
        hit = None
        for i, start in enumerate(event_starts):
            if start <= t <= start + span:
                hit = i
                break
        if hit is None:
            spurious += 1
        else:
            matched.add(hit)
    return matched, spurious


def _scenario_signals(seed: int, minutes: float):
    """The behavioral scenarios (silence, speech, (coughs, starts),
    confusables), as numpy float32 signals equal bit for bit to the JAX
    CLI's for a seed: silence; voiced synthetic speech with a band-limited
    AM babble segment every 4th slot; a synthetic cough every 5 s; laughs
    and throat clears every ~4 s. Scenario clips are drawn from seeds
    salted away from the training corpus's (corpus seed + i)."""
    import numpy as np

    from ..data import synth
    from ..data.audio_io import resample_np

    sr = 16000
    seconds = int(minutes * 60)
    rng = np.random.default_rng(seed)

    def salted(k: int) -> int:
        return int(
            np.random.SeedSequence([seed, 0xE7A1BE, k]).generate_state(1)[0]
        )

    silence = (rng.standard_normal(seconds * sr) * 1e-4).astype(np.float32)

    speech = (rng.standard_normal(seconds * sr) * 1e-4).astype(np.float32)
    pos, k = 0, 0
    while pos < seconds * sr:
        if k % 4 == 3:  # band-limited AM babble
            dur = 3 * sr
            t = np.arange(dur) / sr
            envelope = 0.5 * (1 + np.sin(2 * np.pi * 3.0 * t))
            carrier = rng.standard_normal(dur).astype(np.float32)
            band = resample_np(
                resample_np(carrier[None], sr, 8000), 8000, sr
            )[0][:dur]
            seg = (envelope[: len(band)] * band * 0.1).astype(np.float32)
        else:
            seg = synth.synthetic_speech(salted(k), 3.0)
        end = min(pos + len(seg), seconds * sr)
        speech[pos:end] += seg[: end - pos]
        pos = end + int(0.3 * sr)
        k += 1

    n_coughs = seconds // 5
    coughs = (rng.standard_normal(seconds * sr) * 1e-3).astype(np.float32)
    starts = []
    for i in range(n_coughs):
        c = synth.synthetic_cough(salted(1_000 + i), 2.0)
        start = i * 5 * sr
        coughs[start : start + len(c)] += c
        starts.append(start / sr)

    confusables = (rng.standard_normal(seconds * sr) * 1e-4).astype(np.float32)
    pos, k = 0, 0
    while pos + 2 * sr <= seconds * sr:
        gen = synth.synthetic_laugh if k % 2 == 0 else synth.synthetic_throat_clear
        seg = gen(salted(2_000 + k), 2.0)
        confusables[pos : pos + len(seg)] += seg
        pos += len(seg) + 2 * sr
        k += 1
    return silence, speech, (coughs, starts), confusables


def _detector(args):
    from ..stream import StreamingDetector

    return StreamingDetector(
        args.model, device=args.device, num_streams=1, chunk_size=1600,
        confidence_threshold=args.threshold, smoothing_window=3,
        debounce_seconds=0.5,
    )


def _behavioral_eval(args) -> None:
    det = _detector(args)
    silence, speech, (signal, starts), confusables = _scenario_signals(
        args.seed, args.minutes
    )
    n_coughs = len(starts)

    def run(sig) -> int:
        det.reset()
        return len(det.process_chunk(sig[None, :]))

    fp_silence = run(silence) / args.minutes
    fp_speech = run(speech) / args.minutes
    fp_confusables = run(confusables) / args.minutes

    det.reset()
    events = det.process_chunk(signal[None, :])
    matched, spurious = match_detections([d.time_seconds for d in events], starts)
    detection_rate = len(matched) / max(n_coughs, 1)

    print(json.dumps({
        "fp_per_min_silence": fp_silence,
        "fp_per_min_speech": fp_speech,
        "fp_per_min_confusables": fp_confusables,
        "cough_detection_rate": detection_rate,
        "coughs_matched": len(matched),
        "coughs_missed": n_coughs - len(matched),
        "spurious_detections": spurious,
        "targets": {
            "fp_per_min_silence": 0.0,
            "fp_per_min_speech": "<1",
            "fp_per_min_confusables": "<1 (extended target: laughs + throat clears)",
            "cough_detection_rate": ">0.8",
        },
    }))


def _replay_events(smoothed, thr, debounce_windows, hop, window, sr):
    """Replay the engine's fire rule over a smoothed-confidence series:
    window i fires iff smoothed[i] >= thr and i - last_fire >=
    debounce_windows (stream/ring.py, integer-window arithmetic). Returns
    event times in seconds."""
    times = []
    last = -(1 << 24)
    for i, s in enumerate(smoothed):
        if s >= thr and i - last >= debounce_windows:
            last = i
            times.append((i * hop + window) / sr)
    return times


def _calibrate(args) -> None:
    """Score each behavioral scenario once (confidences do not depend on the
    threshold), check the replay against the live engine at --threshold,
    then replay the threshold and debounce rule over the sweep: the band
    meeting 0 FP/min on silence, <1 FP/min on speech and >80% matched
    detection (and, strict, <1 FP/min on confusables), and its midpoint as
    the recommended threshold."""
    import numpy as np

    det = _detector(args)
    sr = det.config.features.sample_rate
    window = det.window_samples
    hop = int(sr * det.stream_config.hop_duration)
    W = det.stream_config.smoothing_window
    debounce_windows = -(-int(round(0.5 * sr)) // hop)

    silence, speech, (coughs, starts), confusables = _scenario_signals(
        args.seed, args.minutes
    )
    n_coughs = len(starts)

    def smoothed_series(signal):
        n_win = (len(signal) - window) // hop + 1
        wins = np.stack([signal[i * hop : i * hop + window] for i in range(n_win)])
        probs = np.concatenate([
            det.scores_for(wins[i : i + 256]) for i in range(0, n_win, 256)
        ])
        # Trailing mean over the last min(i+1, W) windows, the ring's
        # per-lane smoothing.
        return np.array([probs[max(0, i - W + 1) : i + 1].mean() for i in range(n_win)])

    signals = {"silence": silence, "speech": speech, "coughs": coughs, "confusables": confusables}
    series = {name: smoothed_series(sig) for name, sig in signals.items()}

    def replay(name, thr):
        return _replay_events(series[name], thr, debounce_windows, hop, window, sr)

    for name, sig in signals.items():
        det.reset()
        live = det.process_chunk(sig[None, :])
        replayed = replay(name, args.threshold)
        if len(live) != len(replayed):
            raise SystemExit(
                f"replay self-check failed on {name}: engine {len(live)} "
                f"events vs replay {len(replayed)}"
            )

    sweep = []
    step = args.grid_step
    grid = np.round(np.arange(0.05, 0.99 + step / 2, step), 2)
    for thr in grid[grid <= 0.99]:
        fp_sil = len(replay("silence", thr)) / args.minutes
        fp_sp = len(replay("speech", thr)) / args.minutes
        fp_conf = len(replay("confusables", thr)) / args.minutes
        matched, spurious = match_detections(replay("coughs", thr), starts)
        rate = len(matched) / max(n_coughs, 1)
        sweep.append({
            "threshold": float(thr),
            "fp_per_min_silence": fp_sil,
            "fp_per_min_speech": fp_sp,
            "fp_per_min_confusables": fp_conf,
            "cough_detection_rate": rate,
            "spurious_on_coughs": spurious,
            "passes": bool(fp_sil == 0.0 and fp_sp < 1.0 and rate > 0.8),
            "passes_strict": bool(
                fp_sil == 0.0 and fp_sp < 1.0 and fp_conf < 1.0 and rate > 0.8
            ),
        })

    def _band(key):
        passing = [r["threshold"] for r in sweep if r[key]]
        return [min(passing), max(passing)] if passing else None

    band = _band("passes")
    recommended = round((band[0] + band[1]) / 2, 2) if band is not None else None
    print(json.dumps({
        "sweep": sweep,
        "passing_band": band,
        "passing_band_strict": _band("passes_strict"),
        "recommended_threshold": recommended,
        "self_check": f"replay == live engine at threshold {args.threshold}",
        "targets": {
            "fp_per_min_silence": 0.0,
            "fp_per_min_speech": "<1",
            "fp_per_min_confusables": "<1 (strict band only)",
            "cough_detection_rate": ">0.8",
        },
    }))


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    if args.calibrate:
        _calibrate(args)
    elif args.behavioral:
        _behavioral_eval(args)
    else:
        if not args.data_dir:
            raise SystemExit("--data-dir required (or use --behavioral)")
        _dataset_eval(args)


if __name__ == "__main__":
    main()
