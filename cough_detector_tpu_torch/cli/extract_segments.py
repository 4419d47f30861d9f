"""Segment extraction from long recordings, the port of
`cough_detector_tpu/cli/extract_segments.py`.

    python -m cough_detector_tpu_torch.cli.extract_segments --input-dir D
        --output-dir O [--mode energy|uniform] [--model CKPT
        --min-confidence X --max-confidence Y] [--device cuda]

Two modes over a directory of long recordings (reference:
IMPROVEMENT_PLAN.md:222-267, the extractors it proposed):

  --mode energy   high-energy bursts (short-time RMS within --threshold-db
                  of the recording's loudest frame, at least
                  --min-duration long), one segment-length window cut
                  around each;
  --mode uniform  every file tiled into consecutive segment-length clips.

With --model, every candidate is scored on the card in batches of at most
SCORE_BATCH windows, and only those within [--min-confidence,
--max-confidence] are written. One recording at a time: memory is bounded
by one file's length, not the corpus's.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

# Windows a scoring batch holds at most.
SCORE_BATCH = 1024


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="Extract training segments from long recordings"
    )
    p.add_argument("--input-dir", type=str, required=True,
                   help="Directory of long .wav recordings")
    p.add_argument("--output-dir", type=str, required=True)
    p.add_argument("--mode", choices=["energy", "uniform"], default="energy")
    p.add_argument("--threshold-db", type=float, default=-30.0,
                   help="Energy gate relative to the recording's peak frame")
    p.add_argument("--min-duration", type=float, default=0.1,
                   help="Minimum burst length in seconds (energy mode)")
    p.add_argument("--segment-duration", type=float, default=1.0)
    p.add_argument("--model", type=str, default=None,
                   help="Optional checkpoint to score candidates")
    p.add_argument("--min-confidence", type=float, default=None,
                   help="Keep only segments the model scores at/above this")
    p.add_argument("--max-confidence", type=float, default=None,
                   help="Keep only segments the model scores at/below this")
    p.add_argument("--prefix", type=str, default="seg")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device for --model scoring; 'cpu' for the CPU")
    return p


def find_energy_bursts(
    wave,
    sample_rate: int,
    threshold_db: float = -30.0,
    min_duration: float = 0.1,
    frame_s: float = 0.025,
    hop_s: float = 0.010,
):
    """[(start_sample, end_sample)] of runs of frames whose RMS is within
    `threshold_db` of the loudest frame, at least `min_duration` long. Host
    numpy: curation over files of any length, not a hot path."""
    import numpy as np

    frame = max(1, int(sample_rate * frame_s))
    hop = max(1, int(sample_rate * hop_s))
    n = (len(wave) - frame) // hop + 1
    if n <= 0:
        return []
    idx = np.arange(n)[:, None] * hop + np.arange(frame)[None, :]
    rms = np.sqrt(np.mean(np.asarray(wave)[idx] ** 2, axis=1) + 1e-12)
    db = 20.0 * np.log10(rms + 1e-12)
    gate = db >= (db.max() + threshold_db)

    bursts = []
    start = None
    for i, hot in enumerate(gate):
        if hot and start is None:
            start = i
        elif not hot and start is not None:
            bursts.append((start, i))
            start = None
    if start is not None:
        bursts.append((start, n))

    min_frames = max(1, int(round(min_duration / hop_s)))
    return [(s * hop, e * hop + frame) for s, e in bursts if e - s >= min_frames]


def _cut(wave, center: int, seg: int):
    """A `seg`-sample window starting seg // 2 before `center`, clipped to
    the recording and zero-filled past its end."""
    import numpy as np

    out = np.zeros(seg, np.float32)
    lo = max(0, center - seg // 2)
    hi = min(len(wave), lo + seg)
    out[: hi - lo] = wave[lo:hi]
    return out


def _make_scorer(model_path: str, device: str = "cuda"):
    """(N, seg) numpy windows → (N,) cough probabilities: peak normalize →
    front end → classifier → softmax, on `device`, SCORE_BATCH windows at a
    time."""
    import numpy as np

    from ..stream.detector import StreamingDetector

    det = StreamingDetector(model_path, device=device)

    def score_np(waves: "np.ndarray") -> "np.ndarray":
        return np.concatenate([
            det.scores_for(waves[lo : lo + SCORE_BATCH])
            for lo in range(0, waves.shape[0], SCORE_BATCH)
        ]).astype(np.float32)

    return score_np


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)

    import numpy as np

    from ..config import FeatureConfig
    from ..data import audio_io

    cfg = FeatureConfig(segment_duration=args.segment_duration)
    sr = cfg.sample_rate
    seg = cfg.segment_samples
    in_dir = Path(args.input_dir)
    out_dir = Path(args.output_dir)
    out_dir.mkdir(parents=True, exist_ok=True)

    files = sorted(
        f for f in in_dir.rglob("*")
        if f.suffix.lower() in audio_io.AUDIO_EXTENSIONS
    )
    if not files:
        raise SystemExit(f"No recordings under {args.input_dir}")

    if args.model is None and (
        args.min_confidence is not None or args.max_confidence is not None
    ):
        # Ignoring the bounds would write every candidate while the user
        # believes the set is curated.
        raise SystemExit(
            "--min-confidence/--max-confidence require --model: without a "
            "scorer there is nothing to filter on"
        )
    scorer = _make_scorer(args.model, args.device) if args.model is not None else None
    conf_lo = args.min_confidence if args.min_confidence is not None else -1.0
    conf_hi = args.max_confidence if args.max_confidence is not None else 2.0

    n_candidates = 0
    n_written = 0
    for f in files:
        wave = audio_io.load_mono_16k(str(f), sr).astype(np.float32)
        if args.mode == "uniform":
            spans = [
                (lo, min(lo + seg, len(wave)))
                for lo in range(0, max(len(wave) - seg + 1, 1), seg)
            ]
        else:
            spans = find_energy_bursts(wave, sr, args.threshold_db, args.min_duration)
        if not spans:
            continue
        segments = np.stack([_cut(wave, (lo + hi) // 2, seg) for lo, hi in spans])
        n_candidates += len(spans)

        keep = np.ones(len(spans), bool)
        if scorer is not None:
            probs = scorer(segments)
            keep = (probs >= conf_lo) & (probs <= conf_hi)

        # Named by the path relative to the input dir, flattened, so
        # same-named recordings in different subdirectories do not clash.
        stem = "_".join(f.relative_to(in_dir).with_suffix("").parts)
        for i in np.nonzero(keep)[0]:
            audio_io.write_wav(out_dir / f"{args.prefix}_{stem}_{int(i):03d}.wav", segments[i], sr)
            n_written += 1

    print(json.dumps({
        "recordings": len(files),
        "candidates": n_candidates,
        "written": n_written,
        "mode": args.mode,
        "scored": scorer is not None,
        "output": str(out_dir),
    }))


if __name__ == "__main__":
    main()
