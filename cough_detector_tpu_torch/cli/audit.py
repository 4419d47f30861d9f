"""Dataset quality audit, the port of `cough_detector_tpu/cli/audit.py`.

    python -m cough_detector_tpu_torch.cli.audit --data-dir D
        [--report audit_report.jsonl] [--model CKPT] [--device cuda]

Per-clip health checks (decode failure, silence, clipping, short duration,
DC offset) over a cough/non_cough directory, and with `--model` the
clips whose label the model disagrees with (p_cough > 0.5 against the
label), scored on the card in batches on the checkpoint's own geometry.
Writes one JSON record per clip to the report and prints the counts
(reference: IMPROVEMENT_PLAN.md:220-283, the audit tool it proposed).
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Audit a cough/non_cough dataset")
    p.add_argument("--data-dir", type=str, required=True)
    p.add_argument("--report", type=str, default="audit_report.jsonl")
    p.add_argument("--model", type=str, default=None,
                   help="Optional checkpoint: also flag label/model disagreements")
    p.add_argument("--silence-rms", type=float, default=1e-4,
                   help="RMS below this (post peak-normalize scale) = silent")
    p.add_argument("--clip-fraction", type=float, default=0.01,
                   help="Fraction of |x|>0.999 samples considered clipping")
    p.add_argument("--batch-size", type=int, default=256)
    p.add_argument("--num-workers", type=int, default=8,
                   help="Accepted for the JAX CLI's command lines; clips "
                        "decode in this thread")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device for --model scoring; 'cpu' for the CPU")
    return p


def _clip_flags(mono, cfg, args) -> list:
    """The health flags of one decoded clip."""
    import numpy as np

    flags = []
    if len(mono) < cfg.sample_rate * 0.2:
        flags.append("short")
    rms = float(np.sqrt(np.mean(mono**2))) if len(mono) else 0.0
    if rms < args.silence_rms:
        flags.append("silent")
    if len(mono) and np.mean(np.abs(mono) > 0.999) > args.clip_fraction:
        flags.append("clipped")
    if len(mono) and abs(float(np.mean(mono))) > 0.05:
        flags.append("dc_offset")
    return flags


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)

    import numpy as np

    from ..config import FeatureConfig
    from ..data import audio_io
    from ..data.datasets import CoughDataset

    cfg = FeatureConfig()
    ds = CoughDataset(args.data_dir)
    if len(ds) == 0:
        raise SystemExit(f"No clips under {args.data_dir}")

    scorer = None
    if args.model:
        from ..stream.detector import StreamingDetector

        det = StreamingDetector(args.model, device=args.device)
        scorer = det.scores_for
        # Crop and score on the checkpoint's geometry, not the default one.
        cfg = det.config.features

    counts = {
        "total": len(ds), "decode_failed": 0, "silent": 0, "clipped": 0,
        "short": 0, "dc_offset": 0, "label_disagreement": 0, "healthy": 0,
    }

    def audit_batch(samples, report) -> None:
        waves = np.zeros((len(samples), cfg.segment_samples), np.float32)
        flags, durations = [], []
        for i, (path, _) in enumerate(samples):
            try:
                mono = audio_io.load_mono_16k(path, cfg.sample_rate)
            except audio_io.AudioDecodeError:
                flags.append(["decode_failed"])
                durations.append(0.0)
                continue
            durations.append(len(mono) / cfg.sample_rate)
            flags.append(_clip_flags(mono, cfg, args))
            n = min(len(mono), cfg.segment_samples)
            start = max(0, (len(mono) - n) // 2)
            waves[i, (cfg.segment_samples - n) // 2 :][:n] = mono[start : start + n]
        for f in flags:
            for name in f:
                counts[name] += 1

        probs = scorer(waves) if scorer is not None else None
        for i, (path, label) in enumerate(samples):
            rec = {
                "path": path, "label": label,
                "duration_s": round(durations[i], 3),
                "flags": flags[i],
            }
            if probs is not None and "decode_failed" not in flags[i]:
                p_cough = float(probs[i])
                rec["p_cough"] = round(p_cough, 4)
                if (label == 1) != (p_cough > 0.5):
                    rec["flags"] = flags[i] + ["label_disagreement"]
                    counts["label_disagreement"] += 1
            if not rec["flags"]:
                counts["healthy"] += 1
            report.write(json.dumps(rec) + "\n")

    with Path(args.report).open("w") as report:
        for lo in range(0, len(ds.samples), args.batch_size):
            audit_batch(ds.samples[lo : lo + args.batch_size], report)

    print(json.dumps(counts))
    print(f"Report: {args.report}")


if __name__ == "__main__":
    main()
