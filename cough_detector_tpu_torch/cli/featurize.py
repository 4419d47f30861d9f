"""Batched offline featurization CLI, the port's copy of
`cough_detector_tpu/cli/featurize.py`: a directory of clips → (N, H, T)
features in one .npz, with clips/s.

    python -m cough_detector_tpu_torch.cli.featurize --data-dir D --output f.npz
        [--batch-size 512] [--num-workers 16] [--augment] [--seed S]
        [--config CONFIG] [--device cuda]

The host decodes and crops (data.datasets.BatchLoader); on the device each
batch is peak-normalized, optionally augmented with the training chain
(p = 0.3, draws from a generator seeded with --seed), and featurized by
`extract_features_fast`: the fused kernel pair on the card (with the
contrast rows appended for a config with spectral contrast). The feature
geometry is the shipped config's, or `--config`'s (a config JSON or a
checkpoint directory, as cli.pack takes it). Runs on the card unless given
`--device cpu`.
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Batch-featurize a directory of audio clips")
    p.add_argument("--data-dir", type=str, required=True,
                   help="Directory with cough/non_cough subdirs, or flat clips")
    p.add_argument("--output", type=str, required=True,
                   help="Output .npz path (features, labels, paths)")
    p.add_argument("--batch-size", type=int, default=512)
    p.add_argument("--num-workers", type=int, default=16)
    p.add_argument("--augment", action="store_true",
                   help="Apply the training augmentation chain on the device")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--config", type=str, default=None,
                   help="Config JSON or checkpoint directory whose feature "
                        "config to use (default: the shipped one)")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device; 'cpu' to featurize on the CPU")
    return p


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)

    import numpy as np
    import torch

    from ..augment import augment_waveforms
    from ..data import audio_io
    from ..data.datasets import BatchLoader, ClipDataset, CoughDataset
    from ..ops import frontend
    from ..utils.device import resolve_device
    from ..utils.observability import Throughput
    from .pack import read_feature_config

    dev = resolve_device(args.device)
    cfg = read_feature_config(args.config)
    root = Path(args.data_dir)
    if (root / "cough").exists() or (root / "non_cough").exists():
        dataset = CoughDataset(str(root))
    else:
        clips = [
            (str(f), -1)
            for f in sorted(root.rglob("*"))
            if f.suffix.lower() in audio_io.AUDIO_EXTENSIONS
        ]
        dataset = ClipDataset(clips)
    if len(dataset) == 0:
        raise SystemExit(f"No audio clips found under {args.data_dir}")

    loader = BatchLoader(dataset, args.batch_size, cfg, num_workers=args.num_workers)
    gen = torch.Generator(device=dev).manual_seed(args.seed)

    @torch.no_grad()
    def featurize(waves: torch.Tensor) -> torch.Tensor:
        waves = frontend.peak_normalize(waves)
        if args.augment:
            waves = augment_waveforms(waves, gen, p=0.3, sample_rate=cfg.sample_rate)
        return frontend.extract_features_fast(waves, cfg, device=dev)

    feats_out, labels_out = [], []
    # Steady throughput leaves out the first batch, which builds the
    # kernels on the card.
    steady = Throughput(warmup=1)
    t0 = time.perf_counter()
    n = 0
    for waves, labels in loader:
        steady.start()
        w = torch.from_numpy(waves)
        if dev.type == "cuda":
            w = w.pin_memory().to(dev, non_blocking=True)
        feats_out.append(featurize(w).cpu().numpy())
        labels_out.append(labels)
        steady.stop(len(labels))
        n += len(labels)
    dt = time.perf_counter() - t0

    features = np.concatenate(feats_out)
    labels = np.concatenate(labels_out)
    np.savez_compressed(
        args.output,
        features=features,
        labels=labels,
        paths=np.asarray([p for p, _ in dataset.samples]),
    )
    print(json.dumps({
        "clips": int(n),
        "feature_shape": list(features.shape[1:]),
        "seconds": round(dt, 3),
        "clips_per_sec": round(n / dt, 1),
        "steady_clips_per_sec": round(steady.items_per_sec, 1),
        "device": str(dev),
        "output": args.output,
    }))


if __name__ == "__main__":
    main()
