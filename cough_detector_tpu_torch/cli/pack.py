"""Shard-packing CLI, the port's copy of `cough_detector_tpu/cli/pack.py`:
decode a clip corpus once into memory-mappable int16 waveform shards that
`cli.train --shards` reads with no per-epoch decode (data/shards.py).

    python -m cough_detector_tpu_torch.cli.pack --data-dir ./data --output ./shards

packs a cough/non_cough directory into <output>/{train,val} with the seeded
stratified split direct training uses (prepare_dataset_split, seed 42,
reference: src/dataset.py:421-483), so shard-fed and decode-fed runs train
on identical corpora; the shards equal the JAX CLI's.
"""

from __future__ import annotations

import argparse
import json
import time


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="Pack audio into pre-decoded int16 waveform shards"
    )
    p.add_argument("--data-dir", type=str, required=True,
                   help="Directory with cough/non_cough subdirectories")
    p.add_argument("--output", type=str, required=True,
                   help="Output shard directory (train/ and val/ created)")
    p.add_argument("--val-split", type=float, default=0.2)
    p.add_argument("--shard-size", type=int, default=8192,
                   help="Clips per shard file")
    p.add_argument("--num-workers", type=int, default=8)
    p.add_argument("--no-split", action="store_true",
                   help="Pack the whole directory into <output> directly "
                        "(no train/val subdirectories)")
    p.add_argument("--config", type=str, default=None,
                   help="Config JSON (train's <output>/config.json) or a "
                        "checkpoint directory (meta.json's config_full): "
                        "pack at ITS feature geometry so the shards match "
                        "the model they will train/evaluate "
                        "(ShardLoader rejects mismatched geometry loudly)")
    p.add_argument("--sample-rate", type=int, default=None,
                   help="Override the pack sample rate (Hz)")
    p.add_argument("--segment-duration", type=float, default=None,
                   help="Override the clip segment length (seconds)")
    return p


def read_feature_config(path) -> "FeatureConfig":
    """The FeatureConfig of a config JSON (train's <output>/config.json) or
    a checkpoint directory (meta.json's config_full, else its flat config);
    the shipped defaults for None."""
    import json as _json
    from pathlib import Path

    from ..config import Config, FeatureConfig

    if not path:
        return FeatureConfig()
    path = Path(path)
    if not path.is_dir():
        return Config.from_json(path.read_text()).features
    meta = path / "meta.json"
    if not meta.exists():
        raise SystemExit(
            f"--config {path} is a directory with no meta.json — "
            "expected a checkpoint directory or a config JSON file"
        )
    doc = _json.loads(meta.read_text())
    full = doc.get("config_full")
    return (
        Config.from_json(_json.dumps(full)).features
        if full
        else Config.from_flat_dict(doc["config"]).features
    )


def _feature_config(args) -> "FeatureConfig":
    """Resolve the pack geometry: defaults < --config < explicit flags.
    The geometry travels in the manifest; ShardLoader cross-checks it
    against the training FeatureConfig (data/shards.py:158-176), so a
    corpus packed here is verifiably tied to the config it was packed for."""
    import dataclasses

    cfg = read_feature_config(args.config)
    overrides = {}
    if args.sample_rate is not None:
        overrides["sample_rate"] = args.sample_rate
    if args.segment_duration is not None:
        overrides["segment_duration"] = args.segment_duration
    return dataclasses.replace(cfg, **overrides) if overrides else cfg


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)

    from pathlib import Path

    from ..data.datasets import CoughDataset, prepare_dataset_split
    from ..data.shards import write_shards

    cfg = _feature_config(args)
    t0 = time.perf_counter()
    if args.no_split:
        parts = {"": CoughDataset(args.data_dir)}
    else:
        train_ds, val_ds = prepare_dataset_split(
            args.data_dir, val_split=args.val_split
        )
        parts = {"train": train_ds, "val": val_ds}

    report = {}
    for name, ds in parts.items():
        manifest = write_shards(
            ds, str(Path(args.output) / name), cfg,
            shard_size=args.shard_size, num_workers=args.num_workers,
        )
        report[name or "all"] = {
            "clips": manifest["n_clips"],
            "shards": len(manifest["shards"]),
            "class_counts": manifest["class_counts"],
        }
    print(json.dumps({
        "output": args.output,
        "sample_rate": cfg.sample_rate,
        "segment_duration": cfg.segment_duration,
        "seconds": round(time.perf_counter() - t0, 3),
        **report,
    }))


if __name__ == "__main__":
    main()
