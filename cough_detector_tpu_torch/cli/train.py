"""Training CLI, flag-compatible with the JAX package's
(`cough_detector_tpu/cli/train.py`, itself the reference trainer's flags,
reference: src/train.py:521-568), for the modes the port trains:

    python -m cough_detector_tpu_torch.cli.train
        (--data-dir DIR [--no-esc50 | --esc50-dir DIR] [--num-workers N]
         | --shards DIR [--device-corpus auto|always|off] [--no-device-corpus])
        [--output-dir DIR] [--model-type residual] [--epochs N]
        [--batch-size B] [--lr LR] [--weight-decay WD] [--patience P]
        [--mixup [ALPHA]] [--resume CKPT_DIR] [--export-pt] [--device cuda]

`--data-dir` holds cough/ and non_cough/ clips, decoded on the host each
epoch (data/datasets.py); without `--no-esc50` or `--esc50-dir`, ESC-50 is
downloaded to ./datasets, as the JAX CLI does. `--shards` holds `train/`
and `val/` shard directories (data/shards.py, packed by cli/pack.py).
"""

from __future__ import annotations

import argparse
from pathlib import Path


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Train cough detection model (PyTorch port)")
    p.add_argument("--data-dir", type=str, default=None,
                   help="Directory with cough/non_cough subdirectories")
    p.add_argument("--shards", type=str, default=None,
                   help="Shard corpus directory holding train/ and val/ (no "
                        "per-epoch decode; overrides --data-dir and ESC-50)")
    p.add_argument("--output-dir", type=str, default="./checkpoints")
    p.add_argument("--model-type", type=str, default="small",
                   choices=["standard", "small", "residual"])
    p.add_argument("--epochs", type=int, default=100)
    p.add_argument("--batch-size", type=int, default=32)
    p.add_argument("--lr", type=float, default=0.001)
    p.add_argument("--weight-decay", type=float, default=0.01)
    p.add_argument("--patience", type=int, default=15)
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device; 'cpu' to train on the CPU")
    p.add_argument("--num-workers", type=int, default=4,
                   help="Host decode threads of the data-directory loaders")
    p.add_argument("--resume", type=str, default=None,
                   help="Checkpoint directory to resume from (e.g. <out>/latest_model)")
    p.add_argument("--no-device-corpus", action="store_true",
                   help="Stream batches from the host (= --device-corpus off)")
    p.add_argument("--device-corpus", choices=["auto", "always", "off"], default="auto",
                   help="'auto' uploads the int16 corpus once when it fits the "
                        "2 GiB device budget; 'always' uploads it at any size; "
                        "'off' streams batches from the host")
    p.add_argument("--mixup", nargs="?", const=0.2, type=float, default=None,
                   metavar="ALPHA",
                   help="Feature-space MixUp with λ ~ Beta(α, α) (default α 0.2)")
    p.add_argument("--no-esc50", action="store_true")
    p.add_argument("--esc50-dir", type=str, default=None)
    p.add_argument("--export-pt", action="store_true",
                   help="Also export the best model in the reference .pt layout")
    return p


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)

    from ..config import Config, ModelConfig, TrainConfig
    from ..train import checkpoint as ckpt
    from ..train import train

    config = Config(
        model=ModelConfig(model_type=args.model_type),
        train=TrainConfig(
            batch_size=args.batch_size,
            learning_rate=args.lr,
            weight_decay=args.weight_decay,
            epochs=args.epochs,
            patience=args.patience,
            use_mixup=args.mixup is not None,
            mixup_alpha=args.mixup if args.mixup is not None else 0.2,
        ),
    )
    esc50_dir = args.esc50_dir
    use_esc50 = not args.no_esc50 and args.shards is None
    if use_esc50 and esc50_dir is None:
        import zipfile

        from ..data.acquire import download_esc50

        try:
            esc50_dir = download_esc50("./datasets")
        except (OSError, zipfile.BadZipFile) as e:
            # A host with no network trains on the data directory alone.
            if args.data_dir is None:
                raise
            print(f"ESC-50 download failed ({e}); training without it")
            use_esc50 = False

    best = train(
        args.data_dir,
        args.output_dir,
        config=config,
        use_esc50=use_esc50,
        esc50_dir=esc50_dir,
        resume=args.resume,
        num_workers=args.num_workers,
        shards_dir=args.shards,
        device_corpus=(
            False if (args.no_device_corpus or args.device_corpus == "off")
            else True if args.device_corpus == "always"
            else "auto"
        ),
        device=args.device,
    )
    if args.export_pt and Path(best).exists():
        tree, epoch, metrics, cfg = ckpt.load_checkpoint(best)
        out = Path(args.output_dir) / "best_model.pt"
        ckpt.export_torch_checkpoint(str(out), tree["model"], cfg, epoch, metrics)
        print(f"Exported {out}")


if __name__ == "__main__":
    main()
