"""Training CLI on the shard corpus, flag-compatible with the JAX package's
(`cough_detector_tpu/cli/train.py`, itself the reference trainer's flags,
reference: src/train.py:521-568), for the modes the port trains:

    python -m cough_detector_tpu_torch.cli.train --shards DIR [--output-dir DIR]
        [--model-type residual] [--epochs N] [--batch-size B] [--lr LR]
        [--weight-decay WD] [--patience P] [--device-corpus auto|always|off]
        [--no-device-corpus] [--mixup [ALPHA]] [--resume CKPT_DIR]
        [--export-pt] [--device cuda]

DIR holds `train/` and `val/` shard directories (data/shards.py). The
decode path (`--data-dir`, ESC-50) is not ported yet (ROADMAP Queue 1 item 10a).
"""

from __future__ import annotations

import argparse
from pathlib import Path


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Train cough detection model (PyTorch port)")
    p.add_argument("--shards", type=str, required=True,
                   help="Shard corpus directory holding train/ and val/")
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
    best = train(
        None,
        args.output_dir,
        config=config,
        resume=args.resume,
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
