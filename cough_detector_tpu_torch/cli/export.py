"""Model export CLI, the port of `cough_detector_tpu/cli/export.py`.

    python -m cough_detector_tpu_torch.cli.export --model CKPT --output-dir O
        [--pt] [--program] [--fold-bn] [--batch-size 256] [--device cuda]

From a checkpoint directory of the port's trainer or a reference `.pt`:
  --pt        model.pt in the reference layout (for reference tooling, and
              the JAX package's import_torch_checkpoint);
  --program   serving.pt2, the whole serving function traced by
              torch.export at --batch-size on --device (the front end's
              kernels as custom ops; models/export.py), and
              serving.graph.txt, its graph as text;
  --fold-bn   BatchNorm folded into the convolutions first (an
              inference-only artifact).
"""

from __future__ import annotations

import argparse
from pathlib import Path


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Export a cough-detector model")
    p.add_argument("--model", type=str, required=True,
                   help="Checkpoint: the trainer's directory or a reference .pt")
    p.add_argument("--output-dir", type=str, required=True)
    p.add_argument("--pt", action="store_true", help="Write model.pt")
    p.add_argument("--program", action="store_true",
                   help="Write serving.pt2 and serving.graph.txt")
    p.add_argument("--fold-bn", action="store_true")
    p.add_argument("--batch-size", type=int, default=256)
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device the program is traced for; 'cpu' for the CPU")
    return p


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    if not (args.pt or args.program):
        raise SystemExit("Nothing to do: pass --pt and/or --program")

    from ..models.export import aot_compile, export_serialized, graph_text, make_serving_fn
    from ..models.fuse import fold_batchnorm
    from ..stream.detector import _load_checkpoint
    from ..train.checkpoint import export_torch_checkpoint

    variables, config = _load_checkpoint(args.model)
    if args.fold_bn:
        variables = fold_batchnorm(variables, config.model.model_type)
        print("BatchNorm folded into convolutions")

    out = Path(args.output_dir)
    out.mkdir(parents=True, exist_ok=True)
    wrote = []
    if args.pt:
        path = out / "model.pt"
        export_torch_checkpoint(str(path), variables, config)
        wrote.append(path)
    if args.program:
        fn = make_serving_fn(variables, config, args.device)
        program = aot_compile(fn, args.batch_size, config.features.segment_samples)
        wrote.append(Path(export_serialized(program, str(out / "serving.pt2"))))
        text = out / "serving.graph.txt"
        text.write_text(graph_text(program))
        wrote.append(text)
    for w in wrote:
        print(f"Wrote {w}")


if __name__ == "__main__":
    main()
