"""Dataset preparation CLI (reference: prepare_data.py, setup_data.py),
the port's copy of `cough_detector_tpu/cli/prepare_data.py`:

    python -m cough_detector_tpu_torch.cli.prepare_data --output-dir D
        [--skip-download] [--synthetic-coughs N] [--synthetic-non-coughs N]
        [--hard-negatives FRAC] [--hard-negative-weights K=W,...] [--seed S]

Downloads ESC-50 unless it is present or `--skip-download` is given,
reorganizes it into cough/non_cough, and writes deterministic synthetic
clips (data/acquire.py), byte for byte the JAX CLI's.
"""

from __future__ import annotations

import argparse


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Prepare cough training data")
    p.add_argument("--output-dir", type=str, default="./data")
    p.add_argument("--esc50-dir", type=str, default="./datasets",
                   help="Where ESC-50 lives / should be downloaded")
    p.add_argument("--skip-download", action="store_true")
    p.add_argument("--synthetic-coughs", type=int, default=50)
    p.add_argument("--synthetic-non-coughs", type=int, default=100)
    p.add_argument("--hard-negatives", type=float, default=0.0,
                   metavar="FRAC",
                   help="Fraction of synthetic negatives drawn from the "
                        "cough-confusable vocabulary (voiced speech, "
                        "laughs, throat clears) instead of stationary "
                        "noise — the hard-negative curation step "
                        "(reference IMPROVEMENT_PLAN.md:81-85)")
    p.add_argument("--hard-negative-weights", type=str, default=None,
                   metavar="K=W,...",
                   help="Skew the hard-negative kind mix, e.g. "
                        "'laugh=0.5,throat_clear=0.3,speech=0.2' "
                        "(kinds: speech, laugh, throat_clear; weights "
                        "normalized). Default: uniform")
    p.add_argument("--seed", type=int, default=0)
    return p


def parse_kind_weights(spec):
    """'laugh=0.5,speech=0.2' → {'laugh': 0.5, 'speech': 0.2} (None → None)."""
    if spec is None:
        return None
    out = {}
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        k, _, v = part.partition("=")
        if not _:
            raise SystemExit(
                f"--hard-negative-weights: expected KIND=WEIGHT, got {part!r}"
            )
        out[k.strip()] = float(v)
    return out


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)

    from pathlib import Path

    from ..data import acquire

    esc50_path = Path(args.esc50_dir) / "ESC-50-master"
    if not esc50_path.exists() and not args.skip_download:
        try:
            esc50_path = Path(acquire.download_esc50(args.esc50_dir))
        except Exception as e:
            print(f"ESC-50 download failed ({e}); continuing with synthetic only")

    if esc50_path.exists():
        n_c, n_n = acquire.reorganize_esc50(
            str(esc50_path), args.output_dir,
            # prepare_data's 9-class selection (reference:
            # prepare_data.py:84-94), not setup_data's curated 7.
            negatives=acquire.PREPARE_DATA_NEGATIVES,
        )
        print(f"ESC-50: {n_c} coughs, {n_n} hard negatives")
    else:
        print("ESC-50 unavailable; skipping")

    n_c, n_n = acquire.generate_synthetic_dataset(
        args.output_dir,
        n_coughs=args.synthetic_coughs,
        n_non_coughs=args.synthetic_non_coughs,
        seed=args.seed,
        hard_negative_frac=args.hard_negatives,
        hard_negative_weights=parse_kind_weights(args.hard_negative_weights),
    )
    print(f"Synthetic: {n_c} coughs, {n_n} non-coughs "
          f"({args.hard_negatives:.0%} hard)")

    summary = acquire.dataset_summary(args.output_dir)
    print("=" * 50)
    print("DATASET SUMMARY")
    print(f"  cough:     {summary['cough']}")
    print(f"  non_cough: {summary['non_cough']}")
    print(f"  output:    {args.output_dir}")


if __name__ == "__main__":
    main()
