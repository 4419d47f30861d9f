"""COUGHVID ingest CLI, the port of `cough_detector_tpu/cli/setup_coughvid.py`
(reference: setup_coughvid.py:447-507).

    python -m cough_detector_tpu_torch.cli.setup_coughvid --output-dir ./data
        [--coughvid-dir DIR] [--download-dir ./datasets] [--max-coughs 3000]
        [--wipe] [--no-esc50]

Filters COUGHVID by annotation confidence, caps it, converts the clips to
16 kHz mono WAV (data/acquire.py::prepare_coughvid, over
`select_coughvid`), and merges ESC-50's coughs and hard negatives. Given
`--coughvid-dir` it uses that tree and downloads nothing; otherwise it
downloads COUGHVID (and, without `--no-esc50`, ESC-50). Per-clip failures
are counted, and the output directory is removed only with `--wipe`.
"""

from __future__ import annotations

import argparse


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Set up COUGHVID training data")
    p.add_argument("--output-dir", type=str, default="./data")
    p.add_argument("--download-dir", type=str, default="./datasets")
    p.add_argument("--coughvid-dir", type=str, default=None,
                   help="Pre-downloaded COUGHVID directory (skips download)")
    p.add_argument("--max-coughs", type=int, default=3000)
    p.add_argument("--wipe", action="store_true",
                   help="Remove the output dir first (the reference always does)")
    p.add_argument("--no-esc50", action="store_true")
    return p


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)

    import shutil
    from pathlib import Path

    from ..data import acquire

    out = Path(args.output_dir)
    if args.wipe and out.exists():
        shutil.rmtree(out)
    out.mkdir(parents=True, exist_ok=True)

    coughvid = args.coughvid_dir or acquire.download_coughvid(args.download_dir)
    if coughvid and Path(coughvid).exists():
        acquire.prepare_coughvid(coughvid, args.output_dir, max_coughs=args.max_coughs)
    else:
        print("COUGHVID unavailable — continuing without it")

    if not args.no_esc50:
        esc50 = Path(args.download_dir) / "ESC-50-master"
        if not esc50.exists():
            try:
                esc50 = Path(acquire.download_esc50(args.download_dir))
            except Exception as e:
                print(f"ESC-50 download failed: {e}")
        if esc50.exists():
            n_c, n_n = acquire.reorganize_esc50(
                str(esc50), args.output_dir,
                # The COUGHVID merge casts the widest net: 17 negative
                # classes (reference: setup_coughvid.py:322-340).
                negatives=acquire.COUGHVID_MERGE_NEGATIVES,
            )
            print(f"ESC-50 merged: {n_c} coughs, {n_n} negatives")

    summary = acquire.dataset_summary(args.output_dir)
    print("=" * 50)
    print(f"cough: {summary['cough']}  non_cough: {summary['non_cough']}")
    print("Next: python -m cough_detector_tpu_torch.cli.train --data-dir " + str(out))


if __name__ == "__main__":
    main()
