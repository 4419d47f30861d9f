"""Batched offline featurization CLI, the port's copy of
`cough_detector_tpu/cli/featurize.py`: a directory of clips → (N, H, T)
features in one .npz, with clips/s.

    python -m cough_detector_tpu_torch.cli.featurize --data-dir D --output f.npz
        [--batch-size 512] [--num-workers 16] [--augment] [--seed S]
        [--config CONFIG] [--device cuda] [--mesh DEV,DEV,...]

The host decodes and crops (data.datasets.BatchLoader); on the device each
batch is peak-normalized, optionally augmented with the training chain
(p = 0.3, draws from a generator seeded with --seed), and featurized by
`extract_features_fast`: the fused kernel pair on the card (with the
contrast rows appended for a config with spectral contrast). The feature
geometry is the shipped config's, or `--config`'s (a config JSON or a
checkpoint directory, as cli.pack takes it). Runs on the card unless given
`--device cpu`. Each batch splits over a mesh of devices in contiguous
blocks (`--mesh`, or every visible card when there are several), each
device featurizing its rows; the augmentation draws are the whole batch's
on every device, so the features equal one device's. Each device's share
of a batch runs as a captured program (utils.graphs, the JAX CLI's jitted
`featurize`), one a (rows, dtype, augmentation, share of the batch) key,
its generator registered with the graph, so a replay draws what the eager
call draws.
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
    p.add_argument("--mesh", type=str, default=None, metavar="DEV,DEV,...",
                   help="Devices each batch splits over (e.g. cuda:0,cuda:1; a "
                        "device may repeat); default every visible card with "
                        "--device cuda")
    return p


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)

    import numpy as np
    import torch

    from .. import parallel
    from ..augment import augment_waveforms
    from ..data import audio_io
    from ..data.datasets import BatchLoader, ClipDataset, CoughDataset
    from ..ops import frontend
    from ..utils import graphs
    from ..utils.device import resolve_device
    from ..utils.observability import Throughput
    from .pack import read_feature_config

    dev = resolve_device(args.device)
    mesh = parallel.resolve_mesh(parallel.mesh_arg(args.mesh), args.device)
    devices = [dev] if mesh is None else mesh.devices
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
    # A generator a device, each drawing for the whole batch: all advance
    # together, and each device keeps the draws of its rows.
    gens = [torch.Generator(device=d).manual_seed(args.seed) for d in devices]
    programs = [
        graphs.Programs(d, generators=(gen,) if d.type == "cuda" else (), name="featurize",
                        pool=graphs.scoring_pool(d))
        for d, gen in zip(devices, gens)
    ]

    def program(gen, lo: int, hi: int, n: int):
        def fn(static):
            with parallel.batch_slice(parallel.BatchSlice(lo, hi, n)):
                w = frontend.peak_normalize(static["waves"])
                if args.augment:
                    w = augment_waveforms(w, gen, p=0.3, sample_rate=cfg.sample_rate)
                return (frontend.extract_features_fast(w, cfg, device=w.device),)

        return fn

    @torch.no_grad()
    def featurize(waves: np.ndarray) -> np.ndarray:
        n = len(waves)
        out = []
        for i, (gen, progs) in enumerate(zip(gens, programs)):
            lo, hi = i * n // len(devices), (i + 1) * n // len(devices)
            if hi > lo:
                w = waves[lo:hi]
                key = (w.shape, str(w.dtype), args.augment, lo, n)
                out.append(progs(key, program(gen, lo, hi, n), {"waves": w}, copy=(False,))[0].cpu().numpy())
        return np.concatenate(out)

    feats_out, labels_out = [], []
    # Steady throughput leaves out the first batch, which builds the
    # kernels on the card.
    steady = Throughput(warmup=1)
    t0 = time.perf_counter()
    n = 0
    for waves, labels in loader:
        steady.start()
        feats_out.append(featurize(waves))
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
        "device": str(dev) if mesh is None else [str(d) for d in devices],
        "output": args.output,
    }))


if __name__ == "__main__":
    main()
