"""Pre-decoded int16 waveform shards, the port's copy of the reader.

The port of `cough_detector_tpu/data/shards.py`: the v2 shard layout, the
int16 scale, and `ShardLoader`, whose epoch order is the JAX loader's
(the same numpy draws from (seed, epoch)), so both packages train on
identical batches. Batches are yielded as int16 and dequantized on the
device (`dequantize_torch`), halving the bytes uploaded.

Layout (format version 2):

    <dir>/manifest.json                 counts, geometry, shard table
    <dir>/waves-00000.npy               int16 (N, segment_samples)
    <dir>/labels-00000.npy              int16 (N,)

`write_shards` packs a decoded `ClipDataset` through `BatchLoader` and
writes the files and manifest the JAX package's writes, so each package's
`ShardLoader` reads the other's shards; `pack_arrays` writes the same
layout from waveforms already in memory, such as a synthetic corpus.
"""

from __future__ import annotations

import contextlib
import json
from pathlib import Path
from typing import Tuple

import numpy as np
import torch

from ..config import FeatureConfig
from .datasets import _EpochKeyedLoader

MANIFEST = "manifest.json"
FORMAT_VERSION = 2
# The decoder's divisor: decoded WAV samples are exactly k/32768, so
# round(x*32768) recovers k and the pack→load round trip is bit-exact.
INT16_SCALE = 32768.0


def quantize(waves: np.ndarray) -> np.ndarray:
    """float32 PCM (≈[-1, 1]) → int16, rounding to the nearest code, with
    +1.0 clipping to 32767."""
    return np.clip(np.round(waves * INT16_SCALE), -32768, 32767).astype(np.int16)


def dequantize(waves: np.ndarray) -> np.ndarray:
    return waves.astype(np.float32) * (1.0 / INT16_SCALE)


def dequantize_torch(waves: torch.Tensor) -> torch.Tensor:
    """int16 batches → float32 waveforms on the tensor's device; anything
    already float passes through."""
    if waves.dtype == torch.int16:
        return waves.to(torch.float32) * (1.0 / INT16_SCALE)
    return waves


def write_shards(
    dataset,
    out_dir: str,
    feature_config: FeatureConfig = FeatureConfig(),
    shard_size: int = 8192,
    num_workers: int = 8,
    backend: str = "auto",
) -> dict:
    """Pack a ClipDataset into int16 waveform shards; returns the manifest.

    Decode order is the dataset's own (no shuffle): shard row r of the
    global index is dataset.samples[r], so a seeded split's selection
    order survives packing."""
    from .datasets import BatchLoader

    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    loader = BatchLoader(
        dataset, shard_size, feature_config,
        num_workers=num_workers, backend=backend, cache_bytes=0,
    )
    shards = []
    counts: dict = {}
    n_total = 0
    for i, (waves, labels) in enumerate(loader):
        np.save(out / f"waves-{i:05d}.npy", quantize(waves))
        np.save(out / f"labels-{i:05d}.npy", labels.astype(np.int16))
        shards.append({"file": f"waves-{i:05d}.npy", "n": int(len(labels))})
        for lab in labels:
            counts[int(lab)] = counts.get(int(lab), 0) + 1
        n_total += len(labels)
    manifest = {
        "version": FORMAT_VERSION,
        "segment_samples": int(feature_config.segment_samples),
        "sample_rate": int(feature_config.sample_rate),
        "n_clips": n_total,
        "class_counts": {str(k): v for k, v in sorted(counts.items())},
        "shards": shards,
    }
    (out / MANIFEST).write_text(json.dumps(manifest, indent=2))
    return manifest


def pack_arrays(
    waves: np.ndarray,
    labels: np.ndarray,
    out_dir: str,
    feature_config: FeatureConfig = FeatureConfig(),
    shard_size: int = 8192,
) -> dict:
    """Write (N, segment_samples) float waveforms and their labels as a v2
    shard directory, rows in the given order; returns the manifest."""
    waves = np.asarray(waves)
    labels = np.asarray(labels)
    seg = int(feature_config.segment_samples)
    if waves.ndim != 2 or waves.shape[1] != seg or len(labels) != len(waves):
        raise ValueError(
            f"expected (N, {seg}) waves and N labels, got {waves.shape} and "
            f"{labels.shape}"
        )
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    shards = []
    for i, lo in enumerate(range(0, len(waves), shard_size)):
        name = f"waves-{i:05d}.npy"
        np.save(out / name, quantize(waves[lo : lo + shard_size]))
        np.save(out / f"labels-{i:05d}.npy", labels[lo : lo + shard_size].astype(np.int16))
        shards.append({"file": name, "n": int(min(shard_size, len(waves) - lo))})
    values, counts = np.unique(labels.astype(np.int64), return_counts=True)
    manifest = {
        "version": FORMAT_VERSION,
        "segment_samples": seg,
        "sample_rate": int(feature_config.sample_rate),
        "n_clips": int(len(waves)),
        "class_counts": {str(int(k)): int(v) for k, v in zip(values, counts)},
        "shards": shards,
    }
    (out / MANIFEST).write_text(json.dumps(manifest, indent=2))
    return manifest


class ShardLoader(_EpochKeyedLoader):
    """Iterates (waves[B, segment] int16, labels[B] int32) batches from a
    packed shard directory, memory-mapped; `epoch_batches` gives the same
    order as index matrices for a device-resident corpus."""

    def __init__(
        self,
        shard_dir: str,
        batch_size: int,
        *,
        shuffle: bool = False,
        weighted: bool = False,
        drop_last: bool = False,
        seed: int = 0,
        prefetch: int = 4,
        feature_config: "FeatureConfig" = None,
    ):
        self.shard_dir = Path(shard_dir)
        manifest_path = self.shard_dir / MANIFEST
        if not manifest_path.exists():
            raise FileNotFoundError(f"No shard manifest at {manifest_path}")
        self.manifest = json.loads(manifest_path.read_text())
        if self.manifest.get("version") != FORMAT_VERSION:
            raise ValueError(
                f"Shard format version {self.manifest.get('version')!r} != {FORMAT_VERSION}"
            )
        self.segment_samples = int(self.manifest["segment_samples"])
        if feature_config is not None:
            # A corpus on another time base would compute every feature
            # wrongly with no numeric error anywhere downstream.
            want = (int(feature_config.sample_rate), int(feature_config.segment_samples))
            got = (int(self.manifest["sample_rate"]), self.segment_samples)
            if want != got:
                raise ValueError(
                    f"shard corpus geometry (sample_rate, segment)={got} does "
                    f"not match the run's feature config {want}"
                )
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.weighted = weighted
        self.drop_last = drop_last
        self.prefetch = prefetch
        self._seed = seed
        self._epoch = 0
        self._pinned = False

        self._waves = []
        labels = []
        sizes = []
        for entry in self.manifest["shards"]:
            w = np.load(self.shard_dir / entry["file"], mmap_mode="r")
            if w.shape[1] != self.segment_samples or w.dtype != np.int16:
                raise ValueError(f"{entry['file']}: bad shape/dtype {w.shape} {w.dtype}")
            lab = np.load(self.shard_dir / entry["file"].replace("waves-", "labels-"))
            if len(lab) != w.shape[0] or w.shape[0] != entry["n"]:
                raise ValueError(f"{entry['file']}: row count mismatch")
            self._waves.append(w)
            labels.append(lab)
            sizes.append(w.shape[0])
        self._labels = (
            np.concatenate(labels).astype(np.int32) if labels else np.zeros(0, np.int32)
        )
        self._starts = np.concatenate([[0], np.cumsum(sizes)])
        self.class_counts = {
            int(k): int(v) for k, v in self.manifest.get("class_counts", {}).items()
        }
        self.sample_weights = self._compute_sample_weights()

    def _compute_sample_weights(self) -> np.ndarray:
        """Inverse-frequency weights (reference: src/dataset.py:109-116)."""
        total = len(self._labels)
        n_classes = max(len(self.class_counts), 1)
        if total == 0:
            return np.empty(0, np.float64)
        counts = np.ones(int(self._labels.max()) + 1, np.float64)
        for k, v in self.class_counts.items():
            if 0 <= k < counts.shape[0]:
                counts[k] = max(v, 1)
        return total / (n_classes * counts[self._labels])

    def _n_samples(self) -> int:
        return len(self._labels)

    def _order_weights(self) -> np.ndarray:
        return self.sample_weights

    def _producer_scope(self):
        return contextlib.nullcontext()

    def _batch_at(self, idxs, scope, rng):
        return self._gather(idxs)

    @property
    def n_clips(self) -> int:
        return len(self._labels)

    def corpus_nbytes(self) -> int:
        return sum(w.nbytes for w in self._waves)

    def corpus(self) -> np.ndarray:
        """The full (N, segment) int16 corpus, materialized: the upload for
        device-resident training."""
        if not self._waves:
            return np.zeros((0, self.segment_samples), np.int16)
        return np.concatenate([np.asarray(w) for w in self._waves])

    def epoch_batches(self, epoch: int):
        """(idx_mat, labels_mat, mask_mat), each (steps, B), defining this
        epoch's batches in the order __iter__ would produce them. Tail
        batches (no drop_last) pad with index 0 rows masked out."""
        self.set_epoch(epoch)
        order = self._epoch_order(self._epoch_rng())
        n_steps = len(self)
        b = self.batch_size
        take = order[: n_steps * b]
        mask = np.ones(take.shape[0], np.float32)
        pad = n_steps * b - take.shape[0]
        if pad > 0:
            take = np.concatenate([take, np.zeros(pad, take.dtype)])
            mask = np.concatenate([mask, np.zeros(pad, np.float32)])
        idx_mat = take.reshape(n_steps, b).astype(np.int32)
        return idx_mat, self._labels[idx_mat], mask.reshape(n_steps, b)

    def _gather(self, idxs: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        out = np.empty((len(idxs), self.segment_samples), np.int16)
        shard_ids = np.searchsorted(self._starts, idxs, side="right") - 1
        for s in np.unique(shard_ids):
            sel = shard_ids == s
            out[sel] = self._waves[s][idxs[sel] - self._starts[s]]
        return out, self._labels[idxs]
