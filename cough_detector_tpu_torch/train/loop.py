"""End-to-end training on one device, in torch.

The port of `cough_detector_tpu/train/loop.py::train`: dataset assembly
(a data directory's seeded split, optional ESC-50 fold 5 for validation)
or a packed shard corpus, dynamic class weights capped 20:1,
class-weighted CE, AdamW + cosine warm restarts + grad clip 1.0, best-F1 +
latest checkpoints, early stopping on val loss, resume. Per step:

  int16 shard batch (gathered from the corpus on the device, or uploaded),
  or a float32 batch the host decoded, cropped and time-shifted
  (data.datasets.BatchLoader), uploaded from pinned memory
      → dequantize → waveform augmentation → peak normalize
      → front end (the fused CUDA kernel on the card) → SpecAugment
      → forward/backward → clip + AdamW

Sample order is the JAX loader's ((seed, epoch) numpy draws) and every
random draw of step s of epoch e is keyed by (seed, e, s) (steps.StepRandom),
so a run resumed from a checkpoint replays the uninterrupted run. On the
card the run also asks torch for deterministic algorithms (cuDNN's
deterministic convolutions, no autotuning) and restores the previous
settings when it returns. Metrics stay on the device until the epoch ends.
Per-epoch records go to <output>/metrics.jsonl.

Not ported yet, and raising NotImplementedError: the chunked device
corpus, and a mesh or several processes (ROADMAP Queue 1 items 10c and
11).
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from pathlib import Path
from typing import Iterator, Optional, Tuple

import numpy as np
import torch

from ..augment import augment_waveforms, spec_augment
from ..config import Config
from ..data.datasets import (
    BatchLoader,
    ClipDataset,
    CombinedDataset,
    ESC50Dataset,
    prepare_dataset_split,
)
from ..data.shards import ShardLoader, dequantize_torch
from ..models import count_parameters, init_weights, model_from_config, no_tf32
from ..ops import frontend
from ..utils.device import resolve_device
from ..utils.observability import JsonlLogger, trace_span
from . import checkpoint as ckpt
from . import steps
from .metrics import EarlyStopping, EpochAccumulator

_DEVICE_CORPUS_BUDGET = 2 << 30  # bytes of int16 corpus uploaded whole ("auto")

Batch = Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]


@contextlib.contextmanager
def deterministic(dev: torch.device):
    """Deterministic algorithms on the card for the duration, restored after.
    cuBLAS needs CUBLAS_WORKSPACE_CONFIG for torch to allow it; on the one
    stream the trainer uses, its results repeat whatever workspace an
    earlier cuBLAS call in the process fixed. torch's fill of every new
    tensor's memory, which it turns on with deterministic algorithms, stays
    off: it guards reads of memory no op wrote, which the trainer does not
    make, and it doubled the kernels of a train step (PERF.md)."""
    if dev.type != "cuda":
        yield
        return
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    cudnn = torch.backends.cudnn
    fill = torch.utils.deterministic
    prev = (
        torch.are_deterministic_algorithms_enabled(),
        torch.is_deterministic_algorithms_warn_only_enabled(),
        cudnn.deterministic,
        cudnn.benchmark,
        fill.fill_uninitialized_memory,
    )
    torch.use_deterministic_algorithms(True)
    cudnn.deterministic, cudnn.benchmark = True, False
    fill.fill_uninitialized_memory = False
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(prev[0], warn_only=prev[1])
        cudnn.deterministic, cudnn.benchmark = prev[2], prev[3]
        fill.fill_uninitialized_memory = prev[4]


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to the PyTorch trainer yet (ROADMAP Queue 1 item {item})"
    )


def _resident_batches(corpus: torch.Tensor, mats) -> Iterator[Batch]:
    """One epoch's batches gathered on the device from a resident corpus;
    (steps, B) index/label/mask matrices from `ShardLoader.epoch_batches`.
    A row with no padding carries mask None (the unmasked BatchNorm)."""
    idx, labels, mask = mats
    full = mask.all(axis=1)
    dev = corpus.device
    idx_d = torch.from_numpy(idx.astype(np.int64)).to(dev)
    labels_d = torch.from_numpy(labels.astype(np.int64)).to(dev)
    mask_d = torch.from_numpy(mask).to(dev)
    for s in range(idx.shape[0]):
        yield corpus.index_select(0, idx_d[s]), labels_d[s], None if full[s] else mask_d[s]


def _streamed_batches(loader, epoch: int, dev: torch.device) -> Iterator[Batch]:
    """One epoch's batches from a loader's prefetch thread (int16 from a
    ShardLoader, float32 from a BatchLoader), uploaded from pinned memory
    without blocking; a short tail batch is padded to the batch size under
    a mask."""
    loader.set_epoch(epoch)
    b = loader.batch_size
    for waves, labels in loader:
        n = len(labels)
        mask = None
        if n < b:
            waves = np.pad(waves, ((0, b - n), (0, 0)))
            labels = np.pad(labels, (0, b - n))
            mask = torch.from_numpy((np.arange(b) < n).astype(np.float32))
        tensors = [torch.from_numpy(waves), torch.from_numpy(labels.astype(np.int64))]
        if mask is not None:
            tensors.append(mask)
        if dev.type == "cuda":
            tensors = [t.pin_memory().to(dev, non_blocking=True) for t in tensors]
        yield tensors[0], tensors[1], tensors[2] if mask is not None else None


def _accumulate(pending) -> EpochAccumulator:
    """Fold a list of per-step device metric dicts into an accumulator,
    with one device-to-host copy."""
    acc = EpochAccumulator()
    if not pending:
        return acc
    keys = list(pending[0])
    rows = torch.stack(
        [torch.stack([m[k].to(torch.float64) for k in keys]) for m in pending]
    ).cpu().numpy()
    for row in rows:
        acc.update(dict(zip(keys, row)))
    return acc


def make_feature_fns(config: Config, dev: torch.device, *, use_time_shift: bool, noise_bank=None):
    """(train_features(waves, generator), eval_features(waves)): int16 or
    float (B, segment) batches on `dev` → (B, F, T) features. Training
    runs the reference's order (reference: src/dataset.py:150-163):
    dequantize → waveform augmentation → peak normalize → front end →
    SpecAugment; eval skips both augmentations. `use_time_shift`: True for
    shard batches, which hold only the cropped window, so the shift is the
    zero-filled one on the device; False for decoded batches, which the
    loader already shifted against the full clip (a second shift here
    would move them twice). The front end is the fused CUDA kernel on the
    card (ops/frontend.py::extract_features_fast); the features carry no
    parameters, so nothing differentiates through it."""
    fcfg, tcfg = config.features, config.train
    bank = None if noise_bank is None else torch.as_tensor(noise_bank, dtype=torch.float32, device=dev)

    def train_features(waves, gen):
        waves = augment_waveforms(
            dequantize_torch(waves), gen, p=tcfg.p_augment, noise_bank=bank,
            use_time_shift=use_time_shift, sample_rate=fcfg.sample_rate,
        )
        feats = frontend.extract_features_fast(frontend.peak_normalize(waves), fcfg, device=dev)
        return spec_augment(
            feats, gen,
            freq_mask_param=tcfg.freq_mask_param,
            time_mask_param=tcfg.time_mask_param,
            n_freq_masks=tcfg.n_freq_masks,
            n_time_masks=tcfg.n_time_masks,
            p=tcfg.p_augment,
        )

    def eval_features(waves):
        waves = frontend.peak_normalize(dequantize_torch(waves))
        return frontend.extract_features_fast(waves, fcfg, device=dev)

    return train_features, eval_features


def _build_datasets(
    data_dir: Optional[str], use_esc50: bool, esc50_dir: Optional[str]
) -> Tuple[ClipDataset, ClipDataset]:
    """The reference's dataset assembly (src/train.py:332-392): a data
    directory's seeded stratified split, plus ESC-50 with fold 5 held out."""
    trains, vals = [], []
    if data_dir and Path(data_dir).exists():
        tr, va = prepare_dataset_split(data_dir, val_split=0.2)
        trains.append(tr)
        vals.append(va)
        print(f"Custom dataset: train {len(tr)}, val {len(va)}")
    if use_esc50 and esc50_dir and Path(esc50_dir).exists():
        trains.append(ESC50Dataset(esc50_dir, is_training=True, fold=5, include_all_negatives=True))
        vals.append(ESC50Dataset(esc50_dir, is_training=False, fold=5, include_all_negatives=True))
        print(f"ESC-50: train {len(trains[-1])}, val {len(vals[-1])}")
    if not trains:
        raise ValueError("No training data found! Provide data_dir or an ESC-50 directory.")
    if len(trains) > 1:
        return CombinedDataset(trains), CombinedDataset(vals)
    return trains[0], vals[0]


def train(
    data_dir: Optional[str],
    output_dir: str,
    config: Config = None,
    use_esc50: bool = False,
    esc50_dir: Optional[str] = None,
    resume: Optional[str] = None,
    num_workers: int = 8,
    noise_bank: Optional[np.ndarray] = None,
    max_epochs: Optional[int] = None,
    mesh=None,
    shards_dir: Optional[str] = None,
    device_corpus="auto",
    device_corpus_budget: Optional[int] = None,
    device="cuda",
    decode_backend: str = "auto",
) -> str:
    """Train a model; returns the best checkpoint's path.

    Input: `shards_dir` (a packed corpus with `train/` and `val/`), or else
    the decode path: `data_dir` (cough/ and non_cough/ clips, split 80/20
    with seed 42) and, with `use_esc50`, ESC-50 at `esc50_dir`, decoded by
    `num_workers` host threads through `BatchLoader(backend=decode_backend)`
    ("auto": the C++ decoder when it builds and every clip is a .wav). The
    decode path time-shifts at crop time against the full clip, as the
    reference does.

    `device_corpus` (shards only): "auto" uploads the int16 corpus once
    when it fits `device_corpus_budget` bytes (2 GiB by default), True
    always does, False streams the loader's batches through pinned memory;
    both give the same batches. `device` defaults to the card and raises
    if there is none. `noise_bank` ((N, S >= segment) float waveforms)
    turns on the file-noise augmentation."""
    if device_corpus not in ("auto", True, False, "chunked"):
        raise ValueError(
            f"device_corpus={device_corpus!r}: expected 'auto', True, False or 'chunked'"
        )
    if device_corpus == "chunked":
        raise _not_ported("device_corpus='chunked' (a corpus streamed through device windows)", "10c")
    if mesh not in (None, False) or (
        torch.distributed.is_available()
        and torch.distributed.is_initialized()
        and torch.distributed.get_world_size() > 1
    ):
        raise _not_ported("Training over a mesh or several processes (torch.distributed)", "11")
    if device_corpus is True and shards_dir is None:
        raise ValueError(
            "device_corpus=True requires shards_dir (a packed corpus is what gets "
            "uploaded); pack one with cli.pack or pass device_corpus='auto'"
        )
    config = config or Config()
    dev = resolve_device(device)
    out = Path(output_dir)
    out.mkdir(parents=True, exist_ok=True)
    (out / "config.json").write_text(config.to_json())
    if shards_dir is not None:
        loaders = _shard_loaders(config, shards_dir)
    else:
        loaders = _decode_loaders(config, data_dir, use_esc50, esc50_dir, num_workers, decode_backend)
    with deterministic(dev):
        return _train(
            output_dir, config, dev, resume, noise_bank, max_epochs, loaders,
            device_corpus,
            _DEVICE_CORPUS_BUDGET if device_corpus_budget is None else int(device_corpus_budget),
        )


def _shard_loaders(config: Config, shards_dir: str):
    """(train loader, val loader, train class counts) over a packed corpus."""
    fcfg, tcfg = config.features, config.train
    train_loader = ShardLoader(
        str(Path(shards_dir) / "train"), tcfg.batch_size,
        weighted=True, drop_last=True, seed=tcfg.seed, feature_config=fcfg,
    )
    val_loader = ShardLoader(str(Path(shards_dir) / "val"), tcfg.batch_size, feature_config=fcfg)
    print(
        f"Shard corpus {shards_dir}: train {train_loader.n_clips}, "
        f"val {val_loader.n_clips} (pre-decoded int16)"
    )
    return train_loader, val_loader, train_loader.class_counts


def _decode_loaders(config: Config, data_dir, use_esc50, esc50_dir, num_workers: int, backend: str):
    """(train loader, val loader, train class counts) decoding audio files."""
    fcfg, tcfg = config.features, config.train
    train_ds, val_ds = _build_datasets(data_dir, use_esc50, esc50_dir)
    print(f"Total train {len(train_ds)}, val {len(val_ds)}")
    train_loader = BatchLoader(
        train_ds, tcfg.batch_size, fcfg, weighted=True, drop_last=True,
        num_workers=num_workers, seed=tcfg.seed, backend=backend,
        # The reference shifts the full clip before center-trimming, so
        # shifted-in content is real adjacent audio
        # (src/augmentation.py:95-104 + src/dataset.py:156).
        time_shift_limit=0.2, time_shift_prob=tcfg.p_augment,
    )
    val_loader = BatchLoader(val_ds, tcfg.batch_size, fcfg, num_workers=num_workers, backend=backend)
    return train_loader, val_loader, train_ds.class_counts


def _train(output_dir, config, dev, resume, noise_bank, max_epochs, loaders,
           device_corpus, budget) -> str:
    fcfg, tcfg = config.features, config.train
    out = Path(output_dir)
    train_loader, val_loader, class_counts = loaders
    shards = isinstance(train_loader, ShardLoader)
    w0, w1 = steps.compute_class_weights(class_counts, tcfg.max_class_weight_ratio)
    class_weights = torch.tensor([w0, w1], dtype=torch.float32, device=dev)
    print(f"Class weights: non-cough={w0:.2f}, cough={w1:.2f}")

    model = model_from_config(config.model)
    init_weights(model, torch.Generator().manual_seed(tcfg.seed))
    no_tf32(dev)
    model.to(dev)
    print(f"Model: {config.model.model_type} ({count_parameters(model):,} params)")
    optimizer = steps.make_optimizer(model.parameters(), tcfg, max(len(train_loader), 1))
    mixup_alpha = tcfg.mixup_alpha if tcfg.use_mixup else None
    train_features, eval_features = make_feature_fns(
        config, dev, use_time_shift=shards, noise_bank=noise_bank
    )

    resident = False
    if shards:
        corpus_bytes = train_loader.corpus_nbytes() + val_loader.corpus_nbytes()
        resident = device_corpus is True or (device_corpus == "auto" and corpus_bytes <= budget)
        if device_corpus == "auto" and not resident:
            raise NotImplementedError(
                f"a corpus of {corpus_bytes} bytes is past the {budget}-byte device budget, "
                f"where device_corpus='auto' needs the chunked device corpus, not ported to "
                f"the PyTorch trainer yet (ROADMAP Queue 1 item 10c); device_corpus=False "
                f"streams it"
            )
    if resident:
        print(f"Device-resident corpus ({corpus_bytes / 2**20:.0f} MB int16)")
        train_corpus = torch.from_numpy(train_loader.corpus()).to(dev)
        val_corpus = torch.from_numpy(val_loader.corpus()).to(dev)
        val_mats = val_loader.epoch_batches(0)

        def train_batches(epoch):
            return _resident_batches(train_corpus, train_loader.epoch_batches(epoch))

        def val_batches():
            return _resident_batches(val_corpus, val_mats)
    else:
        def train_batches(epoch):
            return _streamed_batches(train_loader, epoch, dev)

        def val_batches():
            return _streamed_batches(val_loader, 0, dev)

    early = EarlyStopping(tcfg.patience, tcfg.early_stop_min_delta)
    # -1, not the reference's 0.0: a fresh run always writes best_model at
    # epoch 0, even with F1 stuck at 0.
    start_epoch, best_f1 = 0, -1.0
    if resume and Path(resume).exists():
        tree, epoch, metrics, _ = ckpt.load_checkpoint(resume)
        model.load_state_dict(tree["model"])
        optimizer.load_state_dict(tree["optimizer"])
        best_f1 = metrics.get("f1", -1.0)
        start_epoch = epoch + 1
        es = ckpt.read_meta(resume).get("extra", {}).get("early_stop")
        if es:  # the patience countdown the interrupted run had built up
            early.best_loss = es["best_loss"]
            early.counter = es["counter"]
        best_meta = out / "best_model" / ckpt.META
        if best_meta.exists():  # a worse model must not overwrite the standing best
            best_f1 = max(best_f1, json.loads(best_meta.read_text())["metrics"].get("f1", 0.0))
        print(f"Resumed from {resume} at epoch {start_epoch} (best F1 {best_f1:.4f})")

    metrics_log = JsonlLogger(str(out / "metrics.jsonl"))
    epochs = max_epochs if max_epochs is not None else tcfg.epochs
    best_path = str(out / "best_model")
    rand = steps.StepRandom(dev)
    loop_t0 = time.perf_counter()

    def epoch_tail(ep, acc, vacc, train_time, val_time) -> bool:
        """JSONL record, console line, early-stop advance, best/latest
        checkpoints. True when early stopping fires at epoch `ep`."""
        nonlocal best_f1
        train_m, val_m = acc.summary(), vacc.summary()
        record = {
            "epoch": ep,
            "train_loss": train_m["loss"],
            "train_acc": train_m["accuracy"],
            "val_loss": val_m["loss"],
            "val_acc": val_m["accuracy"],
            "precision": val_m["precision"],
            "recall": val_m["recall"],
            "f1": val_m["f1"],
            "tp": val_m["tp"], "fp": val_m["fp"],
            "fn": val_m["fn"], "tn": val_m["tn"],
            "train_clips_per_sec": acc.count / max(train_time, 1e-9),
            "val_clips_per_sec": vacc.count / max(val_time, 1e-9),
            # Cumulative wall clock since the loop started: the delta between
            # records is the whole epoch's cost, checkpoint writes included.
            "wall_s": round(time.perf_counter() - loop_t0, 3),
        }
        metrics_log.log(**record)
        print(
            f"Epoch {ep}: train loss {train_m['loss']:.4f} "
            f"acc {train_m['accuracy']:.2f}% | val loss {val_m['loss']:.4f} "
            f"acc {val_m['accuracy']:.2f}% P {val_m['precision']:.4f} "
            f"R {val_m['recall']:.4f} F1 {val_m['f1']:.4f} | "
            f"{record['train_clips_per_sec']:,.0f} clips/s"
        )
        # Advance early stopping before latest_model is written, so its
        # counters already count this epoch and a resume continues them.
        stop = early(val_m["loss"])
        if val_m["f1"] > best_f1:
            best_f1 = val_m["f1"]
            ckpt.save_checkpoint(output_dir, "best_model", model, optimizer, ep, val_m, config)
            print(f"  Saved best model (F1: {best_f1:.4f})")
        ckpt.save_checkpoint(
            output_dir, "latest_model", model, optimizer, ep, val_m, config,
            extra={"early_stop": {"best_loss": early.best_loss, "counter": early.counter}},
        )
        if stop:
            print(f"Early stopping at epoch {ep}")
        return stop

    try:
        for epoch in range(start_epoch, epochs):
            # The range chip_smoke.py reads the epoch's device idle share in.
            with trace_span("cdt.epoch"):
                t0 = time.perf_counter()
                pending = []
                for step, (waves, labels, mask) in enumerate(train_batches(epoch)):
                    pending.append(steps.train_step(
                        model, optimizer, waves, labels, class_weights,
                        rand.key(tcfg.seed, epoch, step), feature_fn=train_features,
                        mask=mask, mixup_alpha=mixup_alpha,
                    ))
                acc = _accumulate(pending)
                train_time = time.perf_counter() - t0
                t0 = time.perf_counter()
                vacc = _accumulate([
                    steps.eval_step(model, w, lab, class_weights, eval_features, m)
                    for w, lab, m in val_batches()
                ])
                val_time = time.perf_counter() - t0
            if epoch_tail(epoch, acc, vacc, train_time, val_time):
                break
    finally:
        metrics_log.close()
    print(f"Training complete! Best F1: {best_f1:.4f}")
    return best_path
