"""End-to-end training, on one device or data-parallel over ranks, in torch.

The port of `cough_detector_tpu/train/loop.py::train`: dataset assembly
(a data directory's seeded split, optional ESC-50 fold 5 for validation)
or a packed shard corpus, dynamic class weights capped 20:1,
class-weighted CE, AdamW + cosine warm restarts + grad clip 1.0, best-F1 +
latest checkpoints, early stopping on val loss, resume. Per step:

  int16 shard batch (gathered from a corpus on the device, or uploaded),
  or a float32 batch the host decoded, cropped and time-shifted
  (data.datasets.BatchLoader), uploaded from pinned memory
      → dequantize → waveform augmentation → peak normalize
      → front end (the fused CUDA kernel on the card) → SpecAugment
      → forward/backward → clip + AdamW

A shard corpus is placed as the JAX loop places it, against a per-device
budget (2 GiB by default): resident and replicated when it fits one
device; resident and sharded by rows over the ranks when it fits the
budget times their number, each step's rows read through
`parallel.routed_gather`; past that (or with device_corpus="chunked") in
windows of steps whose rows are gathered from the memory-mapped shards
into pinned memory, each uploaded on a side stream while the steps of the
window before run. Every placement gives the same batches.

Sample order is the JAX loader's ((seed, epoch) numpy draws) and every
random draw of step s of epoch e is keyed by (seed, e, s) (steps.StepRandom),
so a run resumed from a checkpoint replays the uninterrupted run, and a
chunked run the resident one. On the card the run also asks torch for
deterministic algorithms (cuDNN's deterministic convolutions, no
autotuning) and restores the previous settings when it returns. Metrics
stay on the device until the epoch ends. Per-epoch records go to
<output>/metrics.jsonl.

One process with its corpus resident on the device runs its epochs
pipelined one deep, as the JAX loop's epoch scan does: epoch e+1's steps
are enqueued before epoch e's metrics and state are fetched, so the fetch,
the record and the checkpoint queueing overlap e+1 on the card. Epoch e's
state is a copy taken on the device between the two epochs; early
stopping decides from epoch e, and a stop discards the dispatched e+1 (the
model, its BatchNorm statistics and the optimizer go back to epoch e's
copy, and e+1 leaves nothing in the launch counters or the probes). Losses,
checkpoints, early stopping and resume are the synchronous loop's;
train_clips_per_sec and val_clips_per_sec both denominate over the epoch's
window, dispatch to fetch. Chunked windows, streamed batches and runs
across ranks stay synchronous.

Over a mesh of devices (`train(mesh=...)`, the default with several
cards) the call starts one rank a device (parallel/launch.py), and with a
`torch.distributed` process group initialized (those ranks, or cli.train
--distributed under torchrun) every rank runs this loop data-parallel:
each builds or gathers only its rows of every global batch, and the step
reduces across the ranks (train/steps.py), so the run computes what one
process computes on the global batch, up to the order of the reductions.
Rank 0 alone writes metrics.jsonl, config.json and the checkpoints, each
save followed by a barrier; one process writes its checkpoints on a
background thread instead. CDT_DEBUG_STEP_METRICS=1 prints the probes the
multi-rank tests read (STEP_LOSSES, ROW_HASHES, SCAN_MATS, KERNEL_LAUNCHES).
"""

from __future__ import annotations

import contextlib
import json
import os
import time
import zlib
from pathlib import Path
from typing import Iterator, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from .. import parallel
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
from ..utils import graphs
from ..utils.device import resolve_device
from ..utils.observability import JsonlLogger, trace_span
from . import checkpoint as ckpt
from . import steps
from .metrics import EarlyStopping, EpochAccumulator

@contextlib.contextmanager
def deterministic(dev: torch.device):
    """Deterministic algorithms on the card for the duration, restored after.
    cuBLAS needs CUBLAS_WORKSPACE_CONFIG for torch to allow it; on the one
    stream the trainer uses, its results repeat whatever workspace an
    earlier cuBLAS call in the process fixed. torch's fill of every new
    tensor's memory, which it turns on with deterministic algorithms, stays
    off: it guards reads of memory no op wrote, which the trainer does not
    make, and it doubled the kernels of a train step (PERF.md). The flag is
    set through its core, torch._C._set_deterministic_algorithms:
    torch.use_deterministic_algorithms also sets torch.compile's inductor
    option, and importing torch._inductor for it (with dynamo, sympy and
    triton) took ~8 s of every fresh training process's start on the card's
    host (tools/rank_start_probe.py); nothing here compiles."""
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
    torch._C._set_deterministic_algorithms(True)
    cudnn.deterministic, cudnn.benchmark = True, False
    fill.fill_uninitialized_memory = False
    try:
        yield
    finally:
        torch._C._set_deterministic_algorithms(prev[0], warn_only=prev[1])
        cudnn.deterministic, cudnn.benchmark = prev[2], prev[3]
        fill.fill_uninitialized_memory = prev[4]


_DEVICE_CORPUS_BUDGET = 2 << 30  # bytes of int16 corpus a device holds ("auto")

# Epochs pipelined one deep where the run allows it (one process, resident
# corpus); the tests set it False for the synchronous loop to compare with.
_PIPELINED = True

Batch = steps.Batch


class _Ranks(NamedTuple):
    """The run's data-parallel layout: `group` (None in one process), this
    rank, the rank count, the global batch padded to `pad_to` rows (a
    multiple of `world`) and this rank's rows [lo, hi) of it."""

    group: Optional[dist.ProcessGroup]
    rank: int
    world: int
    pad_to: int
    lo: int
    hi: int

    def rows(self) -> Optional[parallel.BatchSlice]:
        """The slice the steps run under; None in one process."""
        if self.group is None:
            return None
        return parallel.BatchSlice(self.lo, self.hi, self.pad_to, self.group)


def _graphed_steps(dev: torch.device, group: Optional[dist.ProcessGroup]) -> bool:
    """Whether the trainer runs its steps as captured programs: on the card,
    in one process or over NCCL (whose collectives a graph holds)."""
    return dev.type == "cuda" and (group is None or dist.get_backend(group) == "nccl")


def _debug() -> bool:
    return bool(os.environ.get("CDT_DEBUG_STEP_METRICS"))


def _say(line: str) -> None:
    print(line, flush=True)


def _debug_row_hashes(lo: int, waves, labels, say=_say) -> None:
    """CDT_DEBUG_STEP_METRICS probe: a CRC of every batch row this rank
    holds (float32 bytes, xor the label), with its first global row. Each
    rank's block must equal the same rows of a one-process run's."""
    w = np.ascontiguousarray(np.asarray(waves, np.float32))
    crcs = [zlib.crc32(w[i].tobytes()) ^ int(labels[i]) for i in range(w.shape[0])]
    say(f"ROW_HASHES lo={lo} {json.dumps(crcs)}")


def _hashed(batches: Iterator[Batch], lo: int, say=_say) -> Iterator[Batch]:
    """`batches` unchanged; with CDT_DEBUG_STEP_METRICS, each one's row
    CRCs said (a copy to the host a step, for the probe alone)."""
    for waves, labels, mask in batches:
        if _debug():
            _debug_row_hashes(lo, waves.cpu().numpy(), labels.cpu().numpy(), say)
        yield waves, labels, mask


def _host_batches(loader, epoch: int, ranks: _Ranks) -> Iterator[tuple]:
    """One epoch's batches from a loader's prefetch thread (int16 from a
    ShardLoader, float32 from a BatchLoader), this rank's rows of each
    (across ranks the loader's process slice builds only those), as host
    arrays (waves, int64 labels, float32 mask or None). A batch with fewer
    real rows than `ranks.pad_to` is zero-padded under a mask."""
    loader.set_epoch(epoch)
    lo, hi = ranks.lo, ranks.hi
    for item in loader:
        if ranks.group is not None:
            waves, labels, n = item
        else:
            waves, labels = item
            n = len(labels)
            if n < hi - lo:
                waves = np.pad(waves, ((0, hi - lo - n), (0, 0)))
                labels = np.pad(labels, (0, hi - lo - n))
        if _debug():
            _debug_row_hashes(lo, waves, labels)
        mask = (np.arange(lo, hi) < n).astype(np.float32) if n < ranks.pad_to else None
        yield waves, labels.astype(np.int64), mask


def _streamed_batches(loader, epoch: int, dev: torch.device, ranks: _Ranks) -> Iterator[Batch]:
    """`_host_batches` uploaded from pinned memory without blocking."""
    for waves, labels, mask in _host_batches(loader, epoch, ranks):
        tensors = [torch.from_numpy(a) for a in (waves, labels) + (() if mask is None else (mask,))]
        if dev.type == "cuda":
            tensors = [t.pin_memory().to(dev, non_blocking=True) for t in tensors]
        yield tensors[0], tensors[1], tensors[2] if len(tensors) == 3 else None


def _window_batches(mats, win_steps: int, fetch_rows, segment: int, pinned: bool):
    """An epoch's (steps, B) batch matrices cut into runs of at most
    `win_steps` steps, each with a fixed-capacity int16 buffer holding
    exactly the rows the run touches, gathered by `fetch_rows(global
    indices)` from the memory-mapped shards (into pinned memory for the
    card), and its index matrix renumbered to buffer rows: the host side of
    chunked device-corpus training (JAX: `_window_batches`). Yields
    (first step, buffer, (idx, labels, mask)); capacity past the unique
    rows stays zero and is never indexed."""
    idx_mat, labels_mat, mask_mat = mats
    b = idx_mat.shape[1]
    for s0 in range(0, idx_mat.shape[0], win_steps):
        idx_w = idx_mat[s0 : s0 + win_steps]
        uniq, inv = np.unique(idx_w, return_inverse=True)
        buf = torch.empty((idx_w.shape[0] * b, segment), dtype=torch.int16, pin_memory=pinned)
        view = buf.numpy()
        view[: len(uniq)] = fetch_rows(uniq)
        view[len(uniq) :] = 0
        yield s0, buf, (
            inv.reshape(idx_w.shape).astype(np.int32),
            labels_mat[s0 : s0 + win_steps],
            mask_mat[s0 : s0 + win_steps],
        )


def _uploaded_windows(windows, dev: torch.device):
    """Host windows (`_window_batches`) as device windows, one ahead: window
    w+1's buffer uploads on a side stream, without blocking, while the
    steps of window w run, and the steps wait on an event for their own
    window's upload (JAX: `_device_prefetch`). Yields (first step, buffer
    on the device, matrices)."""
    if dev.type != "cuda":
        for s0, buf, mats in windows:
            yield s0, buf.to(dev), mats
        return
    copy_stream = torch.cuda.Stream(dev)
    main = torch.cuda.current_stream(dev)

    def put(window):
        s0, buf, mats = window
        with torch.cuda.stream(copy_stream):
            buf_d = buf.to(dev, non_blocking=True)
            ready = torch.cuda.Event()
            ready.record(copy_stream)
        buf_d.record_stream(main)  # read there: its memory waits for those reads
        return s0, buf_d, mats, ready

    it = iter(windows)
    nxt = next(it, None)
    nxt = None if nxt is None else put(nxt)
    while nxt is not None:
        cur = nxt
        following = next(it, None)
        nxt = None if following is None else put(following)
        s0, buf_d, mats, ready = cur
        main.wait_event(ready)
        yield s0, buf_d, mats


def _metric_rows(pending):
    """Per-step device metrics, a list of dicts (the eager steps) or (keys,
    (steps, k) rows) (the captured ones), as (keys, rows); [] for none."""
    if isinstance(pending, tuple) or not pending:
        return pending
    keys = list(pending[0])
    return keys, torch.stack([steps.metric_row(m, keys) for m in pending])


def _accumulate(pending) -> Tuple[EpochAccumulator, list]:
    """Fold per-step metrics, a list of dicts (the eager steps) or (keys,
    (steps, k) rows on the device or the host) (the captured ones), into an
    accumulator, with one device-to-host copy; also returns the per-step
    losses."""
    acc = EpochAccumulator()
    if isinstance(pending, tuple):
        keys, rows = pending
        rows = rows.cpu().numpy()
    elif not pending:
        return acc, []
    else:
        keys = list(pending[0])
        rows = torch.stack([steps.metric_row(m, keys) for m in pending]).cpu().numpy()
    for row in rows:
        acc.update(dict(zip(keys, row)))
    return acc, [float(np.float32(r[keys.index("loss")])) for r in rows]


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

    `device_corpus` (shards only): "auto" keeps the int16 corpus on the
    device when it fits `device_corpus_budget` bytes a device (2 GiB by
    default) times the ranks, sharded by rows past one device's budget,
    and runs chunked windows past that; True keeps it resident at any
    size; "chunked" always runs windows; False streams the loader's
    batches through pinned memory. All give the same batches.

    Data parallelism is the default, as in the JAX package: with more than
    one visible card, no process group and `device` the card without an
    index, the run is data-parallel over every card; an explicit `mesh` (a
    `parallel.Mesh` or a device list, a device may repeat) runs over its
    devices; `mesh=False` forces one device. Over a mesh of two or more
    devices this call starts one rank a device (`parallel.launch.run_ranks`:
    NCCL over distinct cards, gloo where a card repeats or on the CPU),
    each running this function in the process group, and returns rank 0's
    best checkpoint; a failed rank makes it raise. Each rank builds or
    gathers its rows of every global batch and the step reduces across the
    ranks, so the run computes what one device computes on the global
    batch, up to the order of the reductions; a batch the mesh does not
    divide pads under a mask (a corpus on the device needs one it divides).
    A mesh of one device is the one-process run on that device. With a
    `torch.distributed` process group initialized (torchrun, cli.train
    --distributed) the run is data-parallel over its ranks, the rank's
    device `device` (`cuda:LOCAL_RANK` for an unindexed "cuda"), and a mesh
    raises. `device` defaults to the card and raises if there is none.
    `noise_bank` ((N, S >= segment) float waveforms) turns on the
    file-noise augmentation."""
    if device_corpus not in ("auto", True, False, "chunked"):
        raise ValueError(
            f"device_corpus={device_corpus!r}: expected 'auto', True, False or 'chunked'"
        )
    if device_corpus in (True, "chunked") and shards_dir is None:
        raise ValueError(
            f"device_corpus={device_corpus!r} requires shards_dir (a packed corpus is what "
            f"goes to the device); pack one with cli.pack or pass device_corpus='auto'"
        )
    config = config or Config()
    on_mesh = parallel.resolve_train_mesh(
        mesh, device, config.train.batch_size if device_corpus in (True, "chunked") else None
    )
    if on_mesh is not None and on_mesh.size > 1:
        from ..parallel import launch

        print(
            f"Data-parallel over a mesh of {on_mesh.size} devices "
            f"{[str(d) for d in on_mesh.devices]} ({launch.mesh_backend(on_mesh)}): one rank a device",
            flush=True,
        )
        return launch.run_ranks(on_mesh, train, dict(
            data_dir=data_dir, output_dir=output_dir, config=config, use_esc50=use_esc50,
            esc50_dir=esc50_dir, resume=resume, num_workers=num_workers, noise_bank=noise_bank,
            max_epochs=max_epochs, mesh=None, shards_dir=shards_dir, device_corpus=device_corpus,
            device_corpus_budget=device_corpus_budget, decode_backend=decode_backend,
        ))
    if on_mesh is not None:
        device = on_mesh.devices[0]
    group = parallel.process_group() if mesh is None else None
    rank, world = (dist.get_rank(group), dist.get_world_size(group)) if group is not None else (0, 1)
    dev = resolve_device(parallel.rank_device(device) if group is not None else device)
    out = Path(output_dir)
    out.mkdir(parents=True, exist_ok=True)
    if rank == 0:
        (out / "config.json").write_text(config.to_json())
    bs = config.train.batch_size
    pad_to = -(-bs // world) * world
    lo, hi = parallel.local_row_bounds(pad_to, rank, world)
    ranks = _Ranks(group, rank, world, pad_to, lo, hi)
    if group is not None:
        print(f"Data-parallel over {world} ranks ({dist.get_backend(group)}): rank {rank} on {dev}", flush=True)
    if shards_dir is not None:
        loaders = _shard_loaders(config, shards_dir)
    else:
        loaders = _decode_loaders(config, data_dir, use_esc50, esc50_dir, num_workers, decode_backend)
    with deterministic(dev):
        return _train(
            output_dir, config, dev, ranks, resume, noise_bank, max_epochs, loaders,
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


def _placement(train_loader, val_loader, device_corpus, budget: int, ranks: _Ranks) -> str:
    """Where a shard corpus goes (JAX: train/loop.py:421-462): "resident"
    (replicated: it fits one device's budget, or device_corpus=True),
    "sharded" (by rows over the ranks: past one device's budget and within
    the budget times the ranks, or device_corpus=True past one device's),
    "chunked" (windows: past the ranks' total, or asked for), or
    "streamed" (device_corpus=False; or "auto" with a batch that does not
    split over the ranks)."""
    if not isinstance(train_loader, ShardLoader) or device_corpus is False:
        return "streamed"
    if ranks.pad_to != train_loader.batch_size:
        if device_corpus == "auto":
            return "streamed"
        raise ValueError(
            f"device_corpus={device_corpus!r} needs a batch size that splits over the "
            f"{ranks.world} ranks: batch_size={train_loader.batch_size}"
        )
    corpus_bytes = train_loader.corpus_nbytes() + val_loader.corpus_nbytes()
    if device_corpus == "chunked" or (device_corpus == "auto" and corpus_bytes > budget * ranks.world):
        return "chunked"
    return "sharded" if ranks.world > 1 and corpus_bytes > budget else "resident"


def _train(output_dir, config, dev, ranks: _Ranks, resume, noise_bank, max_epochs, loaders,
           device_corpus, budget) -> str:
    fcfg, tcfg = config.features, config.train
    out = Path(output_dir)
    is_main = ranks.rank == 0
    group, rows = ranks.group, ranks.rows()
    train_loader, val_loader, class_counts = loaders
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
    placement = _placement(train_loader, val_loader, device_corpus, budget, ranks)
    train_features, eval_features = make_feature_fns(
        config, dev, use_time_shift=isinstance(train_loader, ShardLoader), noise_bank=noise_bank
    )

    gather = None  # index_select, unless the corpus is sharded by rows
    if placement in ("resident", "sharded", "chunked"):
        corpus_bytes = train_loader.corpus_nbytes() + val_loader.corpus_nbytes()
    if placement == "chunked":
        seg = train_loader.segment_samples
        # Half the per-device budget a window buffer, so the window in use
        # and the one uploading behind it fit together.
        win_steps = max(1, (budget // 2) // (2 * seg) // tcfg.batch_size)
        print(
            f"Chunked device corpus ({corpus_bytes / 2**20:.0f} MB int16, budget {budget} bytes "
            f"a device): windows of {win_steps} steps ({win_steps * tcfg.batch_size} rows)"
        )
        pinned = dev.type == "cuda"
        val_windows = list(_window_batches(
            val_loader.epoch_batches(0), win_steps, val_loader.corpus_rows, seg, pinned
        ))

        def windows(epoch):
            mats = train_loader.epoch_batches(epoch)
            return _uploaded_windows(
                _window_batches(mats, win_steps, train_loader.corpus_rows, seg, pinned), dev
            ), mats

        def val_windows_d():
            return _uploaded_windows(val_windows, dev)
    elif placement in ("resident", "sharded"):
        if placement == "sharded":
            def load(loader):
                shard = parallel.corpus_shard(loader.corpus_rows, loader.n_clips, ranks.rank, ranks.world)
                return torch.from_numpy(shard).to(dev)

            def gather(shard, idx):
                return parallel.routed_gather(shard, idx, group)

            layout = f"sharded by rows over {ranks.world} ranks"
        else:
            def load(loader):
                return torch.from_numpy(loader.corpus()).to(dev)

            layout = "replicated"
        print(f"Device-resident corpus ({corpus_bytes / 2**20:.0f} MB int16, {layout})")
        train_corpus, val_corpus = load(train_loader), load(val_loader)
        val_mats = val_loader.epoch_batches(0)

        def windows(epoch):
            mats = train_loader.epoch_batches(epoch)
            return [(0, train_corpus, mats)], mats

        def val_windows_d():
            return [(0, val_corpus, val_mats)]
    elif group is not None:
        train_loader.set_process_slice(ranks.lo, ranks.hi, ranks.pad_to)
        val_loader.set_process_slice(ranks.lo, ranks.hi, ranks.pad_to)
        print(f"Input sharding: rank {ranks.rank} builds batch rows [{ranks.lo}, {ranks.hi}) of {ranks.pad_to}")

    rand = steps.StepRandom(dev)
    pipelined = _PIPELINED and ranks.world == 1 and placement == "resident"
    held: Optional[list] = None  # a pipelined epoch's probe lines, printed when it is finished

    def say(line: str) -> None:
        if held is None:
            _say(line)
        else:
            held.append(line)

    def window_steps(corpus, mats):
        return _hashed(steps.window_batches(corpus, mats, ranks.lo, ranks.hi, gather), ranks.lo, say)

    # The steps as captured CUDA graphs on the card (the JAX package's
    # jitted and scanned steps), unless the process group is gloo, whose
    # collectives a graph cannot hold: decided here, from the backend,
    # before any capture.
    graphed = _graphed_steps(dev, group)
    if graphed:
        def probe(waves, labels):
            if _debug():
                _debug_row_hashes(ranks.lo, waves.cpu().numpy(), labels.cpu().numpy(), say)

        programs = steps.StepPrograms(
            model, optimizer, class_weights, rand, train_features, eval_features,
            mixup_alpha=mixup_alpha, rows=rows, gather=gather,
            probe=None if placement == "streamed" else probe,
        )
        train_window, eval_window = steps.make_window_fns(programs)
        statics = {}  # chunked windows: one corpus buffer a role, so its graphs read one address
        print(
            "Steps: captured CUDA graphs, one a (train or eval, masked or not, batch, input) key"
            if dev.type == "cuda" else "Steps: captured programs, called directly on the CPU",
            flush=True,
        )
    elif dev.type != "cuda":
        print("Steps: eager (the CPU runs the plain steps)", flush=True)
    elif group is not None:
        print(f"Steps: eager ({dist.get_backend(group)}'s collectives cannot be captured)", flush=True)
    else:
        print("Steps: eager", flush=True)

    def static_window(role, corpus):
        if placement != "chunked":
            return corpus
        buf = statics.get(role)
        if buf is None or buf.shape[0] < corpus.shape[0]:
            buf = statics[role] = torch.empty_like(corpus)
        buf[: corpus.shape[0]].copy_(corpus)
        return buf

    def run_train_graphed(epoch, ws):
        if placement == "streamed":
            rows_ = [
                programs.train(None, None, labels, mask, tcfg.seed, epoch, s, waves=waves)
                for s, (waves, labels, mask) in enumerate(_host_batches(train_loader, epoch, ranks))
            ]
            return steps.TRAIN_KEYS, torch.stack(rows_)
        return steps.TRAIN_KEYS, torch.cat([
            train_window(static_window("train", corpus), mats_w, tcfg.seed, epoch, s0) for s0, corpus, mats_w in ws
        ])

    def run_eval_graphed():
        if placement == "streamed":
            rows_ = [
                programs.eval(None, None, labels, mask, waves=waves)
                for waves, labels, mask in _host_batches(val_loader, 0, ranks)
            ]
            return steps.EVAL_KEYS, torch.stack(rows_)
        return steps.EVAL_KEYS, torch.cat([
            eval_window(static_window("val", corpus), mats_w) for _, corpus, mats_w in val_windows_d()
        ])

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

    metrics_log = JsonlLogger(str(out / "metrics.jsonl")) if is_main else None
    epochs = max_epochs if max_epochs is not None else tcfg.epochs
    best_path = str(out / "best_model")
    # One process writes on the background thread; across ranks rank 0
    # writes synchronously and a barrier follows before any rank reads.
    background = ranks.world == 1
    loop_t0 = time.perf_counter()

    def epoch_tail(ep, acc, vacc, train_time, val_time, tree=None) -> bool:
        """JSONL record, console line, early-stop advance, best/latest
        checkpoints from `tree` (a pipelined epoch's fetched snapshot) or
        from a snapshot taken now. True when early stopping fires at epoch
        `ep`."""
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
        if is_main:
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
        # The previous epoch's writes land before this epoch's snapshot,
        # which both saves share; it is taken before the next step updates
        # the parameters in place.
        if background:
            ckpt.drain_pending_saves()
        if tree is None and is_main:
            tree = ckpt.snapshot(model, optimizer)
        save = dict(tree=tree, block=not background)
        if val_m["f1"] > best_f1:
            best_f1 = val_m["f1"]
            if is_main:
                ckpt.save_checkpoint(output_dir, "best_model", None, None, ep, val_m, config, **save)
                print(f"  Saved best model (F1: {best_f1:.4f})")
        if is_main:
            ckpt.save_checkpoint(
                output_dir, "latest_model", None, None, ep, val_m, config,
                extra={"early_stop": {"best_loss": early.best_loss, "counter": early.counter}},
                **save,
            )
        if ranks.world > 1:
            dist.barrier(group)
        if stop and is_main:
            print(f"Early stopping at epoch {ep}")
        return stop

    def run_train(epoch):
        if graphed and placement == "streamed":
            return run_train_graphed(epoch, None)
        if placement == "streamed":
            return steps.train_steps(
                model, optimizer, _streamed_batches(train_loader, epoch, dev, ranks),
                class_weights, rand, tcfg.seed, epoch, 0, train_features, mixup_alpha, rows,
            )
        ws, mats = windows(epoch)
        if _debug():
            crc = 0
            for m in mats:
                crc = zlib.crc32(np.ascontiguousarray(m).tobytes(), crc)
            say(f"SCAN_MATS epoch={epoch} crc={crc}")
        if graphed:
            return run_train_graphed(epoch, ws)
        pending = []
        for s0, corpus, mats_w in ws:
            pending += steps.train_steps(
                model, optimizer, window_steps(corpus, mats_w), class_weights, rand,
                tcfg.seed, epoch, s0, train_features, mixup_alpha, rows,
            )
        return pending

    def run_eval():
        if graphed:
            return run_eval_graphed()
        if placement == "streamed":
            return steps.eval_steps(
                model, _streamed_batches(val_loader, 0, dev, ranks), class_weights, eval_features, rows
            )
        pending = []
        for _, corpus, mats_w in val_windows_d():
            pending += steps.eval_steps(model, window_steps(corpus, mats_w), class_weights, eval_features, rows)
        return pending

    def dispatch(epoch: int) -> dict:
        """Enqueue epoch `epoch`'s train and validation steps, then a device
        copy of the state they leave and an event behind it (pipelined);
        nothing here waits for the card. Returns what `finish` fetches."""
        nonlocal held
        held = []
        # The range chip_smoke.py reads the epoch's device idle share in,
        # open from dispatch to fetch: a pipelined epoch's overlaps the next.
        span = torch.profiler.record_function("cdt.epoch")
        span.__enter__()
        before = graphs._launches()
        t0 = time.perf_counter()
        metrics = (_metric_rows(run_train(epoch)), _metric_rows(run_eval()))
        tree = ckpt.snapshot(model, optimizer, on_device=True)
        done = None
        if dev.type == "cuda":
            done = torch.cuda.Event()
            done.record(torch.cuda.current_stream(dev))
        launched = tuple(a - b for a, b in zip(graphs._launches(), before))
        return dict(epoch=epoch, t0=t0, span=span, metrics=metrics, tree=tree, done=done,
                    launched=launched, lines=held)

    def finish(f: dict) -> bool:
        """Fetch a dispatched epoch's metrics and state on a side stream
        behind its own work alone (graphs.fetch), print its probe lines and
        run its tail. True when early stopping fires."""
        metrics, tree = graphs.fetch((f["metrics"], f["tree"]), f["done"])
        f["span"].__exit__(None, None, None)
        # One window for both rates, as the JAX loop's: the two passes are
        # in flight together and are not timed apart.
        window = time.perf_counter() - f["t0"]
        acc, losses = _accumulate(metrics[0])
        vacc, _ = _accumulate(metrics[1])
        for line in f["lines"]:
            _say(line)
        if _debug():
            _say(f"STEP_LOSSES epoch={f['epoch']} {json.dumps(losses)}")
        return epoch_tail(f["epoch"], acc, vacc, window, window, tree)

    def discard(f: dict, stopped: dict) -> None:
        """Drop epoch `f`, dispatched before `stopped` (the epoch before it)
        stopped the run: its launches come off the counters, its probe
        lines go unprinted, and the model, its BatchNorm statistics and the
        optimizer go back to `stopped`'s device copy, enqueued behind it."""
        f["span"].__exit__(None, None, None)
        graphs._add_launches(tuple(-n for n in f["launched"]))
        model.load_state_dict(stopped["tree"]["model"])
        optimizer.load_state_dict(stopped["tree"]["optimizer"])

    try:
        if pipelined:
            inflight = None
            for epoch in range(start_epoch, epochs):
                try:
                    cur = dispatch(epoch)
                except BaseException as err:
                    # A failed epoch leaves the one before it recorded and
                    # saved, as the synchronous loop does.
                    if inflight is not None:
                        try:
                            finish(inflight)
                        except BaseException as tail_err:
                            err.add_note(f"finishing epoch {inflight['epoch']} failed too: {tail_err!r}")
                    raise
                if inflight is not None and finish(inflight):
                    discard(cur, inflight)
                    inflight = None
                    break
                inflight = cur
            held = None
            if inflight is not None:
                finish(inflight)
        else:
            for epoch in range(start_epoch, epochs):
                # The range chip_smoke.py reads the epoch's device idle share in.
                with trace_span("cdt.epoch"):
                    t0 = time.perf_counter()
                    acc, losses = _accumulate(run_train(epoch))
                    train_time = time.perf_counter() - t0
                    t0 = time.perf_counter()
                    vacc, _ = _accumulate(run_eval())
                    val_time = time.perf_counter() - t0
                if _debug():
                    _say(f"STEP_LOSSES epoch={epoch} {json.dumps(losses)}")
                if epoch_tail(epoch, acc, vacc, train_time, val_time):
                    break
    except BaseException as err:
        # No writer outlives train(), and the loop's error is the one raised.
        try:
            ckpt.drain_pending_saves()
        except BaseException as save_err:
            err.add_note(f"a pending checkpoint save failed too: {save_err!r}")
        raise
    finally:
        if metrics_log is not None:
            metrics_log.close()
    # Rows this rank read from the shards or decoded: the ranks' counts sum
    # to one process's on the streamed path and for a corpus sharded by rows.
    print(
        f"Input rows built (rank {ranks.rank}): train {train_loader.rows_built}, "
        f"val {val_loader.rows_built}",
        flush=True,
    )
    if _debug():
        from ..ops import frontend_kernel

        print(
            f"KERNEL_LAUNCHES rank={ranks.rank} spectral={frontend_kernel.SPECTRAL_LAUNCHES} "
            f"epilogue={frontend_kernel.EPILOGUE_LAUNCHES}",
            flush=True,
        )
    # The returned best_path is committed: callers load it at once.
    ckpt.drain_pending_saves()
    if is_main:
        print(f"Training complete! Best F1: {best_f1:.4f}")
    return best_path
