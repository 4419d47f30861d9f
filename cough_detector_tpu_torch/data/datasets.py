"""Datasets and the batched host input pipeline, the port's copy.

The port of `cough_detector_tpu/data/datasets.py`. The host does only I/O
(decode + resample + fixed-length crop, thread-pooled and prefetched) and
yields dense (B, segment_samples) float32 batches; normalization,
augmentation and features run on the device in the train step.

Class and label conventions are the reference's (src/dataset.py):
  classes = ['non_cough', 'cough'] → labels 0/1 (:70-71)
  ESC-50 cough target 24, curated negatives, fold splits (:176-296)
  inverse-frequency sample weights (:109-116)

Epoch k's sample order and crop-shift draws come from numpy's
(seed, k) generator alone, so the port's loaders yield the same batches as
the JAX package's for the same corpus, bit for bit, and a resumed run
replays exactly the batches an uninterrupted one saw. The seeded stratified
split is scikit-learn's `train_test_split(stratify=...)` in numpy, with
the same draws. `BatchLoader(backend="native")` decodes whole batches in
C++ (`native_loader.py`), within 2e-5 of the Python decoder. Under
data-parallel training each rank builds only its rows of every global
batch (`set_process_slice`), while the order and the crop-shift draws stay
those of the global batch.
"""

from __future__ import annotations

import collections
import concurrent.futures
import csv
import queue
import threading
from pathlib import Path
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from ..config import FeatureConfig
from . import audio_io

Sample = Tuple[str, int]

CLASSES = ["non_cough", "cough"]


class ClipDataset:
    """A list of (path, label) samples + class statistics."""

    def __init__(self, samples: Sequence[Sample]):
        self.samples = list(samples)
        self.class_counts = self._count_classes()
        self.sample_weights = self._compute_sample_weights()

    def _count_classes(self) -> Dict[int, int]:
        counts = {i: 0 for i in range(len(CLASSES))}
        for _, label in self.samples:
            counts[label] = counts.get(label, 0) + 1
        return counts

    def _compute_sample_weights(self) -> np.ndarray:
        """Inverse-frequency weights for balanced sampling
        (reference: src/dataset.py:109-116)."""
        total = len(self.samples)
        w = np.empty(total, np.float64)
        for i, (_, label) in enumerate(self.samples):
            w[i] = total / (len(CLASSES) * max(self.class_counts[label], 1))
        return w

    def __len__(self) -> int:
        return len(self.samples)


class CoughDataset(ClipDataset):
    """Directory-per-class dataset: data_dir/{cough,non_cough}/*.{wav,...}
    (reference: src/dataset.py:25-100)."""

    def __init__(self, data_dir: str):
        self.data_dir = Path(data_dir)
        samples: List[Sample] = []
        for label, class_name in enumerate(CLASSES):
            class_dir = self.data_dir / class_name
            if not class_dir.exists():
                print(f"Warning: Class directory {class_dir} not found")
                continue
            for f in sorted(class_dir.iterdir()):
                if f.suffix.lower() in audio_io.AUDIO_EXTENSIONS:
                    samples.append((str(f), label))
        super().__init__(samples)


def read_esc50_meta(esc50_dir) -> List[Dict[str, str]]:
    """The rows of ESC-50's meta/esc50.csv, in file order, as dicts of
    strings (the csv module: the card's machine has no pandas)."""
    meta_path = Path(esc50_dir) / "meta" / "esc50.csv"
    if not meta_path.exists():
        raise FileNotFoundError(f"ESC-50 metadata not found at {meta_path}")
    with meta_path.open(newline="") as fh:
        return list(csv.DictReader(fh))


class ESC50Dataset(ClipDataset):
    """ESC-50 handler: cough class 24 positive; curated or all-other-class
    negatives; 5-fold train/val splits (reference: src/dataset.py:176-264).
    """

    COUGH_CLASS = 24
    NEGATIVE_CLASSES = [20, 21, 22, 23, 25, 26, 38]

    def __init__(
        self,
        data_dir: str,
        is_training: bool = True,
        fold: Optional[int] = None,
        include_all_negatives: bool = True,
    ):
        self.data_dir = Path(data_dir)
        meta = read_esc50_meta(self.data_dir)
        if fold is not None:
            meta = [r for r in meta if (int(r["fold"]) != fold) == is_training]

        audio_dir = self.data_dir / "audio"
        samples: List[Sample] = []
        for row in meta:
            path = audio_dir / row["filename"]
            if not path.exists():
                continue
            target = int(row["target"])
            if target == self.COUGH_CLASS:
                samples.append((str(path), 1))
            elif include_all_negatives or target in self.NEGATIVE_CLASSES:
                samples.append((str(path), 0))
        super().__init__(samples)


class CombinedDataset(ClipDataset):
    """Concatenation of datasets (reference: src/dataset.py:299-330)."""

    def __init__(self, datasets: Sequence[ClipDataset]):
        samples: List[Sample] = []
        for ds in datasets:
            samples.extend(ds.samples)
        super().__init__(samples)


def _approximate_mode(class_counts: np.ndarray, n_draws: int, rng) -> np.ndarray:
    """Per-class draw counts, ties broken by `rng`: scikit-learn's
    `utils.extmath._approximate_mode`, draw for draw."""
    continuous = class_counts / class_counts.sum() * n_draws
    floored = np.floor(continuous)
    need_to_add = int(n_draws - floored.sum())
    if need_to_add > 0:
        remainder = continuous - floored
        for value in np.sort(np.unique(remainder))[::-1]:
            (inds,) = np.where(remainder == value)
            add_now = min(len(inds), need_to_add)
            inds = rng.choice(inds, size=add_now, replace=False)
            floored[inds] += 1
            need_to_add -= add_now
            if need_to_add == 0:
                break
    return floored.astype(int)


def stratified_split(
    labels: Sequence[int], test_size: float, random_state: int
) -> Tuple[np.ndarray, np.ndarray]:
    """(train, test) index arrays: scikit-learn's
    `train_test_split(indices, test_size=test_size, random_state=random_state,
    stratify=labels)` (its StratifiedShuffleSplit, one split), with the
    same draws from `np.random.RandomState(random_state)`."""
    y = np.asarray(labels)
    n = len(y)
    if not 0.0 < test_size < 1.0:
        raise ValueError(f"test_size={test_size} should be a float in the (0, 1) range")
    n_test = int(np.ceil(test_size * n))
    n_train = n - n_test
    classes, y_idx, class_counts = np.unique(y, return_inverse=True, return_counts=True)
    if np.min(class_counts) < 2:
        raise ValueError(
            "The least populated class in y has only 1 member, which is too few. "
            f"Classes with too few members are: {classes[class_counts < 2].tolist()}"
        )
    if n_train < len(classes) or n_test < len(classes):
        raise ValueError(
            f"train ({n_train}) and test ({n_test}) sizes must each be at least the "
            f"number of classes ({len(classes)})"
        )
    class_indices = np.split(np.argsort(y_idx, kind="stable"), np.cumsum(class_counts)[:-1])
    rng = np.random.RandomState(random_state)
    n_i = _approximate_mode(class_counts, n_train, rng)
    t_i = _approximate_mode(class_counts - n_i, n_test, rng)
    train: List[int] = []
    test: List[int] = []
    for i in range(len(classes)):
        perm = class_indices[i].take(rng.permutation(class_counts[i]), mode="clip")
        train.extend(perm[: n_i[i]])
        test.extend(perm[n_i[i] : n_i[i] + t_i[i]])
    return rng.permutation(train), rng.permutation(test)


def prepare_dataset_split(
    data_dir: str,
    val_split: float = 0.2,
    random_state: int = 42,
) -> Tuple[CoughDataset, CoughDataset]:
    """Stratified train/val split of one directory, seed 42: the
    reference's selection (src/dataset.py:421-483)."""
    full = CoughDataset(data_dir)
    train_idx, val_idx = stratified_split(
        [label for _, label in full.samples], val_split, random_state
    )

    # One directory scan, two views.
    def view(idx) -> CoughDataset:
        ds = CoughDataset.__new__(CoughDataset)
        ds.data_dir = full.data_dir
        ClipDataset.__init__(ds, [full.samples[i] for i in idx])
        return ds

    return view(train_idx), view(val_idx)


# ---------------------------------------------------------------------------
# Batched loader: host I/O threads → prefetched dense waveform batches
# ---------------------------------------------------------------------------


def _crop_window(wave: np.ndarray, segment_samples: int, shift: int = 0) -> np.ndarray:
    """Center pad/trim a full clip to segment length, optionally with the
    window displaced by `shift` samples.

    shift=0 is the reference's center pad_or_trim (src/preprocessing.py:
    358-385). A nonzero shift is the reference's full-clip
    time_shift-then-center-trim: shifting the whole waveform by +a and
    center-trimming equals cropping the window at center-a, with zero
    fill where the window leaves the clip (src/augmentation.py:95-104
    then src/dataset.py:156-160), so shifted-in content is real adjacent
    audio.
    """
    n = wave.shape[0]
    # final[j] = x[c + j - shift] iff both the destination index c + j and
    # the source index c + j - shift lie inside [0, n). c truncates toward
    # zero: the reference's pad branch puts pad//2 zeros on the left.
    if n >= segment_samples:
        c = (n - segment_samples) // 2
    else:
        c = -((segment_samples - n) // 2)
    out = np.zeros(segment_samples, np.float32)
    j_lo = max(-c, shift - c, 0)
    j_hi = min(n - c, n - c + shift, segment_samples)
    if j_hi > j_lo:
        src = c - shift
        out[j_lo:j_hi] = wave[src + j_lo : src + j_hi]
    return out


class _EpochKeyedLoader:
    """Epoch-keyed determinism + bounded background prefetch.

    Epoch k's sample order derives from (seed, k) only, never from how
    many epochs ran before, so a resumed run replays bit-exact. Iteration
    produces batches on a daemon thread behind a bounded queue; abandoned
    iterators (consumer exception/break) release the producer instead of
    leaking it.

    Subclass contract: __init__ must set batch_size / shuffle / weighted /
    drop_last / prefetch / _seed / _epoch=0 / _pinned=False, and the class
    must define `_n_samples()` (corpus size), `_order_weights()` (weights
    for weighted sampling), `_producer_scope()` (context manager whose
    value is handed to each batch build: a thread pool, or a null context)
    and `_batch_at(idxs, scope, rng)` (build one batch).
    """

    # Rows [lo, hi) of each batch padded to pad_to that this process builds
    # (set_process_slice); None builds whole batches.
    _local_rows = None
    # Real rows this loader built (decoded and cropped, or gathered). Under
    # process slicing the ranks' counts sum to the one-process count.
    rows_built = 0

    def set_process_slice(self, lo: int, hi: int, pad_to: int) -> None:
        """Build only rows [lo, hi) of each batch padded to `pad_to` rows:
        this rank's rows under data-parallel training. The epoch order and
        every draw that shapes it (sampling, crop shifts) stay the global
        batch's, so the rows equal the one-process batch's rows bit for
        bit. Batches then come as (local waves, local labels, n_global),
        the real rows zero-padded to hi - lo; n_global, the global batch's
        real row count, decides the mask."""
        if not (0 <= lo <= hi <= pad_to):
            raise ValueError(f"bad process slice [{lo}, {hi}) of {pad_to}")
        self._local_rows = (int(lo), int(hi), int(pad_to))

    def _slice_bounds(self, n_global: int) -> Tuple[int, int]:
        """This rank's rows of a batch with n_global real rows, clamped
        (the tail batch can end inside or before the slice)."""
        lo, hi, _ = self._local_rows
        return min(lo, n_global), min(hi, n_global)

    def _pad_local(self, waves: np.ndarray, labels: np.ndarray, n_global: int):
        lo, hi, _ = self._local_rows
        w_out = np.zeros((hi - lo, waves.shape[1]), waves.dtype)
        l_out = np.zeros(hi - lo, np.int32)
        w_out[: waves.shape[0]] = waves
        l_out[: waves.shape[0]] = labels
        return w_out, l_out, n_global

    def __len__(self) -> int:
        n = self._n_samples()
        if self.drop_last:
            return n // self.batch_size
        return -(-n // self.batch_size)

    def set_epoch(self, epoch: int) -> None:
        """Pin the epoch the next iteration draws its order for. Pinning is
        sticky: once any caller pins, the loader stops auto-advancing on
        iterator close, so a pinned consumer that breaks out of an epoch
        sees exactly the epoch it pinned on the next pass."""
        self._epoch = int(epoch)
        self._pinned = True

    def _epoch_rng(self) -> np.random.Generator:
        return np.random.default_rng([self._seed, self._epoch])

    def _epoch_order(self, rng: np.random.Generator) -> np.ndarray:
        n = self._n_samples()
        if self.weighted:
            w = self._order_weights()
            return rng.choice(n, size=n, replace=True, p=w / w.sum())
        idx = np.arange(n)
        if self.shuffle:
            rng.shuffle(idx)
        return idx

    def __iter__(self) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        rng = self._epoch_rng()
        order = self._epoch_order(rng)
        n_batches = len(self)
        out_q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        sentinel = object()
        abandoned = threading.Event()

        def put(item) -> bool:
            # A bounded put that gives up once the consumer went away, so an
            # abandoned iterator never leaves this thread blocked forever.
            while not abandoned.is_set():
                try:
                    out_q.put(item, timeout=0.5)
                    return True
                except queue.Full:
                    continue
            return False

        def producer():
            try:  # surface batch-build errors, never hang
                with self._producer_scope() as scope:
                    for b in range(n_batches):
                        idxs = order[b * self.batch_size : (b + 1) * self.batch_size]
                        if not put(self._batch_at(idxs, scope, rng)):
                            return
            except BaseException as e:
                put(e)
            finally:
                put(sentinel)

        thread = threading.Thread(target=producer, daemon=True)
        thread.start()
        try:
            while True:
                item = out_q.get()
                if item is sentinel:
                    break
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            abandoned.set()
            thread.join(timeout=5.0)
            # Unpinned loaders advance a fresh order each bare pass; pinned
            # ones (set_epoch, the train loop) never do.
            if not self._pinned:
                self._epoch += 1


class BatchLoader(_EpochKeyedLoader):
    """Iterates (waves[B, segment] float32, labels[B] int32) batches with
    thread-pooled decode and background prefetch.

    Weighted sampling with replacement is the reference's
    WeightedRandomSampler + drop_last (src/dataset.py:368-418).
    `backend`: "python" decodes in this process's threads (with an LRU
    clip cache); "native" decodes each batch in C++ on `num_workers`
    threads without the interpreter lock (native_loader.py; no clip
    cache) and raises if the library cannot be built or a sample is not
    a .wav; "auto" is "native" when every sample is a .wav and the library
    builds, else "python" (a missing g++ is said once).
    """

    def __init__(
        self,
        dataset: ClipDataset,
        batch_size: int,
        feature_config: FeatureConfig = FeatureConfig(),
        shuffle: bool = False,
        weighted: bool = False,
        drop_last: bool = False,
        num_workers: int = 8,
        prefetch: int = 4,
        seed: int = 0,
        backend: str = "auto",
        time_shift_limit: float = 0.0,
        time_shift_prob: float = 0.0,
        cache_bytes: int = 2 << 30,
    ):
        if backend not in ("auto", "python", "native"):
            raise ValueError(f"backend={backend!r}: expected 'auto', 'python' or 'native'")
        self.dataset = dataset
        self.batch_size = batch_size
        self.cfg = feature_config
        self.shuffle = shuffle
        self.weighted = weighted
        self.drop_last = drop_last
        self.num_workers = max(1, num_workers)
        self.prefetch = prefetch
        # Time shift at crop time, against the full decoded clip (the
        # reference's semantics, _crop_window); a device-side shift would
        # only see the cropped window.
        self.time_shift_limit = time_shift_limit
        self.time_shift_prob = time_shift_prob
        self._seed = seed
        self._epoch = 0
        self._pinned = False
        # Bounded LRU over full decoded clips (cache_bytes=0 disables).
        self._cache: "collections.OrderedDict[str, np.ndarray]" = collections.OrderedDict()
        self._cache_bytes = cache_bytes
        self._cache_used = 0
        self._cache_lock = threading.Lock()
        self._native = False
        if backend in ("auto", "native"):
            all_wav = len(dataset.samples) > 0 and all(
                p.lower().endswith(".wav") for p, _ in dataset.samples
            )
            if all_wav:
                from . import native_loader

                if backend == "native":
                    native_loader.require()  # raises with the build's error
                    self._native = True
                else:
                    self._native = native_loader.available()
            elif backend == "native":
                raise RuntimeError("the native loader decodes .wav datasets only")

    def _n_samples(self) -> int:
        return len(self.dataset)

    def _order_weights(self) -> np.ndarray:
        return self.dataset.sample_weights

    def _producer_scope(self):
        return concurrent.futures.ThreadPoolExecutor(self.num_workers)

    def _batch_at(self, idxs, scope, rng):
        return self._make_batch(idxs, scope, rng)

    def _load_full(self, path: str) -> np.ndarray:
        with self._cache_lock:
            hit = self._cache.get(path)
            if hit is not None:
                self._cache.move_to_end(path)
                return hit
        clip = audio_io.load_mono_16k(path, self.cfg.sample_rate).astype(np.float32)
        if self._cache_bytes > 0:
            with self._cache_lock:
                # Re-check under the lock: duplicate indices (weighted
                # sampling with replacement) decode concurrently, and a
                # blind insert would double-count _cache_used forever.
                if path not in self._cache:
                    self._cache[path] = clip
                    self._cache_used += clip.nbytes
                while self._cache_used > self._cache_bytes and self._cache:
                    _, evicted = self._cache.popitem(last=False)
                    self._cache_used -= evicted.nbytes
        return clip

    def _shifts_for(self, n: int, rng: np.random.Generator) -> np.ndarray:
        if self.time_shift_prob <= 0.0 or self.time_shift_limit <= 0.0:
            return np.zeros(n)
        apply = rng.uniform(size=n) <= self.time_shift_prob
        # Relative to each clip's full length, resolved at crop time.
        frac = rng.uniform(-self.time_shift_limit, self.time_shift_limit, size=n)
        return np.where(apply, frac, 0.0)

    def _make_batch(self, idxs: np.ndarray, pool, rng: np.random.Generator) -> Tuple[np.ndarray, np.ndarray]:
        paths = [self.dataset.samples[i][0] for i in idxs]
        labels = np.asarray([self.dataset.samples[i][1] for i in idxs], np.int32)
        # Crop-shift draws are always full-batch-shaped, before any process
        # slicing: the draws are part of the (seed, epoch) contract.
        fracs = self._shifts_for(len(paths), rng)
        n_global = len(idxs)
        if self._local_rows is not None:
            s_lo, s_hi = self._slice_bounds(n_global)
            paths, fracs, labels = paths[s_lo:s_hi], fracs[s_lo:s_hi], labels[s_lo:s_hi]
        self.rows_built += len(paths)
        waves = self._decode(paths, fracs, pool)
        if self._local_rows is None:
            return waves, labels
        return self._pad_local(waves, labels, n_global)

    def _decode(self, paths: List[str], fracs: np.ndarray, pool) -> np.ndarray:
        if not paths:
            return np.zeros((0, self.cfg.segment_samples), np.float32)
        if self._native:
            return self._native_batch(paths, fracs)

        def load_one(args):
            path, frac = args
            clip = self._load_full(path)
            shift = int(round(float(frac) * clip.shape[0]))
            return _crop_window(clip, self.cfg.segment_samples, shift)

        return np.stack(list(pool.map(load_one, zip(paths, fracs))))

    def _native_batch(self, paths: List[str], fracs: np.ndarray) -> np.ndarray:
        from . import native_loader

        waves, n_ok, errors = native_loader.load_batch(
            paths, self.cfg.segment_samples, self.cfg.sample_rate,
            n_threads=self.num_workers,
            shift_fracs=fracs if np.any(fracs) else None,
        )
        if n_ok < len(paths):  # fail as the Python decoder does
            raise audio_io.AudioDecodeError(
                f"{len(paths) - n_ok} clip(s) failed to decode: {errors}"
            )
        return waves


def create_data_loaders(
    train_dataset: ClipDataset,
    val_dataset: ClipDataset,
    batch_size: int = 32,
    num_workers: int = 4,
    use_weighted_sampler: bool = True,
    feature_config: FeatureConfig = FeatureConfig(),
) -> Tuple[BatchLoader, BatchLoader]:
    """Reference-API loader factory (reference: src/dataset.py:368-418):
    weighted-with-replacement + drop_last training loader, sequential
    validation loader."""
    train_loader = BatchLoader(
        train_dataset, batch_size, feature_config,
        shuffle=not use_weighted_sampler,
        weighted=use_weighted_sampler, drop_last=True,
        num_workers=num_workers,
    )
    val_loader = BatchLoader(val_dataset, batch_size, feature_config, num_workers=num_workers)
    return train_loader, val_loader
