"""The epoch-keyed batch loader base, the port's copy.

A copy of `_EpochKeyedLoader` from `cough_detector_tpu/data/datasets.py`:
epoch k's sample order is drawn by numpy from (seed, k) alone, so the
port's loaders yield the same batches as the JAX package's for the same
corpus, and a resumed run replays exactly the order an uninterrupted one
saw. The decode-path `BatchLoader` and the datasets are not ported yet
(ROADMAP Queue 1 item 10a); the multi-host process slicing comes with
`torch.distributed` (item 11).
"""

from __future__ import annotations

import queue
import threading
from typing import Iterator, Tuple

import numpy as np


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
    value is handed to each batch build) and `_batch_at(idxs, scope, rng)`
    (build one batch).
    """

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
