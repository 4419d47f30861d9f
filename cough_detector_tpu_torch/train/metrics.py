"""Metric aggregation and early stopping, the port's copy of
`cough_detector_tpu/train/metrics.py`: precision/recall/F1 for the cough
class and epoch averages with the reference's conventions
(reference: src/train.py:31-51,157-180)."""

from __future__ import annotations

from typing import Dict


class EpochAccumulator:
    """Host-side accumulation of per-batch metrics."""

    def __init__(self):
        self.loss_sum = 0.0
        self.n_batches = 0
        self.correct = 0
        self.count = 0
        self.tp = self.fp = self.fn = self.tn = 0

    def update(self, m: Dict) -> None:
        self.loss_sum += float(m["loss"])
        self.n_batches += 1
        self.correct += int(m["correct"])
        self.count += int(m["count"])
        for k in ("tp", "fp", "fn", "tn"):
            if k in m:
                setattr(self, k, getattr(self, k) + int(m[k]))

    def summary(self) -> Dict[str, float]:
        """loss = mean of batch means, accuracy in percent, P/R/F1 on the
        cough class with 0 fallbacks."""
        out = {
            "loss": self.loss_sum / max(self.n_batches, 1),
            "accuracy": 100.0 * self.correct / max(self.count, 1),
        }
        precision = self.tp / (self.tp + self.fp) if (self.tp + self.fp) > 0 else 0
        recall = self.tp / (self.tp + self.fn) if (self.tp + self.fn) > 0 else 0
        f1 = (
            2 * precision * recall / (precision + recall)
            if (precision + recall) > 0
            else 0
        )
        out.update(
            precision=precision, recall=recall, f1=f1,
            tp=self.tp, fp=self.fp, fn=self.fn, tn=self.tn,
        )
        return out


class EarlyStopping:
    """Patience on validation loss with min_delta."""

    def __init__(self, patience: int = 10, min_delta: float = 0.001):
        self.patience = patience
        self.min_delta = min_delta
        self.counter = 0
        self.best_loss = None
        self.early_stop = False

    def __call__(self, val_loss: float) -> bool:
        if self.best_loss is None:
            self.best_loss = val_loss
        elif val_loss > self.best_loss - self.min_delta:
            self.counter += 1
            if self.counter >= self.patience:
                self.early_stop = True
        else:
            self.best_loss = val_loss
            self.counter = 0
        return self.early_stop
