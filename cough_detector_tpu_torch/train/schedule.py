"""LR schedule: cosine annealing with warm restarts, torch semantics.

The port of `cough_detector_tpu/train/schedule.py`. The reference steps
CosineAnnealingWarmRestarts(T_0=10, T_mult=2, eta_min=1e-6) once per epoch
(reference: src/train.py:451-456,484); the schedule here is a function of
the optimizer's update count that holds each epoch's rate constant, read
at the count before the update (optax's convention), from a float32 table.
"""

from __future__ import annotations

import math
from typing import Callable

import numpy as np


def cosine_warm_restarts_lr(
    epoch: int,
    base_lr: float,
    t_0: int = 10,
    t_mult: int = 2,
    eta_min: float = 1e-6,
) -> float:
    """Learning rate in effect during `epoch` (0-indexed)."""
    if epoch < 0:
        raise ValueError("epoch must be >= 0")
    t_i, start = t_0, 0
    while epoch >= start + t_i:
        start += t_i
        t_i *= t_mult
    t_cur = epoch - start
    return eta_min + (base_lr - eta_min) * (1 + math.cos(math.pi * t_cur / t_i)) / 2


def make_epoch_schedule(
    base_lr: float,
    steps_per_epoch: int,
    t_0: int = 10,
    t_mult: int = 2,
    eta_min: float = 1e-6,
    max_epochs: int = 1024,
) -> Callable[[int], float]:
    """count → the learning rate of update `count` (0 for the first): epoch
    count // steps_per_epoch's rate, rounded to float32, the last epoch's
    past max_epochs."""
    table = np.asarray(
        [cosine_warm_restarts_lr(e, base_lr, t_0, t_mult, eta_min) for e in range(max_epochs)],
        dtype=np.float32,
    )
    spe = max(int(steps_per_epoch), 1)

    def schedule(count: int) -> float:
        return float(table[min(max(count // spe, 0), max_epochs - 1)])

    return schedule
