"""Training: steps, optimizer, schedule, metrics, checkpoints, loop."""

from . import checkpoint, loop, metrics, schedule, steps
from .loop import train
from .metrics import EarlyStopping, EpochAccumulator
from .schedule import cosine_warm_restarts_lr, make_epoch_schedule
from .steps import (
    ClippedAdamW,
    StepRandom,
    compute_class_weights,
    eval_step,
    loss_and_grads,
    make_optimizer,
    train_step,
    weighted_cross_entropy,
)

__all__ = [
    "checkpoint", "loop", "metrics", "schedule", "steps", "train",
    "EarlyStopping", "EpochAccumulator", "cosine_warm_restarts_lr",
    "make_epoch_schedule", "ClippedAdamW", "StepRandom",
    "compute_class_weights", "eval_step", "loss_and_grads", "make_optimizer",
    "train_step", "weighted_cross_entropy",
]
