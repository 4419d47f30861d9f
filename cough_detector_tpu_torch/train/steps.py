"""Train and eval steps, in torch.

The port of `cough_detector_tpu/train/steps.py`: forward, class-weighted
CE, backward, clip_by_global_norm(1.0) and AdamW (reference:
src/train.py:54-111,441-448). The optimizer reproduces optax's
`chain(clip_by_global_norm, adamw)` arithmetic rather than
`torch.optim.AdamW`'s: the clip scales by max_norm / norm only when the
norm reaches max_norm (torch's clip_grad_norm_ divides by norm + 1e-6),
the decay is added to the Adam direction before the learning rate scales
it, and the rate is the schedule's at the update count before the update.

The JAX package's whole-epoch scan programs become plain per-step
iteration in train/loop.py.

Every random draw of a step comes from `StepRandom`, keyed by
(seed, epoch, step), never from torch's global generator.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..augment.spec import mixup
from ..config import TrainConfig
from .schedule import make_epoch_schedule


class StepRandom:
    """The randomness of one train step on `device`: `aug` (augmentation
    draws) and `dropout` (dropout masks), two torch Generators on the
    device, and `mixup`, a numpy Generator for MixUp's λ and partners.
    `key(seed, epoch, step)` reseeds all three, so a step's draws depend on
    nothing but those three numbers. A CPU and a CUDA generator give
    different streams for the same seed."""

    def __init__(self, device):
        self.aug = torch.Generator(device=device)
        self.dropout = torch.Generator(device=device)
        self.mixup = np.random.default_rng(0)

    def key(self, seed: int, epoch: int, step: int) -> "StepRandom":
        a, d = np.random.SeedSequence([seed, epoch, step]).generate_state(2, np.uint64)
        self.aug.manual_seed(int(a))
        self.dropout.manual_seed(int(d))
        self.mixup = np.random.default_rng([seed, epoch, step, 2])
        return self


def one_hot(labels: torch.Tensor, n: int, dtype=torch.float32) -> torch.Tensor:
    """(B,) class indices → (B, n) one-hot rows, by comparison (no scatter,
    no device sync)."""
    return (labels[:, None] == torch.arange(n, device=labels.device)).to(dtype)


def weighted_cross_entropy(
    logits: torch.Tensor,
    labels: torch.Tensor,
    class_weights: Optional[torch.Tensor] = None,
    mask: Optional[torch.Tensor] = None,
    soft_labels: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """torch CrossEntropyLoss(weight=w) semantics:
    sum_i w[y_i] * nll_i / sum_i w[y_i] (reference: src/train.py:441).

    `mask` (B,) zeroes padded rows; `soft_labels` (B, C) replaces the hard
    labels (nll_i = -Σ_c y_ic log p_ic, weight Σ_c y_ic w_c). Hard labels
    go through the same formula as one-hot rows, which gives the hard
    formula's values exactly and needs no scatter in the backward pass."""
    log_probs = torch.log_softmax(logits, dim=-1)
    if soft_labels is None:
        soft_labels = one_hot(labels, logits.shape[-1], log_probs.dtype)
    nll = -(soft_labels * log_probs).sum(dim=-1)
    if class_weights is None:
        w = torch.ones_like(nll)
    else:
        w = (soft_labels * class_weights).sum(dim=-1)
    if mask is not None:
        w = w * mask.to(w.dtype)
    return (w * nll).sum() / w.sum().clamp_min(1e-12)


def compute_class_weights(
    counts: Dict[int, int], max_ratio: float = 20.0
) -> Tuple[float, float]:
    """Inverse-frequency class weights with the reference's 20:1 ratio cap
    (reference: src/train.py:421-439)."""
    total = counts.get(0, 1) + counts.get(1, 1)
    w0 = total / (2 * max(counts.get(0, 1), 1))
    w1 = total / (2 * max(counts.get(1, 1), 1))
    if w1 / w0 > max_ratio:
        w1 = w0 * max_ratio
    return w0, w1


class ClippedAdamW:
    """clip_by_global_norm(max_norm) → AdamW(schedule, weight_decay) with
    optax's arithmetic, weight decay on every parameter (torch AdamW
    semantics without parameter groups, as the reference uses it).

    `step(grads)` updates the parameters in place from one gradient per
    parameter; the update count `count` stays on the host, so reading the
    schedule costs no device sync. Adam's b1, b2 and eps are optax's
    defaults, which the JAX package uses."""

    B1, B2, EPS = 0.9, 0.999, 1e-8

    def __init__(
        self,
        params: Iterable[torch.Tensor],
        schedule: Callable[[int], float],
        max_norm: float = 1.0,
        weight_decay: float = 0.01,
    ):
        self.params: List[torch.Tensor] = list(params)
        self.schedule = schedule
        self.max_norm = float(max_norm)
        self.weight_decay = float(weight_decay)
        self.count = 0
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]

    @torch.no_grad()
    def clip(self, grads: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """optax.clip_by_global_norm: the grads unchanged if their global
        norm is below max_norm, else each / norm * max_norm."""
        norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(list(grads))))
        keep = norm < self.max_norm
        one = torch.ones_like(norm)
        out = torch._foreach_div(list(grads), torch.where(keep, one, norm))
        torch._foreach_mul_(out, torch.where(keep, one, one * self.max_norm))
        return out

    @torch.no_grad()
    def step(self, grads: Sequence[torch.Tensor]) -> None:
        g = self.clip(grads)
        lr = self.schedule(self.count)
        self.count += 1
        b1, b2 = self.B1, self.B2
        torch._foreach_mul_(self.mu, b1)
        torch._foreach_add_(self.mu, g, alpha=1 - b1)
        torch._foreach_mul_(self.nu, b2)
        torch._foreach_addcmul_(self.nu, g, g, value=1 - b2)
        mu_hat = torch._foreach_div(self.mu, 1 - b1**self.count)
        denom = torch._foreach_sqrt(torch._foreach_div(self.nu, 1 - b2**self.count))
        torch._foreach_add_(denom, self.EPS)
        update = torch._foreach_div(mu_hat, denom)
        torch._foreach_add_(update, self.params, alpha=self.weight_decay)
        torch._foreach_mul_(update, -lr)
        torch._foreach_add_(self.params, update)

    def state_dict(self) -> dict:
        return {
            "count": self.count,
            "mu": [t.detach().cpu().clone() for t in self.mu],
            "nu": [t.detach().cpu().clone() for t in self.nu],
        }

    @torch.no_grad()
    def load_state_dict(self, state: dict) -> None:
        if len(state["mu"]) != len(self.params) or len(state["nu"]) != len(self.params):
            raise ValueError(
                f"optimizer state holds {len(state['mu'])} moments for "
                f"{len(self.params)} parameters"
            )
        self.count = int(state["count"])
        for dst, src in zip(self.mu + self.nu, list(state["mu"]) + list(state["nu"])):
            dst.copy_(src)


def make_optimizer(
    params: Iterable[torch.Tensor], cfg: TrainConfig, steps_per_epoch: int
) -> ClippedAdamW:
    """clip_by_global_norm(cfg.grad_clip_norm) → AdamW with the cosine warm
    restarts epoch schedule (reference: src/train.py:93,444-456)."""
    schedule = make_epoch_schedule(
        cfg.learning_rate, steps_per_epoch,
        t_0=cfg.sched_t0, t_mult=cfg.sched_t_mult, eta_min=cfg.sched_eta_min,
    )
    return ClippedAdamW(params, schedule, cfg.grad_clip_norm, cfg.weight_decay)


def loss_and_grads(
    model: torch.nn.Module,
    feats: torch.Tensor,
    labels: torch.Tensor,
    class_weights: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    soft_labels: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
) -> Tuple[torch.Tensor, torch.Tensor, Tuple[torch.Tensor, ...]]:
    """(loss, logits, one gradient per `model.parameters()`) of the
    class-weighted CE in train mode; updates the BatchNorm running stats."""
    model.train()
    logits = model(feats, mask=mask, generator=generator)
    loss = weighted_cross_entropy(logits, labels, class_weights, mask, soft_labels)
    grads = torch.autograd.grad(loss, list(model.parameters()))
    return loss.detach(), logits.detach(), grads


def _counts(hit: torch.Tensor, mask: Optional[torch.Tensor]) -> Tuple[torch.Tensor, torch.Tensor]:
    if mask is None:
        return hit.sum(), torch.full((), hit.shape[0], device=hit.device)
    m = mask > 0
    return (hit & m).sum(), m.sum()


def train_step(
    model: torch.nn.Module,
    optimizer: ClippedAdamW,
    waves_or_feats: torch.Tensor,
    labels: torch.Tensor,
    class_weights: torch.Tensor,
    rand: StepRandom,
    feature_fn: Optional[Callable] = None,
    mask: Optional[torch.Tensor] = None,
    mixup_alpha: Optional[float] = None,
) -> Dict[str, torch.Tensor]:
    """One optimization step; returns its metrics as device tensors (no
    sync). `feature_fn(waves, generator)` featurizes raw waveforms on the
    device with `rand.aug`; without it the input is the feature batch.

    `mask` keeps padded rows out of the loss, the metrics and the BatchNorm
    statistics. `mixup_alpha` mixes the feature images and one-hot labels
    with partners drawn from `rand.mixup` and switches the loss to soft
    labels; accuracy stays against the hard labels."""
    feats = (
        feature_fn(waves_or_feats, rand.aug) if feature_fn is not None else waves_or_feats
    )
    soft = None
    if mixup_alpha is not None:
        onehot = one_hot(labels, class_weights.shape[0], feats.dtype)
        feats, soft = mixup(feats, onehot, rand.mixup, mixup_alpha, mask=mask)
    loss, logits, grads = loss_and_grads(
        model, feats, labels, class_weights, mask, soft, rand.dropout
    )
    optimizer.step(grads)
    correct, count = _counts(logits.argmax(dim=-1) == labels, mask)
    return {"loss": loss, "correct": correct, "count": count}


@torch.no_grad()
def eval_step(
    model: torch.nn.Module,
    waves_or_feats: torch.Tensor,
    labels: torch.Tensor,
    class_weights: torch.Tensor,
    feature_fn: Optional[Callable] = None,
    mask: Optional[torch.Tensor] = None,
) -> Dict[str, torch.Tensor]:
    """Loss and confusion counts for the cough class, on the device
    (reference: src/train.py:114-180); `mask` leaves padded rows out."""
    feats = feature_fn(waves_or_feats) if feature_fn is not None else waves_or_feats
    model.eval()
    logits = model(feats)
    loss = weighted_cross_entropy(logits, labels, class_weights, mask)
    preds = logits.argmax(dim=-1)
    real = torch.ones_like(labels, dtype=torch.bool) if mask is None else mask > 0
    correct, count = _counts(preds == labels, mask)
    return {
        "loss": loss,
        "correct": correct,
        "count": count,
        "tp": ((preds == 1) & (labels == 1) & real).sum(),
        "fp": ((preds == 1) & (labels == 0) & real).sum(),
        "fn": ((preds == 0) & (labels == 1) & real).sum(),
        "tn": ((preds == 0) & (labels == 0) & real).sum(),
    }
