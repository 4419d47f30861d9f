"""Train and eval steps, in torch.

The port of `cough_detector_tpu/train/steps.py`: forward, class-weighted
CE, backward, clip_by_global_norm(1.0) and AdamW (reference:
src/train.py:54-111,441-448). The optimizer reproduces optax's
`chain(clip_by_global_norm, adamw)` arithmetic rather than
`torch.optim.AdamW`'s: the clip scales by max_norm / norm only when the
norm reaches max_norm (torch's clip_grad_norm_ divides by norm + 1e-6),
the decay is added to the Adam direction before the learning rate scales
it, and the rate is the schedule's at the update count before the update.

The JAX package's scanned programs become plain per-step iteration:
`train_steps` / `eval_steps` run a run of steps (an epoch, or one chunked
window of it) over batches that `window_batches` gathers from a corpus on
the device, or that the loop streams from a loader.

Every random draw of a step comes from `StepRandom`, keyed by
(seed, epoch, step), never from torch's global generator.

Under data-parallel training the step runs inside `parallel.batch_slice`
with the process group: each rank holds its rows of the global batch, the
loss is normalized by the global batch's weight sum, and the gradients,
the loss and the counts are summed across the ranks before the clip, so
the clip norm, the update and the metrics are the global batch's on every
rank (the JAX package's DP step under a sharded batch).
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import parallel
from ..augment.spec import mixup, mixup_draws as draw_mixup, mixup_drawn
from ..config import TrainConfig
from ..utils import graphs
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
        self.mixup = self.mixup_rng(seed, epoch, step)
        return self

    @staticmethod
    def mixup_rng(seed: int, epoch: int, step: int) -> np.random.Generator:
        """The MixUp generator `key(seed, epoch, step)` sets, on its own."""
        return np.random.default_rng([seed, epoch, step, 2])


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
    formula's values exactly and needs no scatter in the backward pass.

    Inside a `parallel.batch_slice` with a process group the rows are one
    rank's: the weight sum is the global batch's, so the value is this
    rank's share, and the shares of the ranks sum to the global loss."""
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
    total = w.sum()
    sl = parallel.active_slice()
    if sl is not None and sl.group is not None:
        total = parallel.all_reduce_sum(total.detach(), sl.group)
    return (w * nll).sum() / total.clamp_min(1e-12)


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
    parameter. It is `advance()`, which counts the update on the host and
    gives its scalars (minus the learning rate and Adam's two bias
    corrections, computed in float64 and stored as float32), then
    `update(grads, scalars)` with the scalars as a device tensor: a
    captured step stages them in before each replay, so no host value is
    baked into the graph. Reading the schedule costs no device sync. Adam's
    b1, b2 and eps are optax's defaults, which the JAX package uses."""

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

    def advance(self) -> np.ndarray:
        """Count one update; its scalars [-lr, 1 - b1^t, 1 - b2^t] as
        float32, with lr the schedule's at the count before the update."""
        lr = self.schedule(self.count)
        self.count += 1
        t = self.count
        return np.array([-lr, 1 - self.B1**t, 1 - self.B2**t], np.float64).astype(np.float32)

    @torch.no_grad()
    def update(self, grads: Sequence[torch.Tensor], scalars: torch.Tensor) -> None:
        """The update from `grads` with `advance()`'s scalars, a (3,)
        float32 tensor on the parameters' device."""
        g = self.clip(grads)
        b1, b2 = self.B1, self.B2
        torch._foreach_mul_(self.mu, b1)
        torch._foreach_add_(self.mu, g, alpha=1 - b1)
        torch._foreach_mul_(self.nu, b2)
        torch._foreach_addcmul_(self.nu, g, g, value=1 - b2)
        mu_hat = torch._foreach_div(self.mu, scalars[1])
        denom = torch._foreach_sqrt(torch._foreach_div(self.nu, scalars[2]))
        torch._foreach_add_(denom, self.EPS)
        update = torch._foreach_div(mu_hat, denom)
        torch._foreach_add_(update, self.params, alpha=self.weight_decay)
        torch._foreach_mul_(update, scalars[0])
        torch._foreach_add_(self.params, update)

    def step(self, grads: Sequence[torch.Tensor]) -> None:
        self.update(grads, torch.from_numpy(self.advance()).to(self.params[0].device))

    def state_dict(self, on_device: bool = False) -> dict:
        """The count and copies of the moments, in host memory, or with
        `on_device` on the parameters' device (copies in stream order, which
        later updates leave as they are)."""
        copy = (lambda t: t.detach().clone()) if on_device else (lambda t: t.detach().cpu().clone())
        return {"count": self.count, "mu": [copy(t) for t in self.mu], "nu": [copy(t) for t in self.nu]}

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
    class-weighted CE in train mode; updates the BatchNorm running stats.
    Inside a `parallel.batch_slice` with a process group the loss and the
    gradients are this rank's shares (`train_step` sums them)."""
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


def _sum_over_ranks(
    group, metrics: Dict[str, torch.Tensor], grads: Sequence[torch.Tensor] = ()
) -> Tuple[Dict[str, torch.Tensor], List[torch.Tensor]]:
    """The metrics and gradients summed over the group's ranks, in one
    all-reduce of one flat float32 buffer (counts up to 2^24 are exact in
    it). With one rank the all-reduce is a copy, and every value comes back
    bit for bit."""
    keys = list(metrics)
    flat = torch.cat(
        [g.reshape(-1) for g in grads]
        + [torch.stack([metrics[k].to(torch.float32) for k in keys])]
    )
    torch.distributed.all_reduce(flat, group=group)
    out, at = [], 0
    for g in grads:
        out.append(flat[at : at + g.numel()].view_as(g))
        at += g.numel()
    summed = {
        k: flat[at + i].to(metrics[k].dtype) for i, k in enumerate(keys)
    }
    return summed, out


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
    mixup_draws: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    opt_scalars: Optional[torch.Tensor] = None,
) -> Dict[str, torch.Tensor]:
    """One optimization step; returns its metrics as device tensors (no
    sync). `feature_fn(waves, generator)` featurizes raw waveforms on the
    device with `rand.aug`; without it the input is the feature batch.

    `mask` keeps padded rows out of the loss, the metrics and the BatchNorm
    statistics. `mixup_alpha` mixes the feature images and one-hot labels
    with partners drawn from `rand.mixup` and switches the loss to soft
    labels; accuracy stays against the hard labels.

    A captured step (StepPrograms) passes what the host draws and counts as
    device tensors: `mixup_draws` (λ, partners) from `rand.mixup`, and
    `opt_scalars` from `optimizer.advance()`, which it then does not call."""
    feats = (
        feature_fn(waves_or_feats, rand.aug) if feature_fn is not None else waves_or_feats
    )
    soft = None
    if mixup_alpha is not None:
        onehot = one_hot(labels, class_weights.shape[0], feats.dtype)
        if mixup_draws is None:
            feats, soft = mixup(feats, onehot, rand.mixup, mixup_alpha, mask=mask)
        else:
            feats, soft = mixup_drawn(feats, onehot, *mixup_draws, mask=mask)
    loss, logits, grads = loss_and_grads(
        model, feats, labels, class_weights, mask, soft, rand.dropout
    )
    correct, count = _counts(logits.argmax(dim=-1) == labels, mask)
    metrics = {"loss": loss, "correct": correct, "count": count}
    sl = parallel.active_slice()
    if sl is not None and sl.group is not None:
        metrics, grads = _sum_over_ranks(sl.group, metrics, grads)
    if opt_scalars is None:
        optimizer.step(grads)
    else:
        optimizer.update(grads, opt_scalars)
    return metrics


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
    (reference: src/train.py:114-180); `mask` leaves padded rows out.
    Inside a `parallel.batch_slice` with a process group they are the
    global batch's, summed over the ranks."""
    feats = feature_fn(waves_or_feats) if feature_fn is not None else waves_or_feats
    model.eval()
    return eval_metrics(model(feats), labels, class_weights, mask)


@torch.no_grad()
def eval_metrics(
    logits: torch.Tensor,
    labels: torch.Tensor,
    class_weights: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
) -> Dict[str, torch.Tensor]:
    """`eval_step`'s metrics from the logits (a batch scored in blocks on
    several devices is scored here once, on the concatenated logits)."""
    loss = weighted_cross_entropy(logits, labels, class_weights, mask)
    preds = logits.argmax(dim=-1)
    real = torch.ones_like(labels, dtype=torch.bool) if mask is None else mask > 0
    correct, count = _counts(preds == labels, mask)
    metrics = {
        "loss": loss,
        "correct": correct,
        "count": count,
        "tp": ((preds == 1) & (labels == 1) & real).sum(),
        "fp": ((preds == 1) & (labels == 0) & real).sum(),
        "fn": ((preds == 0) & (labels == 1) & real).sum(),
        "tn": ((preds == 0) & (labels == 0) & real).sum(),
    }
    sl = parallel.active_slice()
    if sl is not None and sl.group is not None:
        metrics, _ = _sum_over_ranks(sl.group, metrics)
    return metrics


# -- runs of steps -----------------------------------------------------------------

Batch = Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]


def window_batches(
    corpus: torch.Tensor,
    mats: Tuple[np.ndarray, np.ndarray, np.ndarray],
    lo: int = 0,
    hi: Optional[int] = None,
    gather: Optional[Callable[[torch.Tensor, torch.Tensor], torch.Tensor]] = None,
) -> Iterator[Batch]:
    """The batches of a run of steps over a corpus on the device: the whole
    corpus with global indices, or one chunked window's buffer with the
    window's own (JAX: train_window_scan). `mats`: the (steps, B) index,
    label and mask matrices (ShardLoader.epoch_batches); each batch is
    columns [lo, hi) of a row (a rank's rows), gathered by `gather(corpus,
    idx)` (`index_select` by default; parallel.routed_gather for a corpus
    sharded over the ranks). A row with no padding carries mask None (the
    unmasked BatchNorm) on every rank."""
    idx, labels, mask = mats
    full = mask.all(axis=1)
    hi = idx.shape[1] if hi is None else hi
    dev = corpus.device
    idx_d = torch.from_numpy(idx[:, lo:hi].astype(np.int64)).to(dev)
    labels_d = torch.from_numpy(labels[:, lo:hi].astype(np.int64)).to(dev)
    mask_d = torch.from_numpy(np.ascontiguousarray(mask[:, lo:hi])).to(dev)
    for s in range(idx.shape[0]):
        rows = corpus.index_select(0, idx_d[s]) if gather is None else gather(corpus, idx_d[s])
        yield rows, labels_d[s], None if full[s] else mask_d[s]


def train_steps(
    model: torch.nn.Module,
    optimizer: ClippedAdamW,
    batches: Iterable[Batch],
    class_weights: torch.Tensor,
    rand: StepRandom,
    seed: int,
    epoch: int,
    step0: int = 0,
    feature_fn: Optional[Callable] = None,
    mixup_alpha: Optional[float] = None,
    rows: Optional[parallel.BatchSlice] = None,
) -> List[Dict[str, torch.Tensor]]:
    """`train_step` over `batches`, step step0 + s keyed by (seed, epoch,
    step0 + s): a window that starts at step0 draws what the same steps of
    the whole epoch draw. `rows`: this rank's slice of each global batch
    under data-parallel training. Returns the per-step metrics, on the
    device."""
    out = []
    with parallel.batch_slice(rows):
        for s, (waves, labels, mask) in enumerate(batches):
            out.append(train_step(
                model, optimizer, waves, labels, class_weights,
                rand.key(seed, epoch, step0 + s), feature_fn=feature_fn,
                mask=mask, mixup_alpha=mixup_alpha,
            ))
    return out


def eval_steps(
    model: torch.nn.Module,
    batches: Iterable[Batch],
    class_weights: torch.Tensor,
    feature_fn: Optional[Callable] = None,
    rows: Optional[parallel.BatchSlice] = None,
) -> List[Dict[str, torch.Tensor]]:
    """`eval_step` over `batches`; per-step metrics on the device."""
    with parallel.batch_slice(rows):
        return [
            eval_step(model, w, lab, class_weights, feature_fn, m) for w, lab, m in batches
        ]


# -- the steps as captured programs ---------------------------------------------------

TRAIN_KEYS = ("loss", "correct", "count")
EVAL_KEYS = ("loss", "correct", "count", "tp", "fp", "fn", "tn")


def metric_row(metrics: Dict[str, torch.Tensor], keys: Sequence[str]) -> torch.Tensor:
    """A step's metrics as one float64 row in `keys`' order."""
    return torch.stack([metrics[k].to(torch.float64) for k in keys])


class StepPrograms:
    """`train_step` and `eval_step` as captured programs (utils.graphs):
    the port's counterpart of the JAX package's jitted and scanned steps.

    One graph a (train or eval, masked or not, rows in hand, input) key,
    where the input is a corpus on the device (its rows gathered inside the
    program by `gather(corpus, idx)`, `index_select` by default) or a batch
    of waves handed in. Before each replay the host reseeds `rand`'s
    generators (registered with every graph) for (seed, epoch, step),
    counts the optimizer's update, and stages the batch's indices and
    labels, its mask, the optimizer's scalars and MixUp's draws into the
    static inputs. A run of steps over a corpus (`train_run`, `eval_run`)
    builds every step's inputs up front and uploads them in one copy
    (graphs.upload), so the host enqueues the whole run without waiting on
    the card. The program is the eager step itself, so a replay equals it
    bit for bit. On the CPU the same object calls the steps on the static
    buffers.

    `rows`: this rank's slice of each global batch (data parallelism over
    NCCL, whose collectives are captured with the step; gloo's cannot be,
    and the trainer runs the eager steps then). `probe(waves, labels)`, when
    given, sees each step's gathered batch after its replay (the trainer's
    row-hash probe)."""

    def __init__(
        self,
        model: torch.nn.Module,
        optimizer: ClippedAdamW,
        class_weights: torch.Tensor,
        rand: StepRandom,
        train_features: Optional[Callable] = None,
        eval_features: Optional[Callable] = None,
        *,
        mixup_alpha: Optional[float] = None,
        rows: Optional[parallel.BatchSlice] = None,
        gather: Optional[Callable[[torch.Tensor, torch.Tensor], torch.Tensor]] = None,
        probe: Optional[Callable[[torch.Tensor, torch.Tensor], None]] = None,
    ):
        dev = class_weights.device
        self.model, self.optimizer, self.class_weights, self.rand = model, optimizer, class_weights, rand
        self.train_features, self.eval_features = train_features, eval_features
        self.mixup_alpha, self.rows, self.probe = mixup_alpha, rows, probe
        self.gather = gather or (lambda corpus, idx: corpus.index_select(0, idx))
        gens = (rand.aug, rand.dropout) if dev.type == "cuda" else ()
        self.programs = graphs.Programs(dev, generators=gens, name="step")

    def _inputs(self, corpus, idx, labels, mask, waves) -> Tuple[tuple, dict]:
        b = len(labels)
        batch = np.stack([np.zeros(b, np.int64) if idx is None else np.asarray(idx, np.int64),
                          np.asarray(labels, np.int64)])
        inputs = {"batch": batch}
        if mask is not None:
            inputs["mask"] = mask
        if corpus is None:
            inputs["waves"] = waves
            source = ("waves", str(waves.dtype))
        else:
            source = ("corpus", corpus.data_ptr(), tuple(corpus.shape), str(corpus.dtype))
        return (mask is not None, b) + source, inputs

    def _batch(self, corpus, static):
        waves = static["waves"] if corpus is None else self.gather(corpus, static["batch"][0])
        return waves, static["batch"][1], static.get("mask")

    def train(self, corpus: Optional[torch.Tensor], idx, labels, mask, seed: int, epoch: int, step: int,
              waves=None) -> torch.Tensor:
        """Train step `step` of `epoch` on the rows `idx` of `corpus` (or on
        `waves`, with corpus None); `idx`, `labels`, `mask` (None: a full
        batch) are host arrays of the rows in hand. Returns the step's
        TRAIN_KEYS row on the device."""
        key, inputs = self._train_inputs(corpus, idx, labels, mask, seed, epoch, step, waves)
        return self._train(corpus, key, inputs, seed, epoch, step)

    def train_run(self, corpus: torch.Tensor, mats, seed: int, epoch: int, step0: int = 0) -> torch.Tensor:
        """The train steps of (steps, B) index, label and mask matrices over
        `corpus`, step s keyed by (seed, epoch, step0 + s), their inputs
        uploaded in one copy; the run's (steps, k) TRAIN_KEYS rows."""
        planned = [
            self._train_inputs(corpus, idx, labels, mask, seed, epoch, step0 + s)
            for s, (idx, labels, mask) in enumerate(_rank_rows(mats, self.rows))
        ]
        staged = graphs.upload([inputs for _, inputs in planned], self.programs.device)
        return torch.stack([
            self._train(corpus, key, inputs, seed, epoch, step0 + s)
            for s, ((key, _), inputs) in enumerate(zip(planned, staged))
        ])

    def eval_run(self, corpus: torch.Tensor, mats) -> torch.Tensor:
        """`eval_step` over the matrices' batches as `train_run` takes them;
        the (steps, k) EVAL_KEYS rows."""
        planned = [self._inputs(corpus, idx, labels, mask, None) for idx, labels, mask in _rank_rows(mats, self.rows)]
        staged = graphs.upload([inputs for _, inputs in planned], self.programs.device)
        return torch.stack([self._eval(corpus, key, inputs) for (key, _), inputs in zip(planned, staged)])

    def _train_inputs(self, corpus, idx, labels, mask, seed: int, epoch: int, step: int, waves=None):
        """(key, host inputs) of a train step; counts the optimizer's update."""
        key, inputs = self._inputs(corpus, idx, labels, mask, waves)
        inputs["opt"] = self.optimizer.advance()
        if self.mixup_alpha is not None:
            total = len(labels) if self.rows is None else self.rows.total
            inputs["lam"], inputs["perm"] = draw_mixup(
                StepRandom.mixup_rng(seed, epoch, step), total, self.mixup_alpha
            )
        return ("train",) + key, inputs

    def _train(self, corpus, key, inputs, seed: int, epoch: int, step: int) -> torch.Tensor:
        mixed = self.mixup_alpha is not None
        self.rand.key(seed, epoch, step)

        def program(static):
            waves, labels, mask = self._batch(corpus, static)
            with parallel.batch_slice(self.rows):
                m = train_step(
                    self.model, self.optimizer, waves, labels, self.class_weights, self.rand,
                    self.train_features, mask, self.mixup_alpha,
                    mixup_draws=(static["lam"], static["perm"]) if mixed else None,
                    opt_scalars=static["opt"],
                )
            return metric_row(m, TRAIN_KEYS), waves, labels

        return self._run(key, program, inputs)

    def eval(self, corpus: Optional[torch.Tensor], idx, labels, mask, waves=None) -> torch.Tensor:
        """`eval_step` on a batch given as to `train`; its EVAL_KEYS row."""
        return self._eval(corpus, *self._inputs(corpus, idx, labels, mask, waves))

    def _eval(self, corpus, key, inputs) -> torch.Tensor:
        def program(static):
            waves, labels, mask = self._batch(corpus, static)
            with parallel.batch_slice(self.rows):
                m = eval_step(self.model, waves, labels, self.class_weights, self.eval_features, mask)
            return metric_row(m, EVAL_KEYS), waves, labels

        return self._run(("eval",) + key, program, inputs)

    def _run(self, key, program, inputs) -> torch.Tensor:
        row, waves, labels = self.programs(key, program, inputs, copy=(True, False, False))
        if self.probe is not None:
            self.probe(waves, labels)
        return row


Mats = Tuple[np.ndarray, np.ndarray, np.ndarray]


def _rank_rows(mats: Mats, rows: Optional[parallel.BatchSlice]) -> Iterator[tuple]:
    """(idx, labels, mask or None) of each step of (steps, B) matrices,
    cut to the rank's columns; a step with no padding carries mask None."""
    idx, labels, mask = mats
    lo, hi = (0, idx.shape[1]) if rows is None else (rows.lo, rows.hi)
    full = mask.all(axis=1)
    for s in range(idx.shape[0]):
        yield idx[s, lo:hi], labels[s, lo:hi], None if full[s] else np.ascontiguousarray(mask[s, lo:hi])


def make_window_fns(programs: StepPrograms) -> Tuple[Callable, Callable]:
    """(train_window(corpus, mats, seed, epoch, step0), eval_window(corpus,
    mats)): the captured steps replayed over one run of steps, the (steps,
    B) index, label and mask matrices of a corpus on the device (a whole
    resident corpus, or one chunked window with its own indices; JAX:
    `make_window_fns`). Step s of a train window is keyed by (seed, epoch,
    step0 + s), so windows carry the step offset. Each returns the
    window's (steps, k) metric rows, kept on the device (StepPrograms'
    `train_run` and `eval_run`)."""
    return programs.train_run, programs.eval_run


def make_fused_epoch_fn(programs: StepPrograms) -> Callable:
    """epoch_fn(train_corpus, mats, val_corpus, val_mats, seed, epoch) →
    (train rows, val rows): the train graph replayed over an epoch's
    matrices, then the eval graph over the validation pass, the metrics
    kept on the device for one fetch (JAX: `make_fused_epoch_fn`)."""
    train_window, eval_window = make_window_fns(programs)

    def epoch_fn(train_corpus, mats: Mats, val_corpus, val_mats: Mats, seed: int, epoch: int):
        return train_window(train_corpus, mats, seed, epoch), eval_window(val_corpus, val_mats)

    return epoch_fn
