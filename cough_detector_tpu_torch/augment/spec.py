"""Spectrogram-domain augmentation: SpecAugment and MixUp, batched.

The port of `cough_detector_tpu/augment/spec.py`, split like the waveform
ops into draws and a pure apply. SpecAugment follows torchaudio's
mask_along_axis (reference: src/augmentation.py:271-331): width
~ U[0, param), start ~ U[0, dim - width), both truncated to integers, the
band set to 0; one gate a clip covers all its masks. MixUp's λ and partner
come from a numpy Generator (torch's Beta sampler takes no generator).

Inside `parallel.batch_slice` the draws are the global batch's, cut to the
rows in hand; MixUp's partners may be any row of the global batch, so under
data-parallel training it gathers the feature rows of every rank first.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from .. import parallel


class MaskDraws(NamedTuple):
    apply: torch.Tensor   # (B,) bool gate
    f_start: torch.Tensor  # (n_freq_masks, B) int64
    f_width: torch.Tensor
    t_start: torch.Tensor  # (n_time_masks, B) int64
    t_width: torch.Tensor


def _bands(gen: torch.Generator, n: int, b: int, param: int, dim: int) -> tuple:
    starts, widths = [], []
    for _ in range(n):
        width = torch.rand(b, generator=gen, device=gen.device) * param
        start = torch.rand(b, generator=gen, device=gen.device) * (dim - width)
        starts.append(start.to(torch.int64))
        widths.append(width.to(torch.int64))
    empty = torch.zeros((0, b), dtype=torch.int64, device=gen.device)
    return (torch.stack(starts) if n else empty), (torch.stack(widths) if n else empty)


def spec_augment_draws(
    gen: torch.Generator,
    shape: Tuple[int, int, int],
    freq_mask_param: int = 8,
    time_mask_param: int = 15,
    n_freq_masks: int = 2,
    n_time_masks: int = 2,
    p: float = 0.3,
) -> MaskDraws:
    b, n_f, n_t = shape
    apply = torch.rand(b, generator=gen, device=gen.device) <= p
    f_start, f_width = _bands(gen, n_freq_masks, b, freq_mask_param, n_f)
    t_start, t_width = _bands(gen, n_time_masks, b, time_mask_param, n_t)
    return MaskDraws(apply, f_start, f_width, t_start, t_width)


def _covered(dim: int, start: torch.Tensor, width: torch.Tensor) -> torch.Tensor:
    """(B, dim) bool: positions inside any of the (n, B) bands."""
    pos = torch.arange(dim, device=start.device)[None, None, :]
    inside = (pos >= start[..., None]) & (pos < (start + width)[..., None])
    return inside.any(dim=0)


def spec_augment_apply(feats: torch.Tensor, d: MaskDraws) -> torch.Tensor:
    """Zero the drawn frequency and time bands of each gated clip of a
    (B, F, T) batch."""
    _, n_f, n_t = feats.shape
    masked = _covered(n_f, d.f_start, d.f_width)[:, :, None] | _covered(
        n_t, d.t_start, d.t_width
    )[:, None, :]
    return torch.where(masked & d.apply[:, None, None], 0.0, feats)


def spec_augment(
    feats: torch.Tensor,
    gen: torch.Generator,
    freq_mask_param: int = 8,
    time_mask_param: int = 15,
    n_freq_masks: int = 2,
    n_time_masks: int = 2,
    p: float = 0.3,
) -> torch.Tensor:
    """(B, F, T) SpecAugment with the reference's training parameters
    (reference: src/train.py:324-330). p <= 0 returns the batch unchanged
    and draws nothing."""
    if p <= 0:
        return feats
    sl = parallel.rows_of(feats.shape[0])
    d = spec_augment_draws(
        gen, (sl.total,) + tuple(feats.shape[1:]), freq_mask_param, time_mask_param,
        n_freq_masks, n_time_masks, p,
    )
    d = MaskDraws(sl.take(d.apply), *(sl.take(t, 1) for t in d[1:]))
    return spec_augment_apply(feats, d)


def mixup_draws(rng: np.random.Generator, b: int, alpha: float = 0.2) -> tuple:
    """(λ (B,) float32 ~ Beta(α, α), partner permutation (B,) int64)."""
    lam = rng.beta(alpha, alpha, size=b).astype(np.float32)
    return lam, rng.permutation(b).astype(np.int64)


def mixup_apply(
    x: torch.Tensor,
    y_onehot: torch.Tensor,
    lam: torch.Tensor,
    perm: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Convex combination of each row with its partner `perm`; where the
    partner is a padded row (mask 0), λ is 1, so real rows never mix with
    padding."""
    if mask is not None:
        lam = torch.where(mask[perm] > 0, lam, 1.0)
    lam_x = lam.reshape((-1,) + (1,) * (x.ndim - 1))
    lam_y = lam.reshape((-1,) + (1,) * (y_onehot.ndim - 1))
    return (
        lam_x * x + (1 - lam_x) * x[perm],
        lam_y * y_onehot + (1 - lam_y) * y_onehot[perm],
    )


def mixup(
    x: torch.Tensor,
    y_onehot: torch.Tensor,
    rng: np.random.Generator,
    alpha: float = 0.2,
    mask: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batch MixUp (reference: src/augmentation.py:334-369, opt-in via
    TrainConfig.use_mixup). On a rank's rows of a data-parallel batch the
    rows, labels and mask of every rank are gathered first (no gradient
    flows to features), the global batch is mixed, and the rank keeps its
    rows."""
    lam, perm = mixup_draws(rng, parallel.rows_of(x.shape[0]).total, alpha)
    return mixup_drawn(x, y_onehot, torch.from_numpy(lam).to(x.device), torch.from_numpy(perm).to(x.device), mask)


def mixup_drawn(
    x: torch.Tensor,
    y_onehot: torch.Tensor,
    lam: torch.Tensor,
    perm: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """`mixup` with the global batch's draws (`mixup_draws`) already on the
    device (a captured train step stages them in)."""
    sl = parallel.rows_of(x.shape[0])
    if sl.total == x.shape[0]:
        return mixup_apply(x, y_onehot, lam, perm, mask)
    if sl.group is None:
        raise ValueError("MixUp of a batch slice needs the process group that holds the other rows")
    x_all = parallel.all_gather_rows(x.detach(), sl.group)
    y_all = parallel.all_gather_rows(y_onehot, sl.group)
    m_all = None if mask is None else parallel.all_gather_rows(mask, sl.group)
    mixed_x, mixed_y = mixup_apply(x_all, y_all, lam, perm, m_all)
    return sl.take(mixed_x), sl.take(mixed_y)
