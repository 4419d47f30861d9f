"""Shared building blocks for the classifier family, as torch modules.

The port of `cough_detector_tpu/models/layers.py`. Layout is NCHW, the
reference's own (reference: src/model.py:105-125), and each block's
attribute names are the reference's state-dict keys, so a reference `.pt`
`model_state_dict` loads with `load_state_dict` unchanged.

Train mode takes two extra arguments the blocks hand down: `mask`, (B,)
with 1 for a real batch row and 0 for a padded one, which `BatchNorm`
keeps out of its statistics; and `generator`, the step's
`torch.Generator`, from which the dropout layers draw their masks.
"""

from __future__ import annotations

from typing import Iterable, Optional

import torch
from torch import nn


class BatchNorm(nn.BatchNorm2d):
    """BatchNorm2d (momentum 0.1, eps 1e-5, biased normalization, unbiased
    running-var update) whose train-time statistics leave out padded rows.

    With `mask`, the batch mean and variance are those of the real rows
    alone (two passes, E[(x - mean)^2], as the JAX BatchNorm computes
    them), so a padded step's loss, gradients and running stats are the
    unpadded batch's; a fully padded batch leaves the running stats and
    `num_batches_tracked` untouched. Without a mask, train mode is torch's
    own batch norm (cuDNN on the card)."""

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        if not self.training or mask is None:
            return super().forward(x)
        mb = mask.to(x.dtype).reshape(-1, 1, 1, 1)
        n = mb.sum() * (x.shape[2] * x.shape[3])
        n_safe = n.clamp_min(1.0)
        mean = (x * mb).sum(dim=(0, 2, 3)) / n_safe
        centred = x - mean[None, :, None, None]
        var = (centred * centred * mb).sum(dim=(0, 2, 3)) / n_safe
        with torch.no_grad():
            live = n > 0
            m = self.momentum
            unbiased = var * (n / (n - 1.0).clamp_min(1.0))
            self.running_mean.copy_(
                torch.where(live, (1 - m) * self.running_mean + m * mean, self.running_mean)
            )
            self.running_var.copy_(
                torch.where(live, (1 - m) * self.running_var + m * unbiased, self.running_var)
            )
            self.num_batches_tracked.add_(live.to(self.num_batches_tracked.dtype))
        inv = torch.rsqrt(var + self.eps) * self.weight
        return centred * inv[None, :, None, None] + self.bias[None, :, None, None]


def _keep_scaled(x: torch.Tensor, p: float, shape, generator: torch.Generator) -> torch.Tensor:
    keep = torch.rand(shape, generator=generator, device=x.device) >= p
    return torch.where(keep, x / (1.0 - p), 0.0)


class Dropout(nn.Dropout):
    """nn.Dropout that draws its mask from `generator` when given one (the
    trainer always does); without one it is torch's own."""

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        if not self.training or self.p == 0 or generator is None:
            return super().forward(x)
        return _keep_scaled(x, self.p, x.shape, generator)


class Dropout2d(nn.Dropout2d):
    """Whole-channel dropout (one draw per (row, channel)), from `generator`
    when given one."""

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        if not self.training or self.p == 0 or generator is None:
            return super().forward(x)
        return _keep_scaled(x, self.p, x.shape[:2] + (1, 1), generator)


def run(
    layers: Iterable[nn.Module],
    x: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """Apply `layers` in order, handing `mask` to each BatchNorm and
    `generator` to each dropout layer."""
    for layer in layers:
        if isinstance(layer, BatchNorm):
            x = layer(x, mask)
        elif isinstance(layer, (Dropout, Dropout2d)):
            x = layer(x, generator)
        else:
            x = layer(x)
    return x


class ConvBlock(nn.Module):
    """Conv3x3 → BN → ReLU → MaxPool(2) → channel Dropout(0.1).

    Reference: src/model.py:11-40. Keys: conv.*, bn.*.
    """

    def __init__(self, in_ch: int, features: int, dropout: float = 0.1):
        super().__init__()
        self.conv = nn.Conv2d(in_ch, features, 3, padding=1)
        self.bn = BatchNorm(features)
        self.pool = nn.MaxPool2d(2)
        self.dropout = Dropout2d(dropout)

    def forward(self, x, mask=None, generator=None) -> torch.Tensor:
        x = self.pool(torch.relu(self.bn(self.conv(x), mask)))
        return self.dropout(x, generator)


class SeparableBlock(nn.Sequential):
    """Depthwise 3x3 + pointwise 1x1 → BN → ReLU → optional MaxPool
    (reference: src/model.py:168-187).

    A Sequential so the small model can splice its layers into one flat
    `features` Sequential, whose indices are the reference's keys."""

    def __init__(self, in_ch: int, features: int, pool: bool = True):
        layers = [
            nn.Conv2d(in_ch, in_ch, 3, padding=1, groups=in_ch),
            nn.Conv2d(in_ch, features, 1),
            BatchNorm(features),
            nn.ReLU(),
        ]
        if pool:
            layers.append(nn.MaxPool2d(2))
        super().__init__(*layers)


class ResidualBlock(nn.Module):
    """conv3x3(s) + BN + ReLU → conv3x3 + BN; 1x1(s) + BN projection skip
    when the shape changes; add; ReLU.

    Reference: src/model.py:268-293. Keys: conv1, bn1, conv2, bn2, skip.{0,1}.
    """

    def __init__(self, in_ch: int, features: int, stride: int = 2):
        super().__init__()
        self.conv1 = nn.Conv2d(in_ch, features, 3, stride=stride, padding=1)
        self.bn1 = BatchNorm(features)
        self.conv2 = nn.Conv2d(features, features, 3, padding=1)
        self.bn2 = BatchNorm(features)
        if in_ch != features or stride != 1:
            self.skip = nn.Sequential(
                nn.Conv2d(in_ch, features, 1, stride=stride), BatchNorm(features)
            )
        else:
            self.skip = nn.Sequential()  # identity

    def forward(self, x, mask=None, generator=None) -> torch.Tensor:
        out = torch.relu(self.bn1(self.conv1(x), mask))
        out = self.bn2(self.conv2(out), mask)
        return torch.relu(out + run(self.skip, x, mask))


def global_avg_pool(x: torch.Tensor) -> torch.Tensor:
    """AdaptiveAvgPool2d((1,1)) + flatten: (B, C, H, W) → (B, C)."""
    return x.mean(dim=(2, 3))


class GlobalAvgPool(nn.Module):
    """AdaptiveAvgPool2d((1, 1)) as a mean: (B, C, H, W) → (B, C, 1, 1).
    The adaptive pool's CUDA backward has no deterministic form, which the
    trainer needs; the mean's has."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x.mean(dim=(2, 3), keepdim=True)
