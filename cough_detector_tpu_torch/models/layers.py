"""Shared building blocks for the classifier family, as torch modules.

The port of `cough_detector_tpu/models/layers.py`. Layout is NCHW, the
reference's own (reference: src/model.py:105-125), and each block's
attribute names are the reference's state-dict keys, so a reference `.pt`
`model_state_dict` loads with `load_state_dict` unchanged.

Only eval-mode semantics are ported with this slice. The masked train-time
batch statistics of the JAX BatchNorm (padded batch rows excluded) come
with the training slice.
"""

from __future__ import annotations

import torch
from torch import nn


# torch's own BatchNorm2d is the semantics the JAX BatchNorm reproduces
# (momentum 0.1, eps 1e-5; eval normalizes with the running stats).
BatchNorm = nn.BatchNorm2d


class ConvBlock(nn.Module):
    """Conv3x3 → BN → ReLU → MaxPool(2) → channel Dropout(0.1).

    Reference: src/model.py:11-40. Keys: conv.*, bn.*.
    """

    def __init__(self, in_ch: int, features: int, dropout: float = 0.1):
        super().__init__()
        self.conv = nn.Conv2d(in_ch, features, 3, padding=1)
        self.bn = BatchNorm(features)
        self.pool = nn.MaxPool2d(2)
        self.dropout = nn.Dropout2d(dropout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.dropout(self.pool(torch.relu(self.bn(self.conv(x)))))


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
            self.skip = nn.Identity()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = torch.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        return torch.relu(out + self.skip(x))


def global_avg_pool(x: torch.Tensor) -> torch.Tensor:
    """AdaptiveAvgPool2d((1,1)) + flatten: (B, C, H, W) → (B, C)."""
    return x.mean(dim=(2, 3))
