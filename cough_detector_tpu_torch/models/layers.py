"""Shared building blocks for the classifier family, as torch modules.

The port of `cough_detector_tpu/models/layers.py`. Layout is NCHW, the
reference's own (reference: src/model.py:105-125), and each block's
attribute names are the reference's state-dict keys, so a reference `.pt`
`model_state_dict` loads with `load_state_dict` unchanged.

Train mode takes two extra arguments the blocks hand down: `mask`, (B,)
with 1 for a real batch row and 0 for a padded one, which `BatchNorm`
keeps out of its statistics; and `generator`, the step's
`torch.Generator`, from which the dropout layers draw their masks.

Every conv and dense layer is a `Conv2d` / `Linear` with a `compute` mode,
which `set_precision` sets from the serving precision mode and the compute
dtype (the JAX package's `mxu_precision`, models/layers.py:25-51):
  "fp32"  float32 throughout (the default; the card runs TF32 off);
  "tf32"  a conv on the card with cuDNN's TF32 tensor-core path on for
          that call alone, the flag put back after it (on a CPU, fp32);
  "bf16"  operands cast to bfloat16 and a bfloat16 result; the parameters
          stay float32 and BatchNorm normalizes in float32.
"""

from __future__ import annotations

import contextlib
from typing import Iterable, Iterator, Optional

import torch
import torch.nn.functional as F
from torch import nn

from .. import parallel

PRECISION_MODES = ("high", "serve")
COMPUTE_DTYPES = ("float32", "bfloat16")


@contextlib.contextmanager
def cudnn_tf32() -> Iterator[None]:
    """cuDNN's TF32 convolutions on for the block, the flag restored after."""
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = prev


class Conv2d(nn.Conv2d):
    """nn.Conv2d with a compute mode ("fp32", "tf32" or "bf16"; module
    docstring). `sensitive` marks a site that stays fp32 in the "serve"
    mode: the residual blocks' skip projections."""

    compute = "fp32"
    sensitive = False

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.compute == "bf16":
            bf = torch.bfloat16
            return self._conv_forward(x.to(bf), self.weight.to(bf), self.bias.to(bf))
        if self.compute == "tf32" and x.is_cuda:
            with cudnn_tf32():
                return super().forward(x)
        return super().forward(x)


class Linear(nn.Linear):
    """nn.Linear with a compute mode: "bf16" casts as Conv2d does; every
    other mode is float32 (dense layers are fp32 in the "serve" mode)."""

    compute = "fp32"

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.compute == "bf16":
            bf = torch.bfloat16
            return F.linear(x.to(bf), self.weight.to(bf), self.bias.to(bf))
        return super().forward(x)


def set_precision(
    model: nn.Module, precision_mode: str = "high", compute_dtype: str = "float32"
) -> nn.Module:
    """Set every Conv2d's and Linear's compute mode: "bf16" throughout for
    compute_dtype "bfloat16"; for precision_mode "serve", "tf32" on the
    bulk convs and "fp32" on the sensitive sites (the dense layers and the
    skip projections, as the JAX package keeps them at full precision);
    "fp32" for "high"."""
    if precision_mode not in PRECISION_MODES:
        raise ValueError(f"unknown precision_mode {precision_mode!r}; expected one of {PRECISION_MODES}")
    if compute_dtype not in COMPUTE_DTYPES:
        raise ValueError(f"compute_dtype must be one of {COMPUTE_DTYPES}, got {compute_dtype!r}")
    for m in model.modules():
        if isinstance(m, (Conv2d, Linear)):
            if compute_dtype == "bfloat16":
                m.compute = "bf16"
            elif precision_mode == "serve" and isinstance(m, Conv2d) and not m.sensitive:
                m.compute = "tf32"
            else:
                m.compute = "fp32"
    return model


class BatchNorm(nn.BatchNorm2d):
    """BatchNorm2d (momentum 0.1, eps 1e-5, biased normalization, unbiased
    running-var update) whose train-time statistics leave out padded rows.

    With `mask`, the batch mean and variance are those of the real rows
    alone (two passes, E[(x - mean)^2], as the JAX BatchNorm computes
    them), so a padded step's loss, gradients and running stats are the
    unpadded batch's; a fully padded batch leaves the running stats and
    `num_batches_tracked` untouched. Without a mask, train mode is torch's
    own batch norm (cuDNN on the card).

    Under data-parallel training over more than one rank
    (`parallel.reducing_group`), the statistics are the global batch's, as
    the JAX BatchNorm's are under a sharded batch: the masked count and sum
    are summed across the ranks for the mean, then the squared deviations
    for the variance. The sums are differentiable all-reduces, so the
    backward pass sums dy and dy·x̂ across the ranks, and the running stats
    move by the global values on every rank."""

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        if x.dtype != torch.float32:  # bf16 compute: normalize in float32
            return self.forward(x.float(), mask).to(x.dtype)
        group = parallel.reducing_group() if self.training else None
        if not self.training or (mask is None and group is None):
            return super().forward(x)
        if mask is None:
            mask = torch.ones(x.shape[0], dtype=x.dtype, device=x.device)
        mb = mask.to(x.dtype).reshape(-1, 1, 1, 1)
        n = mb.sum() * (x.shape[2] * x.shape[3])
        total = (x * mb).sum(dim=(0, 2, 3))
        if group is not None:
            n_total = parallel.all_reduce_sum(torch.cat([n[None], total]), group)
            n, total = n_total[0].detach(), n_total[1:]
        n_safe = n.clamp_min(1.0)
        mean = total / n_safe
        centred = x - mean[None, :, None, None]
        squares = (centred * centred * mb).sum(dim=(0, 2, 3))
        if group is not None:
            squares = parallel.all_reduce_sum(squares, group)
        var = squares / n_safe
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
    """Inverted dropout of `x` with a mask of `shape` (batch axis first).
    The mask is drawn for the global batch and cut to the rows in hand
    (parallel.rows_of), so a rank's rows drop what the one-process run
    drops."""
    sl = parallel.rows_of(shape[0])
    keep = sl.take(torch.rand((sl.total,) + tuple(shape[1:]), generator=generator, device=x.device) >= p)
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
        self.conv = Conv2d(in_ch, features, 3, padding=1)
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
            Conv2d(in_ch, in_ch, 3, padding=1, groups=in_ch),
            Conv2d(in_ch, features, 1),
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
        self.conv1 = Conv2d(in_ch, features, 3, stride=stride, padding=1)
        self.bn1 = BatchNorm(features)
        self.conv2 = Conv2d(features, features, 3, padding=1)
        self.bn2 = BatchNorm(features)
        if in_ch != features or stride != 1:
            self.skip = nn.Sequential(
                Conv2d(in_ch, features, 1, stride=stride), BatchNorm(features)
            )
            self.skip[0].sensitive = True
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
