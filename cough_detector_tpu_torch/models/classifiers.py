"""The three cough-classifier architectures, as torch modules.

The port of `cough_detector_tpu/models/classifiers.py`: "standard" (plain
CNN), "small" (depthwise-separable), "residual" (the shipped model). Module
attributes follow the reference's state-dict keys (reference:
src/model.py:43-316), so `models/convert.py` output and reference `.pt`
checkpoints load directly. Inputs are feature images (B, H, W) or NCHW
(B, 1, H, W).

`forward(x, mask=None, generator=None)`: in train mode `mask` keeps padded
rows out of the BatchNorm statistics and the dropout layers draw from
`generator` (models/layers.py). Logits are float32 in every compute mode
(`layers.set_precision`, which `model_from_config` applies).
"""

from __future__ import annotations

import math
from typing import Tuple, Union

import torch
from torch import nn

from .layers import (
    BatchNorm,
    Conv2d,
    ConvBlock,
    Dropout,
    GlobalAvgPool,
    Linear,
    ResidualBlock,
    SeparableBlock,
    global_avg_pool,
    run,
    set_precision,
)


def _as_nchw(x: torch.Tensor) -> torch.Tensor:
    if x.ndim == 3:
        return x.unsqueeze(1)
    if x.ndim == 4 and x.shape[1] == 1:
        return x
    raise ValueError(f"Expected (B,H,W) or (B,1,H,W) input, got {tuple(x.shape)}")


class CoughDetector(nn.Module):
    """Plain CNN: 4 ConvBlocks → GAP → FC(→128) → ReLU → Dropout → FC(→2).
    Reference: src/model.py:43-140. 421,954 parameters."""

    def __init__(self, num_classes: int = 2, dropout: float = 0.5):
        super().__init__()
        chans = (1, 32, 64, 128, 256)
        self.conv_layers = nn.Sequential(
            *[ConvBlock(chans[i], chans[i + 1]) for i in range(4)]
        )
        self.fc = nn.Sequential(
            Linear(256, 128), nn.ReLU(), Dropout(dropout),
            Linear(128, num_classes),
        )

    def forward(self, x, mask=None, generator=None) -> torch.Tensor:
        x = _as_nchw(x)
        for block in self.conv_layers:
            x = block(x, mask, generator)
        return run(self.fc, global_avg_pool(x), mask, generator).float()


class CoughDetectorSmall(nn.Module):
    """Lightweight depthwise-separable CNN for realtime inference.
    Reference: src/model.py:143-207. 21,122 parameters. Its dropout is
    fixed at 0.3, as the reference's is."""

    def __init__(self, num_classes: int = 2):
        super().__init__()
        self.features = nn.Sequential(
            Conv2d(1, 16, 3, padding=1),
            BatchNorm(16),
            nn.ReLU(),
            nn.MaxPool2d(2),
            *SeparableBlock(16, 32),
            *SeparableBlock(32, 64),
            *SeparableBlock(64, 128, pool=False),
            GlobalAvgPool(),
        )
        self.classifier = nn.Sequential(
            nn.Flatten(), Linear(128, 64), nn.ReLU(), Dropout(0.3),
            Linear(64, num_classes),
        )

    def forward(self, x, mask=None, generator=None) -> torch.Tensor:
        x = run(self.features, _as_nchw(x), mask, generator)
        return run(self.classifier, x, mask, generator).float()


class CoughDetectorResidual(nn.Module):
    """ResNet-style model, the shipped production architecture:
    Conv7x7(s2, p3) → BN → ReLU → MaxPool(2) → ResBlock(→64, s2) →
    ResBlock(→128, s2) → GAP → Dropout → FC(→2).
    Reference: src/model.py:210-265. 290,370 parameters."""

    def __init__(self, num_classes: int = 2, dropout: float = 0.5):
        super().__init__()
        self.conv1 = nn.Sequential(
            Conv2d(1, 32, 7, stride=2, padding=3),
            BatchNorm(32),
            nn.ReLU(),
            nn.MaxPool2d(2),
        )
        self.res_blocks = nn.ModuleList(
            [ResidualBlock(32, 64), ResidualBlock(64, 128)]
        )
        self.fc = nn.Sequential(
            nn.Flatten(), Dropout(dropout), Linear(128, num_classes)
        )

    def forward(self, x, mask=None, generator=None) -> torch.Tensor:
        x = run(self.conv1, _as_nchw(x), mask, generator)
        for block in self.res_blocks:
            x = block(x, mask, generator)
        return run(self.fc, global_avg_pool(x), mask, generator).float()


_MODELS = {
    "standard": CoughDetector,
    "small": CoughDetectorSmall,
    "residual": CoughDetectorResidual,
}


def create_model(model_type: str = "standard", **kwargs) -> nn.Module:
    """Factory over {"standard", "small", "residual"}. The reference's
    n_mels/in_channels kwargs are accepted and ignored: every architecture
    ends in global average pooling."""
    kwargs.pop("n_mels", None)
    kwargs.pop("in_channels", None)
    if model_type not in _MODELS:
        raise ValueError(
            f"Unknown model type: {model_type}. Choose from {list(_MODELS)}"
        )
    return _MODELS[model_type](**kwargs)


def model_from_config(model_config, precision_mode: str = "high") -> nn.Module:
    """The classifier a ModelConfig describes: num_classes, dropout
    (standard/residual; the small model's dropout is fixed) and
    compute_dtype, in `precision_mode` ("high": float32 throughout;
    "serve": TF32 bulk convs on the card, the dense layers and skip
    projections in float32; see layers.set_precision). Parameters are
    float32 in every mode."""
    kwargs = {"num_classes": model_config.num_classes}
    if model_config.model_type in ("standard", "residual"):
        kwargs["dropout"] = model_config.dropout
    model = create_model(model_config.model_type, **kwargs)
    return set_precision(model, precision_mode, model_config.compute_dtype)


def no_tf32(device: Union[str, torch.device]) -> None:
    """On the card, turn TF32 off for cuDNN convolutions and cuBLAS
    matmuls: TF32 keeps about as few mantissa bits as one bf16 pass, which
    the JAX package measured outside the 1e-3 logits budget."""
    if torch.device(device).type == "cuda":
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False


def place_model(model: nn.Module, device: Union[str, torch.device]) -> nn.Module:
    """Move `model` to `device` in eval mode, with TF32 off (`no_tf32`)."""
    no_tf32(device)
    return model.to(device).eval()


@torch.no_grad()
def init_weights(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Re-draw every conv and linear layer's weights as torch's own
    `reset_parameters` does (Kaiming-uniform weights, a = sqrt(5), and
    U(±1/sqrt(fan_in)) biases), from `generator`, in module order; BatchNorm
    stays at weight 1, bias 0, running mean 0 and variance 1. A CPU
    generator gives the same weights whatever device the model then goes to."""
    for m in model.modules():
        if isinstance(m, (nn.Conv2d, nn.Linear)):
            nn.init.kaiming_uniform_(m.weight, a=math.sqrt(5), generator=generator)
            fan_in = m.weight[0].numel()
            bound = 1 / math.sqrt(fan_in)
            nn.init.uniform_(m.bias, -bound, bound, generator=generator)
    return model


def init_model(model: nn.Module, generator=0, feature_shape=None) -> nn.Module:
    """The JAX package's `init_model(model, rng, feature_shape)`: `model`
    with freshly drawn weights (`init_weights`) from `generator`, a
    torch.Generator or an int seed. `feature_shape` is accepted for the
    reference's signature and unused: the classifiers end in global average
    pooling and hold no shape-dependent weight. Returns the module."""
    if not isinstance(generator, torch.Generator):
        generator = torch.Generator().manual_seed(int(generator))
    return init_weights(model, generator)


def count_parameters(model: nn.Module) -> int:
    """Trainable-parameter count (reference: src/model.py:319-321)."""
    return int(sum(p.numel() for p in model.parameters() if p.requires_grad))


@torch.inference_mode()
def predict(model: nn.Module, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(preds, probs): softmax over the logits and the argmax class."""
    probs = torch.softmax(model(x), dim=-1)
    return probs.argmax(dim=-1), probs
