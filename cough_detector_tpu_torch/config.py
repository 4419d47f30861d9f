"""Typed configuration schema, the PyTorch port's own copy.

Field for field the schema of `cough_detector_tpu/config.py`, with the same
flat-dict and nested JSON forms, so a checkpoint's `config_full` reads in
both packages. It is copied rather than imported because importing the JAX
package pulls in JAX and Flax.

The reference carries an ad-hoc config dict inside every checkpoint
(reference: src/train.py:264-287) and reconstructs the preprocessor and model
from it at serving time (reference: src/inference.py:89-152). This module
replaces that with one typed, JSON-serializable schema whose *flat dict* form
is key-compatible with the reference checkpoint config, so reference
checkpoints can be ingested and our checkpoints remain self-describing.

Unlike the reference — whose constructor defaults (all feature flags ON,
reference: src/preprocessing.py:43-49) disagree with its shipped training
config (most flags OFF, reference: src/train.py:275-281) — there is exactly
one set of defaults here: the shipped training config. A checkpoint missing
keys therefore reconstructs the *trained* geometry, not a different one.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Any, Dict


@dataclass(frozen=True)
class FeatureConfig:
    """DSP front-end hyperparameters.

    Field-for-field capability match with the reference preprocessor
    (reference: src/preprocessing.py:32-51), with defaults taken from the
    shipped training config (reference: src/train.py:264-287).
    """

    sample_rate: int = 16000
    n_mels: int = 64
    n_fft: int = 512
    hop_length: int = 160
    win_length: int = 400
    f_min: float = 100.0
    f_max: float = 4000.0
    segment_duration: float = 1.0
    n_mfcc: int = 13
    use_mfcc: bool = True
    use_pcen: bool = False
    use_pre_emphasis: bool = False
    pre_emphasis_coef: float = 0.97
    use_delta_delta: bool = False
    use_spectral_contrast: bool = False
    n_contrast_bands: int = 6

    @property
    def segment_samples(self) -> int:
        return int(self.sample_rate * self.segment_duration)

    @property
    def num_frames(self) -> int:
        """Number of STFT frames for a full segment (center=True): the
        segment reflect-padded by n_fft // 2 a side, cut into frames of
        n_fft samples a hop apart.

        For an even n_fft this is reference get_expected_time_frames
        (reference: src/preprocessing.py:532-534), segment_samples //
        hop_length + 1. An odd n_fft pads one sample less than a frame
        spans, so where the hop divides the segment (1323 at a 441 hop,
        44.1 kHz) there is one frame fewer: torch.stft's count, and the
        frames the JAX package's jnp chain returns, where its config
        counts one more.
        """
        return (self.segment_samples + 2 * (self.n_fft // 2) - self.n_fft) // self.hop_length + 1

    @property
    def num_features(self) -> int:
        """Stacked feature-image height (reference: src/preprocessing.py:536-550)."""
        n = self.n_mels
        if self.use_mfcc:
            n += self.n_mfcc * (3 if self.use_delta_delta else 2)
        if self.use_spectral_contrast:
            n += self.n_contrast_bands + 1
        return n

    @property
    def feature_shape(self) -> tuple:
        """(height, width) of one clip's feature image — (90, 101) shipped."""
        return (self.num_features, self.num_frames)


@dataclass(frozen=True)
class ModelConfig:
    """Classifier architecture selection (reference: src/model.py:296-316)."""

    model_type: str = "residual"  # "standard" | "small" | "residual"
    num_classes: int = 2
    in_channels: int = 1
    # Feature-image height the model was built for; informational only — all
    # three architectures end in global average pooling and are shape-agnostic
    # (reference: src/model.py:95,187,242).
    n_mels: int = 90
    dropout: float = 0.5
    # Compute dtype for the conv stack. float32 for parity; bfloat16 for
    # peak MXU throughput at serving time. Params are always float32.
    compute_dtype: str = "float32"


@dataclass(frozen=True)
class TrainConfig:
    """Training hyperparameters (reference: src/train.py:264-287,441-459)."""

    batch_size: int = 32
    learning_rate: float = 0.0005
    weight_decay: float = 0.01
    epochs: int = 150
    patience: int = 20
    early_stop_min_delta: float = 0.001
    grad_clip_norm: float = 1.0
    # CosineAnnealingWarmRestarts schedule (reference: src/train.py:451-456).
    sched_t0: int = 10
    sched_t_mult: int = 2
    sched_eta_min: float = 1e-6
    # Class-weight ratio cap (reference: src/train.py:433-437).
    max_class_weight_ratio: float = 20.0
    # Augmentation (reference: src/train.py:320-330).
    p_augment: float = 0.3
    freq_mask_param: int = 8
    time_mask_param: int = 15
    n_freq_masks: int = 2
    n_time_masks: int = 2
    # MixUp on the feature images (reference: src/augmentation.py:334-369
    # defines MixUp but never wires it into training; off by default to
    # match). When on, each batch row is convexly mixed with a random
    # partner (λ ~ Beta(α, α)) and the loss uses the mixed soft labels —
    # a measured lever for the strict behavioral band (BASELINE.md r5
    # curation matrix).
    use_mixup: bool = False
    mixup_alpha: float = 0.2
    seed: int = 0


@dataclass(frozen=True)
class StreamConfig:
    """Streaming detector parameters (reference: src/inference.py:49-117)."""

    window_duration: float = 1.0
    hop_duration: float = 0.25
    confidence_threshold: float = 0.5
    smoothing_window: int = 3
    debounce_seconds: float = 0.5
    # Concurrent audio streams scored per chip in one batched step.
    num_streams: int = 1


@dataclass(frozen=True)
class Config:
    """Top-level framework config: the single source of truth that links
    feature geometry to model geometry, carried inside every checkpoint."""

    features: FeatureConfig = field(default_factory=FeatureConfig)
    model: ModelConfig = field(default_factory=ModelConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    stream: StreamConfig = field(default_factory=StreamConfig)

    # ------------------------------------------------------------------
    # Flat-dict form: key-compatible with the reference checkpoint config
    # (reference: src/train.py:264-287) so .pt checkpoints round-trip.
    # ------------------------------------------------------------------

    _FEATURE_KEYS = (
        "sample_rate n_mels n_fft hop_length win_length f_min f_max "
        "segment_duration n_mfcc use_mfcc use_pcen use_pre_emphasis "
        "pre_emphasis_coef use_delta_delta use_spectral_contrast "
        "n_contrast_bands"
    ).split()
    _TRAIN_KEYS = "batch_size learning_rate weight_decay epochs patience".split()

    def to_flat_dict(self) -> Dict[str, Any]:
        d: Dict[str, Any] = {"model_type": self.model.model_type}
        for k in self._FEATURE_KEYS:
            d[k] = getattr(self.features, k)
        for k in self._TRAIN_KEYS:
            d[k] = getattr(self.train, k)
        return d

    @classmethod
    def from_flat_dict(cls, d: Dict[str, Any]) -> "Config":
        feats = FeatureConfig(
            **{k: d[k] for k in cls._FEATURE_KEYS if k in d}
        )
        train = TrainConfig(**{k: d[k] for k in cls._TRAIN_KEYS if k in d})
        model = ModelConfig(
            model_type=d.get("model_type", "residual"),
            n_mels=feats.num_features,
        )
        return cls(features=feats, model=model, train=train)

    # ------------------------------------------------------------------
    # Full (nested) JSON round-trip for our own config.json artifacts.
    # ------------------------------------------------------------------

    def to_json(self, indent: int = 2) -> str:
        return json.dumps(dataclasses.asdict(self), indent=indent)

    @classmethod
    def from_json(cls, text: str) -> "Config":
        raw = json.loads(text)
        return cls(
            features=FeatureConfig(**raw.get("features", {})),
            model=ModelConfig(**raw.get("model", {})),
            train=TrainConfig(**raw.get("train", {})),
            stream=StreamConfig(**raw.get("stream", {})),
        )

    def replace(self, **sections: Any) -> "Config":
        return dataclasses.replace(self, **sections)


def default_config(model_type: str = "residual") -> Config:
    """The shipped production configuration (reference: src/train.py:264-287
    with model_type from train_with_data.py:52)."""
    cfg = Config()
    if model_type != cfg.model.model_type:
        cfg = cfg.replace(
            model=dataclasses.replace(cfg.model, model_type=model_type)
        )
    return cfg
