"""PyTorch/CUDA port of cough_detector_tpu for NVIDIA Hopper.

A second package beside the JAX one, module for module under the same
names. It imports torch and numpy only: never JAX, and nothing of
`cough_detector_tpu`. Its entry points run on the card ("cuda") unless the
caller passes device="cpu".

The package exports the JAX package's names (its `__all__`). Where the JAX
name is a jit factory (`make_feature_fn`, `make_process_fn`) or a Flax idiom
(`init_model`), it is a plain callable or a module builder here. The data,
stream and train subsystems load lazily, on first use of their names.
"""

__version__ = "1.0.0"

from .augment import augment_waveforms, mixup, spec_augment
from .augmentation import AudioAugmentor, MixUp, SpecAugment, create_augmentation_pipeline
from .config import Config, FeatureConfig, ModelConfig, StreamConfig, TrainConfig, default_config
from .models import (
    CoughDetector,
    CoughDetectorResidual,
    CoughDetectorSmall,
    count_parameters,
    create_model,
    init_model,
    predict,
)
from .ops import extract_features, make_feature_fn, make_process_fn, process
from .preprocessing import AudioPreprocessor, RealtimePreprocessor, create_preprocessor

__all__ = [
    "Config",
    "FeatureConfig",
    "ModelConfig",
    "StreamConfig",
    "TrainConfig",
    "default_config",
    "CoughDetector",
    "CoughDetectorResidual",
    "CoughDetectorSmall",
    "count_parameters",
    "create_model",
    "init_model",
    "predict",
    "extract_features",
    "make_feature_fn",
    "make_process_fn",
    "process",
    "augment_waveforms",
    "mixup",
    "spec_augment",
    "AudioPreprocessor",
    "RealtimePreprocessor",
    "create_preprocessor",
    "AudioAugmentor",
    "MixUp",
    "SpecAugment",
    "create_augmentation_pipeline",
    "CoughDataset",
    "ESC50Dataset",
    "download_esc50",
]


def __getattr__(name):
    # The data, stream and train subsystems load on first use, so importing
    # the package stays light for serving-only or data-prep-only uses.
    if name in ("CoughDataset", "ESC50Dataset", "CombinedDataset", "BatchLoader", "create_data_loaders"):
        from .data import datasets

        return getattr(datasets, name)
    if name == "download_esc50":
        from .data.acquire import download_esc50

        return download_esc50
    if name in ("StreamingDetector", "CoughDetectorInference", "RealtimeMicrophoneDetector", "list_audio_devices"):
        from . import stream

        return getattr(stream, name)
    if name == "train":
        from .train import train

        return train
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
