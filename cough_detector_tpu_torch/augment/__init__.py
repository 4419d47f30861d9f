"""On-device batched augmentation (reference: src/augmentation.py)."""

from .spec import mixup, spec_augment
from .waveform import (
    add_file_noise,
    add_gaussian_noise,
    augment_waveforms,
    pitch_shift_semitones,
    speed_perturbation,
    time_shift,
    volume_perturbation,
)

__all__ = [
    "mixup",
    "spec_augment",
    "add_file_noise",
    "add_gaussian_noise",
    "augment_waveforms",
    "pitch_shift_semitones",
    "speed_perturbation",
    "time_shift",
    "volume_perturbation",
]
