"""Feature front end: the plain torch chain, the fused CUDA kernel and the
resampler. The import surface of the JAX package's `ops`."""

from . import filters, frontend
from . import resample as resample_mod
from .frontend import (
    compute_deltas,
    extract_features,
    extract_features_fast,
    log_mel_norm,
    make_feature_fn,
    make_process_fn,
    mel_spectrogram,
    mfcc,
    pad_or_trim,
    pcen,
    peak_normalize,
    power_spectrogram,
    power_to_db,
    pre_emphasis,
    process,
    spectral_contrast,
    to_mono,
)
from .resample import make_resample_fn

__all__ = [
    "filters",
    "frontend",
    "compute_deltas",
    "extract_features",
    "extract_features_fast",
    "log_mel_norm",
    "make_feature_fn",
    "make_process_fn",
    "mel_spectrogram",
    "mfcc",
    "pad_or_trim",
    "pcen",
    "peak_normalize",
    "power_spectrogram",
    "power_to_db",
    "pre_emphasis",
    "process",
    "spectral_contrast",
    "to_mono",
    "make_resample_fn",
    "resample_mod",
]
