"""Classifier family as torch modules, and weight conversion from Flax."""

from .classifiers import (
    CoughDetector,
    CoughDetectorResidual,
    CoughDetectorSmall,
    count_parameters,
    create_model,
    init_model,
    init_weights,
    model_from_config,
    no_tf32,
    place_model,
    predict,
)
from .convert import from_jax_variables
from .fuse import fold_batchnorm

__all__ = [
    "CoughDetector",
    "CoughDetectorResidual",
    "CoughDetectorSmall",
    "count_parameters",
    "create_model",
    "fold_batchnorm",
    "from_jax_variables",
    "init_model",
    "init_weights",
    "no_tf32",
    "model_from_config",
    "place_model",
    "predict",
]
