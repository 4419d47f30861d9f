"""Inference-time conv + BatchNorm folding, on the reference state dict.

The port of `cough_detector_tpu/models/fuse.py`. For eval-mode serving each
conv → BN pair collapses into the conv with rescaled weights:
W' = W·k, b' = (b − μ)·k + β, k = γ/√(σ² + ε), in float32 numpy, and the BN
becomes an identity (weight 1, bias 0, mean 0, var 1 − ε, so that
1/√(var + ε) is 1). The folded state dict loads into the same architecture;
its logits equal the unfolded model's up to float32 rounding.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

_EPS = 1e-5

# conv → BatchNorm key prefixes per architecture, in the reference layout
# (the pairs of the JAX package's fuse.py, named as models/convert.py maps
# them; the small model's depthwise convs feed no BN).
_PAIRS = {
    "residual": [("conv1.0", "conv1.1")] + [
        (f"res_blocks.{i}.{conv}", f"res_blocks.{i}.{bn}")
        for i in range(2)
        for conv, bn in (("conv1", "bn1"), ("conv2", "bn2"), ("skip.0", "skip.1"))
    ],
    "standard": [(f"conv_layers.{i}.conv", f"conv_layers.{i}.bn") for i in range(4)],
    "small": [
        ("features.0", "features.1"),
        ("features.5", "features.6"),
        ("features.10", "features.11"),
        ("features.15", "features.16"),
    ],
}


def _numpy(value: Any) -> np.ndarray:
    if isinstance(value, torch.Tensor):
        value = value.detach().cpu().numpy()
    return np.array(value, copy=True)


def fold_batchnorm(state_dict: Mapping[str, Any], model_type: str) -> Dict[str, torch.Tensor]:
    """A new state dict with each BN folded into the conv before it and
    turned into an identity; `state_dict` (tensors or numpy arrays) is left
    as it was."""
    if model_type not in _PAIRS:
        raise ValueError(f"Unknown model type: {model_type}")
    out = {k: _numpy(v) for k, v in state_dict.items()}
    for conv, bn in _PAIRS[model_type]:
        k = out[f"{bn}.weight"] / np.sqrt(out[f"{bn}.running_var"] + _EPS)
        out[f"{conv}.weight"] = (out[f"{conv}.weight"] * k[:, None, None, None]).astype(np.float32)
        out[f"{conv}.bias"] = (
            (out[f"{conv}.bias"] - out[f"{bn}.running_mean"]) * k + out[f"{bn}.bias"]
        ).astype(np.float32)
        out[f"{bn}.weight"] = np.ones_like(out[f"{bn}.weight"])
        out[f"{bn}.bias"] = np.zeros_like(out[f"{bn}.bias"])
        out[f"{bn}.running_mean"] = np.zeros_like(out[f"{bn}.running_mean"])
        out[f"{bn}.running_var"] = np.full_like(out[f"{bn}.running_var"], 1.0 - _EPS)
    return {k: torch.from_numpy(v) for k, v in out.items()}
