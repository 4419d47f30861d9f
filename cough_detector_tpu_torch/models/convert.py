"""Carry Flax weights across: JAX variables → the port's state dict.

`from_jax_variables` takes the JAX package's `{"params", "batch_stats"}`
tree (numpy arrays, or anything `np.asarray` reads) and returns a state dict
in the reference `.pt` key layout, which the port's modules load with
`load_state_dict`. A reference `.pt` `model_state_dict` is already in that
layout and needs no conversion.

Weight layout translation (the inverse of the JAX package's convert.py):
  conv   (kH, kW, I, O) → (O, I, kH, kW)
  dense  (I, O)         → (O, I)
  scale/bias params + mean/var batch_stats → BatchNorm2d weight/bias/
  running_mean/running_var (num_batches_tracked 0).
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

# Reference torch-module prefix → Flax module path, per architecture
# (reference: src/model.py:92-103,161-196,227-247).
_RESIDUAL_CONVS = {
    "conv1.0": "stem_conv",
    "res_blocks.0.conv1": "res0/conv1",
    "res_blocks.0.conv2": "res0/conv2",
    "res_blocks.0.skip.0": "res0/skip_conv",
    "res_blocks.1.conv1": "res1/conv1",
    "res_blocks.1.conv2": "res1/conv2",
    "res_blocks.1.skip.0": "res1/skip_conv",
}
_RESIDUAL_BNS = {
    "conv1.1": "stem_bn",
    "res_blocks.0.bn1": "res0/bn1",
    "res_blocks.0.bn2": "res0/bn2",
    "res_blocks.0.skip.1": "res0/skip_bn",
    "res_blocks.1.bn1": "res1/bn1",
    "res_blocks.1.bn2": "res1/bn2",
    "res_blocks.1.skip.1": "res1/skip_bn",
}
_RESIDUAL_LINEARS = {"fc.2": "fc"}

_STANDARD_CONVS = {f"conv_layers.{i}.conv": f"block{i}/conv" for i in range(4)}
_STANDARD_BNS = {f"conv_layers.{i}.bn": f"block{i}/bn" for i in range(4)}
_STANDARD_LINEARS = {"fc.0": "fc1", "fc.3": "fc2"}

_SMALL_CONVS = {
    "features.0": "stem_conv",
    "features.4": "sep1/dw",
    "features.5": "sep1/pw",
    "features.9": "sep2/dw",
    "features.10": "sep2/pw",
    "features.14": "sep3/dw",
    "features.15": "sep3/pw",
}
_SMALL_BNS = {
    "features.1": "stem_bn",
    "features.6": "sep1/bn",
    "features.11": "sep2/bn",
    "features.16": "sep3/bn",
}
_SMALL_LINEARS = {"classifier.1": "fc1", "classifier.4": "fc2"}

_TABLES = {
    "residual": (_RESIDUAL_CONVS, _RESIDUAL_BNS, _RESIDUAL_LINEARS),
    "standard": (_STANDARD_CONVS, _STANDARD_BNS, _STANDARD_LINEARS),
    "small": (_SMALL_CONVS, _SMALL_BNS, _SMALL_LINEARS),
}


def _get(tree: Mapping[str, Any], path: str, leaf: str) -> torch.Tensor:
    """The leaf as a float32 tensor that owns its memory. Raises KeyError
    naming the missing weight."""
    node = tree
    try:
        for part in path.split("/"):
            node = node[part]
        value = node[leaf]
    except KeyError as err:
        raise KeyError(f"missing weight {path}/{leaf}") from err
    return torch.from_numpy(np.array(value, dtype=np.float32, copy=True))


def from_jax_variables(
    variables: Mapping[str, Any], model_type: str
) -> Dict[str, torch.Tensor]:
    """Map a Flax {"params", "batch_stats"} tree onto the reference
    state-dict layout of `model_type`."""
    if model_type not in _TABLES:
        raise ValueError(f"Unknown model type: {model_type}")
    convs, bns, linears = _TABLES[model_type]
    params, stats = variables["params"], variables["batch_stats"]

    out: Dict[str, torch.Tensor] = {}
    for tkey, fpath in convs.items():
        out[f"{tkey}.weight"] = _get(params, fpath, "kernel").permute(3, 2, 0, 1).contiguous()
        out[f"{tkey}.bias"] = _get(params, fpath, "bias")
    for tkey, fpath in bns.items():
        out[f"{tkey}.weight"] = _get(params, fpath, "scale")
        out[f"{tkey}.bias"] = _get(params, fpath, "bias")
        out[f"{tkey}.running_mean"] = _get(stats, fpath, "mean")
        out[f"{tkey}.running_var"] = _get(stats, fpath, "var")
        out[f"{tkey}.num_batches_tracked"] = torch.tensor(0, dtype=torch.long)
    for tkey, fpath in linears.items():
        out[f"{tkey}.weight"] = _get(params, fpath, "kernel").T.contiguous()
        out[f"{tkey}.bias"] = _get(params, fpath, "bias")
    return out
