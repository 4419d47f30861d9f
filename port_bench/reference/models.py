"""The two classifiers as plain functional torch, from a state dict.

Written from the published architectures (reference repository
src/model.py:143-207 for the small model, :210-293 for the residual one),
with the reference's state-dict keys. Inference only: batch norm uses its
running statistics, dropout is the identity. Every op runs in the dtype of
the input; the caller chooses float64 for the reference and float32 (with
or without TF32) for a control. Imports torch alone.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

_EPS = 1e-5

# (op, key, args): conv (stride, padding, groups), bn, relu, pool (2x2),
# res (stride), gap, linear.
ARCHITECTURES: Dict[str, List[tuple]] = {
    "residual": [
        ("conv", "conv1.0", (1, 32, 7, 2, 3, 1)),
        ("bn", "conv1.1", (32,)),
        ("relu", None, ()),
        ("pool", None, ()),
        ("res", "res_blocks.0", (32, 64, 2)),
        ("res", "res_blocks.1", (64, 128, 2)),
        ("gap", None, ()),
        ("linear", "fc.2", (128, 2)),
    ],
    "small": [
        ("conv", "features.0", (1, 16, 3, 1, 1, 1)),
        ("bn", "features.1", (16,)),
        ("relu", None, ()),
        ("pool", None, ()),
        ("conv", "features.4", (16, 16, 3, 1, 1, 16)),
        ("conv", "features.5", (16, 32, 1, 1, 0, 1)),
        ("bn", "features.6", (32,)),
        ("relu", None, ()),
        ("pool", None, ()),
        ("conv", "features.9", (32, 32, 3, 1, 1, 32)),
        ("conv", "features.10", (32, 64, 1, 1, 0, 1)),
        ("bn", "features.11", (64,)),
        ("relu", None, ()),
        ("pool", None, ()),
        ("conv", "features.14", (64, 64, 3, 1, 1, 64)),
        ("conv", "features.15", (64, 128, 1, 1, 0, 1)),
        ("bn", "features.16", (128,)),
        ("relu", None, ()),
        ("gap", None, ()),
        ("linear", "classifier.1", (128, 64)),
        ("relu", None, ()),
        ("linear", "classifier.4", (64, 2)),
    ],
}


def _res_layers(key: str, cin: int, cout: int, stride: int) -> List[tuple]:
    """A residual block's convs and norms: conv3x3(stride) + BN + ReLU,
    conv3x3 + BN, and a 1x1(stride) + BN projection skip."""
    return [
        ("conv", f"{key}.conv1", (cin, cout, 3, stride, 1, 1)),
        ("bn", f"{key}.bn1", (cout,)),
        ("conv", f"{key}.conv2", (cout, cout, 3, 1, 1, 1)),
        ("bn", f"{key}.bn2", (cout,)),
        ("conv", f"{key}.skip.0", (cin, cout, 1, stride, 0, 1)),
        ("bn", f"{key}.skip.1", (cout,)),
    ]


def leaves(model_type: str) -> List[tuple]:
    """Every conv, bn and linear layer of the architecture, in order."""
    out = []
    for op, key, args in ARCHITECTURES[model_type]:
        if op == "res":
            out.extend(_res_layers(key, *args))
        elif op in ("conv", "bn", "linear"):
            out.append((op, key, args))
    return out


def param_shapes(model_type: str) -> "OrderedDict[str, Tuple[str, tuple, int]]":
    """name -> (kind, shape, fan_in) for every state-dict entry. kind is
    weight, bias, bn_weight, bn_bias, running_mean, running_var or count."""
    shapes: "OrderedDict[str, Tuple[str, tuple, int]]" = OrderedDict()
    for op, key, args in leaves(model_type):
        if op == "conv":
            cin, cout, k, _, _, groups = args
            fan_in = cin // groups * k * k
            shapes[f"{key}.weight"] = ("weight", (cout, cin // groups, k, k), fan_in)
            shapes[f"{key}.bias"] = ("bias", (cout,), fan_in)
        elif op == "linear":
            fin, fout = args
            shapes[f"{key}.weight"] = ("weight", (fout, fin), fin)
            shapes[f"{key}.bias"] = ("bias", (fout,), fin)
        else:
            (c,) = args
            for name, kind in (("weight", "bn_weight"), ("bias", "bn_bias"),
                               ("running_mean", "running_mean"), ("running_var", "running_var")):
                shapes[f"{key}.{name}"] = (kind, (c,), 0)
            shapes[f"{key}.num_batches_tracked"] = ("count", (), 0)
    return shapes


def _conv(x, sd, key, args):
    _, _, _, stride, pad, groups = args
    return F.conv2d(x, sd[f"{key}.weight"], sd[f"{key}.bias"], stride=stride, padding=pad, groups=groups)


def _bn(x, sd, key):
    scale = sd[f"{key}.weight"] / torch.sqrt(sd[f"{key}.running_var"] + _EPS)
    shift = sd[f"{key}.bias"] - sd[f"{key}.running_mean"] * scale
    return x * scale[None, :, None, None] + shift[None, :, None, None]


def _res(x, sd, key, cin, cout, stride):
    c1, b1, c2, b2, s0, s1 = _res_layers(key, cin, cout, stride)
    out = torch.relu(_bn(_conv(x, sd, c1[1], c1[2]), sd, b1[1]))
    out = _bn(_conv(out, sd, c2[1], c2[2]), sd, b2[1])
    skip = _bn(_conv(x, sd, s0[1], s0[2]), sd, s1[1])
    return torch.relu(out + skip)


def logits(features: torch.Tensor, state: Dict[str, torch.Tensor], model_type: str,
           head: bool = True) -> torch.Tensor:
    """(B, H, W) feature images -> (B, 2) logits, in the features' dtype
    (the state dict is cast to it); with head=False, the input of the last
    dense layer."""
    sd = {k: v.to(device=features.device, dtype=features.dtype) for k, v in state.items()
          if not k.endswith("num_batches_tracked")}
    x = features[:, None]
    layers = ARCHITECTURES[model_type]
    for op, key, args in layers if head else layers[:-1]:
        if op == "conv":
            x = _conv(x, sd, key, args)
        elif op == "bn":
            x = _bn(x, sd, key)
        elif op == "relu":
            x = torch.relu(x)
        elif op == "pool":
            x = F.max_pool2d(x, 2)
        elif op == "res":
            x = _res(x, sd, key, *args)
        elif op == "gap":
            x = x.mean(dim=(2, 3))
        elif op == "linear":
            x = F.linear(x, sd[f"{key}.weight"], sd[f"{key}.bias"])
    return x
