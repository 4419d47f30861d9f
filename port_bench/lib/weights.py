"""Classifier weights made on the device from the seed, in one draw."""

from __future__ import annotations

import hashlib
import math
from typing import Dict

import torch

from ..reference.models import ARCHITECTURES, param_shapes


def subseed(seed: int, tag: str) -> int:
    """A 63-bit seed for one use of the run's seed."""
    return int.from_bytes(hashlib.sha256(f"{seed}:{tag}".encode()).digest()[:8], "little") >> 1


def make(model_type: str, seed: int, device) -> Dict[str, torch.Tensor]:
    """The state dict (reference key layout, float32, on `device`): conv
    and dense weights and biases U(+-1/sqrt(fan_in)) as torch's default
    initialisation draws them; batch norm's scale U(0.75, 1.25), shift, running mean
    U(+-0.1) and running variance U(0.5, 1.5), so inference normalisation
    does work. One uniform draw from a generator on the device."""
    shapes = param_shapes(model_type)
    sizes = [torch.Size(s).numel() for _, s, _ in shapes.values()]
    gen = torch.Generator(device=device).manual_seed(subseed(seed, "weights"))
    flat = torch.rand(sum(sizes), generator=gen, device=device) * 2.0 - 1.0
    out, at = {}, 0
    for (name, (kind, shape, fan_in)), n in zip(shapes.items(), sizes):
        u = flat[at:at + n].reshape(shape)
        at += n
        if kind in ("weight", "bias"):
            v = u * fan_in ** -0.5
        elif kind == "bn_weight":
            v = 1.0 + 0.25 * u
        elif kind == "running_var":
            v = 1.0 + 0.5 * u
        elif kind == "count":
            v = torch.zeros((), dtype=torch.int64, device=device)
        else:
            v = 0.1 * u
        out[name] = v.contiguous()
    return out


def calibrate_head(state: Dict[str, torch.Tensor], model_type: str, embedded: torch.Tensor,
                   spread: float, share: float, threshold: float) -> None:
    """Rescale and shift the last dense layer in place so that, over the
    windows whose last-layer inputs are `embedded`, the logit gap (class 1
    minus class 0) has a standard deviation of `spread` and a `share` of
    the windows reach `threshold` in class 1's probability: the traffic's
    rate of windows over the detection threshold. Class 0's row is kept."""
    _, key, _ = ARCHITECTURES[model_type][-1]
    w, b = state[f"{key}.weight"], state[f"{key}.bias"]
    z = embedded.to(w.dtype) @ (w[1] - w[0])
    scale = spread / float(z.std().clamp_min(1e-12))
    cut = float(torch.quantile(z.double(), 1.0 - share))
    w[1] = w[0] + scale * (w[1] - w[0])
    b[1] = b[0] + math.log(threshold / (1.0 - threshold)) - scale * cut
