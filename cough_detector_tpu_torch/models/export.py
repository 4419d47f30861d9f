"""Serving program export: the whole serving function as one traced program.

The port of `cough_detector_tpu/models/export.py`. The JAX package lowers
and compiles its serving function ahead of time and persists the
executable; here `torch.export` traces it into an `ExportedProgram` for one
batch geometry and one device. The front end's kernel launches are
custom ops (`cdt::power_mel`, `cdt::mel_epilogue` and, for a config with
spectral contrast, `cdt::spectral_contrast`; ops/frontend_kernel.py), so
the program holds them as opaque nodes and,
when called, runs the same wrappers: the kernels on a card, their plain
versions on the CPU, with the launch counters counting.
"""

from __future__ import annotations

from typing import Mapping, Union

import torch
from torch import nn

from ..config import Config
from ..ops import frontend
from ..utils.device import resolve_device
from .classifiers import model_from_config, place_model


class ServingProgram(nn.Module):
    """(B, segment_samples) waveforms → (B, 2) probabilities: peak
    normalize → `extract_features_fast` → classifier → softmax."""

    def __init__(self, model: nn.Module, config: Config, device: torch.device):
        super().__init__()
        self.model = model
        self.features = config.features
        self.device = device

    def forward(self, waves: torch.Tensor) -> torch.Tensor:
        waves = frontend.peak_normalize(waves)
        feats = frontend.extract_features_fast(waves, self.features, device=self.device)
        return torch.softmax(self.model(feats), dim=-1)


def make_serving_fn(
    variables: Mapping, config: Config, device: Union[str, torch.device] = "cuda",
    precision_mode: str = "high",
) -> ServingProgram:
    """The serving function of a state dict (reference key layout) and its
    config, on `device` (the card unless told otherwise), in eval mode."""
    dev = resolve_device(device)
    model = model_from_config(config.model, precision_mode)
    model.load_state_dict({k: torch.as_tensor(v) for k, v in variables.items()})
    return ServingProgram(place_model(model, dev), config, dev).eval()


def aot_compile(
    fn: ServingProgram, batch_size: int, segment_samples: int = 16000
) -> torch.export.ExportedProgram:
    """Trace the serving function for a fixed (batch_size, segment_samples)
    float32 input on its device."""
    example = torch.zeros((batch_size, segment_samples), dtype=torch.float32, device=fn.device)
    return torch.export.export(fn, (example,))


def export_serialized(program: torch.export.ExportedProgram, path: str) -> str:
    """Write the traced program to `path` (a `.pt2` archive: the graph and
    its weights); returns the path. Load it with `load_serialized`."""
    torch.export.save(program, path)
    return path


def load_serialized(path: str) -> nn.Module:
    """An `export_serialized` archive as a callable module, on the device it
    was traced on. The custom ops it calls are registered on import of
    ops/frontend_kernel.py, which this module imports.

    TRUST REQUIREMENT: load only archives from a trusted producer, the
    trust a model checkpoint needs: the archive decides which operators
    run, with which constants, and it may carry pickled parts. Do not point
    this at downloaded or user-supplied files."""
    from ..ops import frontend_kernel  # noqa: F401  (registers cdt::*)

    return torch.export.load(path).module()


def graph_text(program: torch.export.ExportedProgram) -> str:
    """A traced program's graph as text: the reviewable artifact beside the
    `.pt2` (the JAX package writes StableHLO text here)."""
    return str(program.graph_module.code)

