"""Checkpoints: one directory per named checkpoint, and the reference `.pt`.

The port of `cough_detector_tpu/train/checkpoint.py`, on `torch.save`. It
keeps the reference's contract: the checkpoint carries the feature config,
and serving rebuilds the exact front end from it (reference:
src/train.py:183-199, src/inference.py:89-152). Layout:

  <dir>/<name>/state.pt   {"model": state dict in the reference key layout,
                           "optimizer": ClippedAdamW.state_dict(), "step"}
  <dir>/<name>/meta.json  {"epoch", "metrics", "config" (flat),
                           "config_full", "extra"}

Each file is written whole to a temporary name and renamed into place,
meta.json after state.pt, so a meta.json never describes a tree that is
not there. `import_torch_checkpoint` / `export_torch_checkpoint` read and
write the reference's single-file `.pt`
({epoch, model_state_dict, optimizer_state_dict, metrics, config}).
"""

from __future__ import annotations

import json
import os
from pathlib import Path
from typing import Any, Dict, Mapping, Optional, Tuple

import torch

from ..config import Config

STATE = "state.pt"
META = "meta.json"


def _replace_into(path: Path, write) -> None:
    tmp = path.with_name(path.name + ".tmp")
    write(tmp)
    os.replace(tmp, path)


def save_checkpoint(
    directory: str,
    name: str,
    model: torch.nn.Module,
    optimizer: Any,
    epoch: int,
    metrics: Mapping[str, float],
    config: Config,
    extra: Optional[Dict[str, Any]] = None,
) -> str:
    """Write `<directory>/<name>/` (e.g. "best_model", "latest_model") from
    the model's state dict and the optimizer's state, both copied to the
    host."""
    base = Path(directory) / name
    base.mkdir(parents=True, exist_ok=True)
    tree = {
        "model": {k: v.detach().to("cpu", copy=True) for k, v in model.state_dict().items()},
        "optimizer": optimizer.state_dict(),
        "step": int(optimizer.count),
    }
    meta = {
        "epoch": int(epoch),
        "metrics": {k: float(v) for k, v in metrics.items()},
        # Flat: the reference .pt's keys. Full: everything the flat form
        # cannot express, so serving rebuilds the whole setup from it.
        "config": config.to_flat_dict(),
        "config_full": json.loads(config.to_json()),
    }
    if extra:
        meta["extra"] = extra  # loop state an exact resume needs (early stopping)
    _replace_into(base / STATE, lambda p: torch.save(tree, p))
    _replace_into(base / META, lambda p: p.write_text(json.dumps(meta, indent=2)))
    return str(base)


def read_meta(path: str) -> dict:
    return json.loads((Path(path) / META).read_text())


def load_checkpoint(path: str) -> Tuple[Dict[str, Any], int, Dict[str, float], Config]:
    """(tree, epoch, metrics, config) from a checkpoint directory; the
    tree's tensors are on the CPU."""
    meta = read_meta(path)
    tree = torch.load(Path(path) / STATE, map_location="cpu", weights_only=True)
    if "config_full" in meta:
        config = Config.from_json(json.dumps(meta["config_full"]))
    else:  # only the reference-compatible flat form
        config = Config.from_flat_dict(meta["config"])
    return tree, meta["epoch"], meta["metrics"], config


def import_torch_checkpoint(path: str) -> Tuple[Dict[str, torch.Tensor], Config, int, Dict]:
    """A reference checkpoint → (model state dict, config, epoch, metrics)."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    config = Config.from_flat_dict(ckpt.get("config", {}))
    return ckpt["model_state_dict"], config, ckpt.get("epoch", 0), ckpt.get("metrics", {})


def export_torch_checkpoint(
    path: str,
    state_dict: Mapping[str, torch.Tensor],
    config: Config,
    epoch: int = 0,
    metrics: Optional[Mapping[str, float]] = None,
) -> None:
    """Write a model state dict in the reference's `.pt` layout, which the
    reference's tooling, the JAX package's `import_torch_checkpoint` and
    `StreamingDetector(model_path=...)` read."""
    torch.save(
        {
            "epoch": int(epoch),
            "model_state_dict": {k: v.detach().to("cpu", copy=True) for k, v in state_dict.items()},
            "optimizer_state_dict": {},
            "metrics": {k: float(v) for k, v in (metrics or {}).items()},
            "config": config.to_flat_dict(),
        },
        path,
    )
