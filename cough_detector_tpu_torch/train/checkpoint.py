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
not there. A save with `block=False` copies the state to host memory at
once and writes the files on one background thread (the JAX package's
writer, train/checkpoint.py), so a one-process trainer's disk writes
overlap its next epoch; `drain_pending_saves` waits for them, and
`load_checkpoint` drains first. `import_torch_checkpoint` / `export_torch_checkpoint` read and
write the reference's single-file `.pt`
({epoch, model_state_dict, optimizer_state_dict, metrics, config}).
"""

from __future__ import annotations

import json
import os
import threading
from concurrent.futures import Future, ThreadPoolExecutor
from pathlib import Path
from typing import Any, Dict, List, Mapping, Optional, Tuple

import torch

from ..config import Config

STATE = "state.pt"
META = "meta.json"


def _replace_into(path: Path, write) -> None:
    tmp = path.with_name(path.name + ".tmp")
    write(tmp)
    os.replace(tmp, path)


# One writer thread commits the non-blocking saves in submission order
# (best_model before latest_model); the trainer drains it once an epoch and
# before it returns, so at most one epoch's saves are in flight.
_writer_lock = threading.Lock()
_writer: Optional[ThreadPoolExecutor] = None
_pending: List[Future] = []


def _submit(fn) -> None:
    global _writer
    with _writer_lock:
        if _writer is None:
            _writer = ThreadPoolExecutor(max_workers=1, thread_name_prefix="cdt-ckpt")
        _pending.append(_writer.submit(fn))


def drain_pending_saves() -> None:
    """Wait until every queued save has committed and stop the writer
    thread (the next save starts another); re-raise the first failure
    (after waiting for the others, whose failures are noted on it)."""
    global _writer
    with _writer_lock:
        pending, _pending[:] = _pending[:], []
        writer, _writer = _writer, None
    if writer is not None:
        writer.shutdown(wait=True)
    first = None
    for f in pending:
        try:
            f.result()
        except BaseException as e:  # every save is waited on before raising
            if first is None:
                first = e
            else:
                first.add_note(f"another pending save failed too: {e!r}")
    if first is not None:
        raise first


def snapshot(model: torch.nn.Module, optimizer: Any, on_device: bool = False) -> Dict[str, Any]:
    """The checkpoint tree, copied to host memory now: the model's state
    dict in the reference key layout, the optimizer's state and its step.
    With `on_device` the tensors are copied on their device instead, in
    stream order: the state once the work enqueued so far has run, which
    the steps enqueued after it leave as it is (a pipelined epoch's
    snapshot, fetched while the next epoch runs)."""
    copy = (lambda v: v.detach().clone()) if on_device else (lambda v: v.detach().to("cpu", copy=True))
    return {
        "model": {k: copy(v) for k, v in model.state_dict().items()},
        "optimizer": optimizer.state_dict(on_device=True) if on_device else optimizer.state_dict(),
        "step": int(optimizer.count),
    }


def save_checkpoint(
    directory: str,
    name: str,
    model: Optional[torch.nn.Module],
    optimizer: Any,
    epoch: int,
    metrics: Mapping[str, float],
    config: Config,
    extra: Optional[Dict[str, Any]] = None,
    *,
    tree: Optional[Dict[str, Any]] = None,
    block: bool = True,
) -> str:
    """Write `<directory>/<name>/` (e.g. "best_model", "latest_model") from
    `tree` (a `snapshot`), or from a snapshot of the model and optimizer
    taken now. `block=False` hands the writes to the background writer
    (failures surface at the next `drain_pending_saves`); the snapshot is
    taken before it returns either way, so the caller may go on updating
    the parameters in place."""
    base = Path(directory) / name
    base.mkdir(parents=True, exist_ok=True)
    if tree is None:
        tree = snapshot(model, optimizer)
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

    def commit() -> None:
        _replace_into(base / STATE, lambda p: torch.save(tree, p))
        _replace_into(base / META, lambda p: p.write_text(json.dumps(meta, indent=2)))

    if block:
        commit()
    else:
        _submit(commit)
    return str(base)


def read_meta(path: str) -> dict:
    return json.loads((Path(path) / META).read_text())


def load_checkpoint(path: str) -> Tuple[Dict[str, Any], int, Dict[str, float], Config]:
    """(tree, epoch, metrics, config) from a checkpoint directory; the
    tree's tensors are on the CPU. Pending background saves land first."""
    drain_pending_saves()
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
