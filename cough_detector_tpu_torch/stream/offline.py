"""Batched offline scoring of long recordings, in torch.

The port of `cough_detector_tpu/stream/offline.py`: instead of streaming a
long file through the ring buffer, frame the whole waveform into its
(n_windows, window) sliding-window batch and score the windows 1024 at a
time through the detector's score function (peak normalize → the fused
front-end kernel pair on the card → classifier → softmax), run as a
captured program a batch shape (utils.graphs, the JAX package's jitted
`score`). Smoothing, threshold and debounce then run on the host over the
per-window probabilities, with the streaming detector's event semantics
exactly. Over a mesh of devices each batch is padded to a multiple of them
and split in contiguous blocks, one a device, each scored by that device's
model replica and its own programs; the probabilities come back in window
order.

Batch shapes: a recording longer than one batch, or scored over a mesh,
pads every batch to the batch size, as the JAX package does; a shorter one
pads its one batch to `graphs.bucket_rows` (the next power of two, at
least 16), where the JAX package compiles each length's own shape, so that
many short recordings share a few graphs.
"""

from __future__ import annotations

import copy
from collections import deque
from typing import List, Mapping, NamedTuple, Optional, Union

import numpy as np
import torch

from .. import parallel
from ..config import Config
from ..models import model_from_config, place_model
from ..ops import frontend
from ..utils import graphs
from ..utils.device import resolve_device


class OfflineDetection(NamedTuple):
    time_seconds: float
    confidence: float


def frame_windows(wave: torch.Tensor, window_samples: int, hop_samples: int) -> torch.Tensor:
    """(S,) → (n_windows, window_samples) sliding-window batch (a strided
    view; empty when the recording is shorter than one window)."""
    n = (wave.shape[-1] - window_samples) // hop_samples + 1
    if n <= 0:
        return wave.new_zeros((0, window_samples))
    return wave.unfold(-1, window_samples, hop_samples)[:n]


def smooth_and_debounce(
    probs: np.ndarray,
    hop_samples: int,
    window_samples: int,
    sample_rate: int,
    threshold: float,
    smoothing_window: int,
    debounce_seconds: float,
) -> List[OfflineDetection]:
    """Streaming-equivalent event extraction over batched window scores
    (reference semantics: src/inference.py:216-239). Debouncing uses
    integer sample indices, as the ring buffer does."""
    history: deque = deque(maxlen=smoothing_window)
    debounce = int(round(debounce_seconds * sample_rate))
    last_fire = -(1 << 60)
    out: List[OfflineDetection] = []
    for k, p in enumerate(probs):
        history.append(float(p))
        smoothed = float(np.mean(history))
        t_samples = k * hop_samples + window_samples
        if smoothed >= threshold and t_samples - last_fire >= debounce:
            last_fire = t_samples
            # Exact float64 division, as StreamingDetector.collect_events
            # does: float32 loses whole samples past 2^24 (~17.5 min).
            out.append(OfflineDetection(t_samples / sample_rate, smoothed))
    return out


def window_probs(
    wave: np.ndarray,
    variables: Mapping,
    config: Config,
    *,
    hop_duration: float = 0.25,
    batch_size: int = 1024,
    device: Union[str, torch.device] = "cuda",
    mesh: Optional[parallel.Mesh] = None,
) -> np.ndarray:
    """Cough probability of every sliding window of one mono recording;
    `variables` is a state dict in the reference key layout. With `mesh`,
    each batch is split over its devices (`device` is then unused)."""
    fcfg = config.features
    devices = [resolve_device(device)] if mesh is None else mesh.devices
    if mesh is not None:
        # Every batch splits evenly: the batch size rounds up to a multiple.
        batch_size = -(-batch_size // mesh.size) * mesh.size
    model = model_from_config(config.model)
    model.load_state_dict({k: torch.as_tensor(v) for k, v in variables.items()})
    replicas = [place_model(copy.deepcopy(model), d) for d in devices]
    # A replica's graphs hold its parameters' addresses: programs of its own.
    programs = [graphs.Programs(d, name="offline score", pool=graphs.scoring_pool(d)) for d in devices]

    def score_fn(model_d):
        def fn(static):
            feats = frontend.extract_features_fast(
                frontend.peak_normalize(static["windows"]), fcfg, device=static["windows"].device
            )
            return (torch.softmax(model_d(feats), dim=-1)[:, 1],)

        return fn

    fns = [score_fn(m) for m in replicas]
    host = torch.as_tensor(np.asarray(wave, np.float32))
    hop = int(fcfg.sample_rate * hop_duration)
    uploaded = {}
    windows = []
    for d in devices:  # the recording once on each distinct device
        if d not in uploaded:
            uploaded[d] = frame_windows(host.to(d), fcfg.segment_samples, hop)
        windows.append(uploaded[d])
    n = windows[0].shape[0]
    probs = np.empty(n, np.float32)
    with torch.no_grad():
        for start in range(0, n, batch_size):
            real = min(batch_size, n - start)
            # One batch shape across the batches of a recording longer than
            # one batch, and under a mesh always (the JAX package's rule); a
            # shorter recording's bucket (see the module docstring).
            rows = batch_size if (n > batch_size or mesh is not None) else graphs.bucket_rows(real, batch_size)
            bounds = [(0, rows)] if mesh is None else mesh.blocks(rows)
            parts = []
            for progs, fn, win, (lo, hi) in zip(programs, fns, windows, bounds):
                chunk = graphs.pad_rows(win[start + lo : start + min(hi, real)], hi - lo)
                parts.append(progs((tuple(chunk.shape), "float32"), fn, {"windows": chunk}, copy=(False,))[0].cpu())
            probs[start : start + real] = torch.cat(parts).numpy()[:real]
    return probs


def score_recording(
    wave: np.ndarray,
    variables: Optional[Mapping] = None,
    config: Optional[Config] = None,
    *,
    model_path: Optional[str] = None,
    hop_duration: float = 0.25,
    threshold: float = 0.5,
    smoothing_window: int = 3,
    debounce_seconds: float = 0.5,
    batch_size: int = 1024,
    mesh=None,
    device: Union[str, torch.device] = "cuda",
) -> List[OfflineDetection]:
    """Score one long mono recording at the config's rate; returns the
    debounced detections streaming it chunk by chunk would give.
    Weights: a state dict in the reference key layout with `config`, or
    `model_path` (a reference `.pt` file or a checkpoint directory).
    `device` defaults to the card and raises if there is none. `mesh`: a
    `parallel.Mesh` or device list the batches split over; None takes
    every visible card when `device` is "cuda" and there are several;
    False, one device."""
    mesh = parallel.resolve_mesh(mesh, device)
    if model_path is not None:
        from .detector import _load_checkpoint

        variables, config = _load_checkpoint(model_path)
    elif variables is None or config is None:
        raise ValueError("Provide model_path or (variables, config)")
    probs = window_probs(
        wave, variables, config, hop_duration=hop_duration,
        batch_size=batch_size, device=device, mesh=mesh,
    )
    fcfg = config.features
    return smooth_and_debounce(
        probs,
        hop_samples=int(fcfg.sample_rate * hop_duration),
        window_samples=fcfg.segment_samples,
        sample_rate=fcfg.sample_rate,
        threshold=threshold,
        smoothing_window=smoothing_window,
        debounce_seconds=debounce_seconds,
    )
