"""Batched offline scoring of long recordings, in torch.

The port of `cough_detector_tpu/stream/offline.py`: instead of streaming a
long file through the ring buffer, frame the whole waveform into its
(n_windows, window) sliding-window batch and score the windows 1024 at a
time through the detector's score function (peak normalize → the fused
front-end kernel pair on the card → classifier → softmax). Smoothing,
threshold and debounce then run on the host over the per-window
probabilities, with the streaming detector's event semantics exactly.
Scoring over several cards waits for multi-device serving (ROADMAP
Queue 1 item 11).
"""

from __future__ import annotations

from collections import deque
from typing import List, Mapping, NamedTuple, Optional, Union

import numpy as np
import torch

from ..config import Config
from ..models import model_from_config, place_model
from ..ops import frontend
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
) -> np.ndarray:
    """Cough probability of every sliding window of one mono recording;
    `variables` is a state dict in the reference key layout."""
    dev = resolve_device(device)
    fcfg = config.features
    model = model_from_config(config.model)
    model.load_state_dict({k: torch.as_tensor(v) for k, v in variables.items()})
    model = place_model(model, dev)

    wave_d = torch.as_tensor(np.asarray(wave, np.float32)).to(dev)
    windows = frame_windows(wave_d, fcfg.segment_samples, int(fcfg.sample_rate * hop_duration))
    n = windows.shape[0]
    probs = np.empty(n, np.float32)
    with torch.no_grad():
        for start in range(0, n, batch_size):
            chunk = windows[start : start + batch_size].contiguous()
            real = chunk.shape[0]
            # The JAX package's rule: one batch shape across the batches of
            # a recording longer than one batch.
            if real < batch_size and n > batch_size:
                chunk = torch.nn.functional.pad(chunk, (0, 0, 0, batch_size - real))
            feats = frontend.extract_features_fast(frontend.peak_normalize(chunk), fcfg, device=dev)
            p = torch.softmax(model(feats), dim=-1)[:, 1]
            probs[start : start + real] = p[:real].cpu().numpy()
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
    `device` defaults to the card and raises if there is none."""
    if mesh not in (None, False):
        raise NotImplementedError(
            "scoring over several devices is not ported to the PyTorch package yet "
            "(ROADMAP Queue 1 item 11)"
        )
    if model_path is not None:
        from .detector import _load_checkpoint

        variables, config = _load_checkpoint(model_path)
    elif variables is None or config is None:
        raise ValueError("Provide model_path or (variables, config)")
    probs = window_probs(
        wave, variables, config, hop_duration=hop_duration,
        batch_size=batch_size, device=device,
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
