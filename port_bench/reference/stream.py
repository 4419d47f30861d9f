"""The streaming detector's rules in plain numpy and torch.

The reference repository's CoughDetectorInference (src/inference.py:49-241)
run on one stream at a time: windows of window_samples every hop_samples
over the stream's samples, each peak-normalised, featurised and scored
(softmax, class 1); the score smoothed as the mean of the last
`smoothing` scores; an event where the smoothed score reaches the
threshold and at least debounce_seconds have passed since the stream's
last event, counted in whole windows. Imports torch and numpy alone.
"""

from __future__ import annotations

from typing import Callable, Dict

import numpy as np
import torch


def windows_completed(n_samples: int, window: int, hop: int) -> int:
    """How many windows a stream of n_samples has completed."""
    return 0 if n_samples < window else (n_samples - window) // hop + 1


def completion_tick(w: int, window: int, hop: int, chunk: int) -> int:
    """The tick (from 0) whose chunk completes window w."""
    return -(-(w * hop + window) // chunk) - 1


def scores(audio: np.ndarray, window: int, hop: int, score: Callable[[torch.Tensor], torch.Tensor],
           device, dtype, block: int = 2048) -> np.ndarray:
    """(streams, samples) float audio -> (streams, windows) class-1
    probabilities, scored `block` windows at a time on `device` in
    `dtype`. `score` maps (B, window) peak-normalised waves to logits."""
    s, n = audio.shape
    n_win = windows_completed(n, window, hop)
    starts = np.arange(n_win) * hop
    rows = [(i, w) for i in range(s) for w in range(n_win)]
    out = np.zeros((s, n_win))
    src = torch.from_numpy(audio)
    for lo in range(0, len(rows), block):
        part = rows[lo:lo + block]
        x = torch.stack([src[i, starts[w]:starts[w] + window] for i, w in part]).to(device=device, dtype=dtype)
        peak = x.abs().amax(dim=1, keepdim=True)
        x = torch.where(peak > 0, x / torch.where(peak > 0, peak, 1.0), x)
        p = torch.softmax(score(x), dim=-1)[:, 1].double().cpu().numpy()
        for (i, w), v in zip(part, p):
            out[i, w] = v
    return out


def smooth(p: np.ndarray, n: int) -> np.ndarray:
    """Mean of each window's score and up to n-1 before it."""
    c = np.cumsum(np.pad(p, ((0, 0), (1, 0))), axis=1)
    idx = np.arange(p.shape[1])
    lo = np.maximum(idx + 1 - n, 0)
    return (c[:, idx + 1] - c[:, lo]) / (idx + 1 - lo)


def fire(smoothed: np.ndarray, threshold: float, debounce_windows: int) -> np.ndarray:
    """(streams, windows) bool: the windows whose smoothed score reaches
    the threshold with at least debounce_windows since the last event."""
    out = np.zeros(smoothed.shape, bool)
    last = np.full(smoothed.shape[0], -(1 << 30))
    for w in range(smoothed.shape[1]):
        ok = (smoothed[:, w] >= threshold) & (w - last >= debounce_windows)
        out[:, w] = ok
        last = np.where(ok, w, last)
    return out


def debounce_windows(debounce_seconds: float, sample_rate: int, hop: int) -> int:
    return -(-int(round(debounce_seconds * sample_rate)) // hop)


def expected(params: Dict, n_ticks: int) -> Dict[int, int]:
    """tick -> the window it completes, for a stream fed n_ticks chunks
    from empty."""
    window, hop, chunk = params["window"], params["hop"], params["chunk"]
    n_win = windows_completed(n_ticks * chunk, window, hop)
    return {completion_tick(w, window, hop, chunk): w for w in range(n_win)}
