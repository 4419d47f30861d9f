"""Synthetic 16-bit PCM made on the device from the seed.

Each row is a background of tilted noise (white to pink, a level drawn per
row) with cough-like bursts over it: a fast attack and an exponential
decay, band-emphasised noise around a resonance and a voiced part of four
harmonics. A share of the rows (clips of a corpus) stops early and is
zero-padded to the clip length, as short clips are packed. The sizes come
from the traffic file; the seed changes only the content.
"""

from __future__ import annotations

import math
from typing import Dict

import torch

from .weights import subseed


def _tilted(gen, rows: int, n: int, device, tilt, centre=None, width=None) -> torch.Tensor:
    """(rows, n) unit-RMS noise with a spectral tilt of f^(-tilt/2) per row
    and, with `centre` (cycles a sample), a log-Gaussian band of `width`
    octaves around it."""
    x = torch.randn(rows, n, generator=gen, device=device)
    spec = torch.fft.rfft(x)
    f = torch.linspace(0.0, 0.5, n // 2 + 1, device=device).clamp_min(1.0 / n)
    shape = (f[None] / 0.5) ** (-tilt[:, None] / 2.0)
    if centre is not None:
        shape = shape * torch.exp(-0.5 * (torch.log2(f[None] / centre[:, None]) / width[:, None]) ** 2)
    y = torch.fft.irfft(spec * shape, n=n)
    return y / y.pow(2).mean(dim=1, keepdim=True).sqrt().clamp_min(1e-12)


def _rows(gen, rows: int, n: int, sr: int, p: Dict, device) -> torch.Tensor:
    def u(*shape):
        return torch.rand(*shape, generator=gen, device=device)

    t = torch.arange(n, device=device, dtype=torch.float32) / sr
    level = torch.exp(math.log(p["noise_rms"][0]) + u(rows) * math.log(p["noise_rms"][1] / p["noise_rms"][0]))
    x = _tilted(gen, rows, n, device, 1.5 * u(rows)) * level[:, None]

    k = p["bursts_per_s"] * n / sr
    n_burst = max(1, math.ceil(k))
    on = u(rows, n_burst) * (n / sr)
    live = u(rows, n_burst) < k / n_burst
    dur = p["burst_s"][0] + u(rows, n_burst) * (p["burst_s"][1] - p["burst_s"][0])
    amp = (p["burst_peak"][0] + u(rows, n_burst) * (p["burst_peak"][1] - p["burst_peak"][0])) * live
    dt = t[None, None, :] - on[:, :, None]
    env = torch.where(dt >= 0, (1.0 - torch.exp(-dt.clamp_min(0) / 0.012)) * torch.exp(-dt.clamp_min(0) / (dur[:, :, None] / 3.0)), 0.0)
    env = (env * amp[:, :, None]).sum(dim=1)

    centre = (300.0 + u(rows) * 2200.0) / sr
    band = _tilted(gen, rows, n, device, torch.zeros(rows, device=device), centre, 0.6 + u(rows))
    f0 = 120.0 + u(rows) * 200.0
    voiced = sum(torch.sin(2 * math.pi * h * f0[:, None] * t[None] + 2 * math.pi * u(rows, 1)) / h for h in range(1, 5))
    mix = u(rows, 1)
    x = x + env * (band * (0.5 + 0.5 * mix) + 0.4 * voiced * (1.0 - mix))

    short = u(rows) < p["padded_share"]
    keep = (p["padded_keep"][0] + u(rows) * (p["padded_keep"][1] - p["padded_keep"][0])) * n
    x = torch.where(short[:, None] & (torch.arange(n, device=device)[None] >= keep[:, None]), 0.0, x)
    return x.clamp(-0.98, 0.98)


def pcm(rows: int, n: int, seed: int, tag: str, params: Dict, device, sample_rate: int = 16000,
        block: int = 512) -> torch.Tensor:
    """(rows, n) int16 PCM on `device`, made `block` rows at a time from
    one generator seeded by the run's seed and `tag`."""
    gen = torch.Generator(device=device).manual_seed(subseed(seed, tag))
    out = torch.empty((rows, n), dtype=torch.int16, device=device)
    for lo in range(0, rows, block):
        hi = min(rows, lo + block)
        out[lo:hi] = torch.round(_rows(gen, hi - lo, n, sample_rate, params, device) * 32767.0).to(torch.int16)
    return out
