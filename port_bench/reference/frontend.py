"""The feature front end in plain torch, from the published definition.

The reference repository's AudioPreprocessor (src/preprocessing.py:94-550,
torchaudio conventions): a centred STFT with reflect padding and a periodic
Hann window of win_length zero-padded to n_fft; an HTK mel filterbank
without area normalisation; the mel branch as dB with top_db 80 scaled to
[0, 1], or PCEN (an avg-pool 1x10 smoother, zeros counted, then per-clip
min-max); MFCCs as the orthonormal DCT-II of the mel in dB, z-normed per
clip with the unbiased std; deltas as the replicate-padded central
difference; pre-emphasis y[n] = x[n] - c x[n-1] on the mel and MFCC input;
spectral contrast of the original signal over log-spaced bands (mean of the
top and bottom 20% of a band's power bins, in log1p) with the
Nyquist-normalised centroid of the n_fft-window magnitude, z-normed per
clip.

The DFT is a matmul against window-folded cosine and sine tables, and the
mel and DCT are matmuls, so the dtype and the TF32 switches of the caller
decide the precision of every stage. Imports torch and numpy alone.
"""

from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F

_AMIN = 1e-10


def hann_padded(win_length: int, n_fft: int) -> np.ndarray:
    n = np.arange(win_length, dtype=np.float64)
    w = 0.5 * (1.0 - np.cos(2.0 * np.pi * n / win_length))
    out = np.zeros(n_fft)
    left = (n_fft - win_length) // 2
    out[left:left + win_length] = w
    return out


def dft_tables(n_fft: int, win_length: int) -> np.ndarray:
    """(n_fft, 2 * n_freqs): window-folded cos, then -sin, float64."""
    w = hann_padded(win_length, n_fft)
    n = np.arange(n_fft, dtype=np.float64)
    k = np.arange(n_fft // 2 + 1, dtype=np.float64)
    ang = 2.0 * np.pi * np.outer(n, k) / n_fft
    return np.concatenate([np.cos(ang) * w[:, None], -np.sin(ang) * w[:, None]], axis=1)


def mel_bank(n_freqs: int, n_mels: int, sample_rate: int, f_min: float, f_max: float) -> np.ndarray:
    """(n_freqs, n_mels) triangular HTK filters, float64."""
    def hz_to_mel(f):
        return 2595.0 * np.log10(1.0 + np.asarray(f, np.float64) / 700.0)

    def mel_to_hz(m):
        return 700.0 * (10.0 ** (np.asarray(m, np.float64) / 2595.0) - 1.0)

    freqs = np.linspace(0.0, sample_rate / 2.0, n_freqs)
    pts = mel_to_hz(np.linspace(hz_to_mel(f_min), hz_to_mel(f_max), n_mels + 2))
    diff = pts[1:] - pts[:-1]
    slopes = pts[None, :] - freqs[:, None]
    down = -slopes[:, :-2] / diff[None, :-1]
    up = slopes[:, 2:] / diff[None, 1:]
    return np.maximum(0.0, np.minimum(down, up))


def dct_ortho(n_mfcc: int, n_mels: int) -> np.ndarray:
    """(n_mels, n_mfcc) orthonormal DCT-II, float64."""
    n = np.arange(n_mels, dtype=np.float64)
    k = np.arange(n_mfcc, dtype=np.float64)
    d = np.cos(np.pi / n_mels * (n[:, None] + 0.5) * k[None, :]) * 2.0
    d[:, 0] *= 1.0 / math.sqrt(2.0)
    return d / math.sqrt(2.0 * n_mels)


def band_edges(n_freqs: int, n_bands: int) -> np.ndarray:
    edges = np.logspace(0.0, np.log10(n_freqs), n_bands + 2)
    return np.clip(edges.astype(np.int64), 0, n_freqs)


def num_frames(cfg: Dict) -> int:
    n = int(cfg["sample_rate"] * cfg["segment_duration"])
    return (n + 2 * (cfg["n_fft"] // 2) - cfg["n_fft"]) // cfg["hop_length"] + 1


def _table(a: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    return torch.from_numpy(a).to(device=like.device, dtype=like.dtype)


def _frames(x: torch.Tensor, n_fft: int, hop: int) -> torch.Tensor:
    half = n_fft // 2
    return F.pad(x[:, None], (half, half), mode="reflect")[:, 0].unfold(-1, n_fft, hop)


def _spectrum(frames: torch.Tensor, n_fft: int, win_length: int) -> tuple:
    out = frames @ _table(dft_tables(n_fft, win_length), frames)
    re, im = out.split(n_fft // 2 + 1, dim=-1)
    return re, im


def _db(x: torch.Tensor) -> torch.Tensor:
    return 10.0 * torch.log10(torch.clamp(x, min=_AMIN))


def _znorm(x: torch.Tensor) -> torch.Tensor:
    mean = x.mean(dim=(1, 2), keepdim=True)
    n = x.shape[1] * x.shape[2]
    var = ((x - mean) ** 2).sum(dim=(1, 2), keepdim=True) / (n - 1)
    return (x - mean) / (torch.sqrt(var) + 1e-8)


def _deltas(x: torch.Tensor) -> torch.Tensor:
    p = torch.cat([x[:, :1], x, x[:, -1:]], dim=1)
    return (p[:, 2:] - p[:, :-2]) / 2.0


def _pcen(mel: torch.Tensor) -> torch.Tensor:
    t = mel.shape[1]
    smooth = F.avg_pool2d(F.pad(mel, (0, 0, 5, 5))[:, None], (10, 1), stride=1)[:, 0, :t]
    out = (mel / (1e-6 + smooth) ** 0.98 + 2.0) ** 0.5 - 2.0 ** 0.5
    lo = out.amin(dim=(1, 2), keepdim=True)
    hi = out.amax(dim=(1, 2), keepdim=True)
    return (out - lo) / (hi - lo + 1e-8)


def _contrast(x: torch.Tensor, cfg: Dict) -> torch.Tensor:
    n_fft, hop = cfg["n_fft"], cfg["hop_length"]
    n_freqs = n_fft // 2 + 1
    frames = _frames(x, n_fft, hop)
    re, im = _spectrum(frames, n_fft, cfg["win_length"])
    power = re * re + im * im
    re5, im5 = _spectrum(frames, n_fft, n_fft)
    mag = torch.sqrt(re5 * re5 + im5 * im5)
    edges = band_edges(n_freqs, cfg["n_contrast_bands"])
    rows = []
    for i in range(cfg["n_contrast_bands"]):
        low = int(edges[i])
        high = min(max(int(edges[i + 1]), low + 1), n_freqs)
        band = power[:, :, low:high]
        w = band.shape[2]
        if w == 1:
            rows.append(torch.zeros(power.shape[:2], dtype=power.dtype, device=power.device))
            continue
        n_top = w - min(max(1, int(w * 0.8)), w - 1)
        n_bot = max(1, int(w * 0.2))
        ordered = torch.sort(band, dim=2).values
        peak = ordered[:, :, w - n_top:].mean(dim=2)
        valley = ordered[:, :, :n_bot].mean(dim=2)
        rows.append(torch.log1p(peak) - torch.log1p(valley))
    freqs = _table(np.linspace(0, cfg["sample_rate"] // 2, n_freqs), mag)
    total = mag.sum(dim=2)
    live = total > 0
    centroid = torch.where(live, (mag * freqs).sum(dim=2) / torch.where(live, total, 1.0), 0.0)
    rows.append(centroid / (cfg["sample_rate"] / 2.0))
    return _znorm(torch.stack(rows, dim=2))


def features(waves: torch.Tensor, cfg: Dict) -> torch.Tensor:
    """(B, samples) waveforms -> (B, num_features, num_frames) feature
    images, in the waves' dtype. `cfg` holds the feature keys of a
    configuration file."""
    x = waves
    if cfg["use_pre_emphasis"]:
        x = torch.cat([x[:, :1], x[:, 1:] - cfg["pre_emphasis_coef"] * x[:, :-1]], dim=1)
    n_fft = cfg["n_fft"]
    re, im = _spectrum(_frames(x, n_fft, cfg["hop_length"]), n_fft, cfg["win_length"])
    mel = (re * re + im * im) @ _table(
        mel_bank(n_fft // 2 + 1, cfg["n_mels"], cfg["sample_rate"], cfg["f_min"], cfg["f_max"]), re)
    if cfg["use_pcen"]:
        parts = [_pcen(mel)]
    else:
        db = _db(mel)
        db = torch.maximum(db, db.amax(dim=(1, 2), keepdim=True) - 80.0)
        parts = [torch.clamp((db + 80.0) / 80.0, 0.0, 1.0)]
    if cfg["use_mfcc"]:
        mf = _znorm(_db(mel) @ _table(dct_ortho(cfg["n_mfcc"], cfg["n_mels"]), mel))
        d1 = _deltas(mf)
        parts += [mf, d1]
        if cfg["use_delta_delta"]:
            parts.append(_deltas(d1))
    out = torch.cat(parts, dim=2)
    if cfg["use_spectral_contrast"]:
        out = torch.cat([out, _contrast(waves, cfg)], dim=2)
    return out.transpose(1, 2)


def row_blocks(cfg: Dict) -> Dict[str, tuple]:
    """The feature image's row ranges by the stage that makes them."""
    blocks, at = {}, 0

    def take(name, n):
        nonlocal at
        blocks[name] = (at, at + n)
        at += n

    take("pcen" if cfg["use_pcen"] else "mel_db", cfg["n_mels"])
    if cfg["use_mfcc"]:
        take("mfcc", cfg["n_mfcc"])
        take("delta", cfg["n_mfcc"])
        if cfg["use_delta_delta"]:
            take("delta2", cfg["n_mfcc"])
    if cfg["use_spectral_contrast"]:
        take("contrast", cfg["n_contrast_bands"] + 1)
    return blocks
