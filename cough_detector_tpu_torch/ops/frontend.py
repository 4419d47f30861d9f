"""Batched PyTorch audio feature front end.

The port of `cough_detector_tpu/ops/frontend.py`: every stage is a function
of a batch of waveforms `(B, n_samples)` on any device, with the same
numerics (HTK mel scale, unnormalized filters, reflect-pad centered STFT
with a periodic Hann window, power-dB with amin=1e-10, orthonormal DCT-II,
unbiased-std z-normalization).

`extract_features` is the plain chain. `extract_features_fast` is what the
serving path calls: on a CUDA tensor it runs the hand-written fused kernel
(ops/frontend_kernel.py) for every config both its launches take on the
card (`frontend_kernel.card_supports`), and this chain for the rest, as
the JAX launcher falls back for the configs its kernel does not cover.
"""

from __future__ import annotations

import functools
import math
from typing import Optional, Union

import numpy as np
import torch
import torch.nn.functional as F

from ..config import FeatureConfig
from ..utils.device import resolve_device
from . import filters

_AMIN = 1e-10
_DB_SCALE = 10.0 / math.log(10.0)


@functools.lru_cache(maxsize=32)
def _padded_window(win_length: int, n_fft: int, device: torch.device):
    w = filters.padded_window(win_length, n_fft).astype(np.float32)
    return torch.from_numpy(w).to(device)


@functools.lru_cache(maxsize=32)
def _mel_fb(cfg: FeatureConfig, device: torch.device) -> torch.Tensor:
    fb = filters.mel_filterbank(
        cfg.n_fft // 2 + 1, cfg.n_mels, cfg.sample_rate, cfg.f_min, cfg.f_max
    )
    return torch.from_numpy(fb).to(device)


@functools.lru_cache(maxsize=32)
def _dct(n_mfcc: int, n_mels: int, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(filters.dct_matrix(n_mfcc, n_mels)).to(device)


# ---------------------------------------------------------------------------
# Waveform-domain stages
# ---------------------------------------------------------------------------


def to_mono(waveform: torch.Tensor) -> torch.Tensor:
    """(B, C, S) → (B, S) by channel mean; (B, S) passes through."""
    if waveform.ndim == 3:
        return waveform.mean(dim=1)
    return waveform


def peak_normalize(waveform: torch.Tensor) -> torch.Tensor:
    """Per-clip peak normalization to [-1, 1]; silent clips pass unchanged."""
    peak = waveform.abs().amax(dim=-1, keepdim=True)
    live = peak > 0
    return torch.where(live, waveform / torch.where(live, peak, 1.0), waveform)


def pre_emphasis(waveform: torch.Tensor, coef: float = 0.97) -> torch.Tensor:
    """y[n] = x[n] - coef*x[n-1], first sample kept."""
    out = waveform.clone()
    out[..., 1:] = waveform[..., 1:] - coef * waveform[..., :-1]
    return out


def pad_or_trim(waveform: torch.Tensor, length: int) -> torch.Tensor:
    """Center-trim or center zero-pad the last axis to `length`."""
    cur = waveform.shape[-1]
    if cur == length:
        return waveform
    if cur > length:
        start = (cur - length) // 2
        return waveform[..., start : start + length]
    pad = length - cur
    left = pad // 2
    return F.pad(waveform, (left, pad - left))


# ---------------------------------------------------------------------------
# Spectral stages
# ---------------------------------------------------------------------------


def frame_signal(waveform: torch.Tensor, n_fft: int, hop_length: int) -> torch.Tensor:
    """(B, S) → (B, n_frames, n_fft) centered frames, reflect-padded
    (torch.stft(center=True, pad_mode="reflect") semantics)."""
    half = n_fft // 2
    waveform = F.pad(waveform, (half, half), mode="reflect")
    return waveform.unfold(-1, n_fft, hop_length)


def power_spectrogram(
    waveform: torch.Tensor, n_fft: int, hop_length: int, win_length: int
) -> torch.Tensor:
    """Windowed power spectrogram |rfft|^2: (B, S) → (B, frames, freqs)
    (torchaudio Spectrogram(power=2, center=True, pad_mode="reflect"))."""
    frames = frame_signal(waveform, n_fft, hop_length)
    spec = torch.fft.rfft(frames * _padded_window(win_length, n_fft, waveform.device), dim=-1)
    return spec.real**2 + spec.imag**2


def mel_spectrogram(waveform: torch.Tensor, cfg: FeatureConfig) -> torch.Tensor:
    """(B, S) → (B, frames, n_mels) power mel spectrogram (time-major)."""
    spec = power_spectrogram(waveform, cfg.n_fft, cfg.hop_length, cfg.win_length)
    return spec @ _mel_fb(cfg, waveform.device)


def power_to_db(x: torch.Tensor, top_db: Optional[float] = None) -> torch.Tensor:
    """10*log10(max(x, 1e-10)), optionally clamped to per-clip max - top_db
    (torchaudio AmplitudeToDB(stype="power") with ref=1.0)."""
    db = _DB_SCALE * torch.log(torch.clamp(x, min=_AMIN))
    if top_db is not None:
        clip_max = db.amax(dim=tuple(range(1, x.ndim)), keepdim=True)
        db = torch.maximum(db, clip_max - top_db)
    return db


def log_mel_norm(mel: torch.Tensor, top_db: float = 80.0) -> torch.Tensor:
    """dB, then (db+80)/80 clipped to [0, 1]."""
    db = power_to_db(mel, top_db=top_db)
    return torch.clamp((db + top_db) / top_db, 0.0, 1.0)


def pcen(
    mel: torch.Tensor,
    alpha: float = 0.98,
    delta: float = 2.0,
    r: float = 0.5,
    eps: float = 1e-6,
) -> torch.Tensor:
    """Per-channel energy normalization, then per-clip min-max to [0, 1].

    The smoother is avg_pool(1×10), stride 1, pad 5 with zeros counted,
    trimmed to the input length. `mel` is (B, T, n_mels). The moving sum is
    ten shifted adds, not a cumsum difference: an f32 cumsum over loud
    clips cancels catastrophically in the windowed difference.
    """
    t = mel.shape[1]
    padded = F.pad(mel, (0, 0, 5, 5))
    smooth = padded[:, 0:t, :]
    for d in range(1, 10):
        smooth = smooth + padded[:, d : d + t, :]
    smooth = smooth / 10.0
    out = torch.pow(mel / torch.pow(eps + smooth, alpha) + delta, r) - delta**r
    lo = out.amin(dim=(1, 2), keepdim=True)
    hi = out.amax(dim=(1, 2), keepdim=True)
    return (out - lo) / (hi - lo + 1e-8)


def mfcc_from_mel(mel: torch.Tensor, cfg: FeatureConfig) -> torch.Tensor:
    """(B, T, n_mels) power mel → (B, T, n_mfcc): dB (no top_db), DCT-II,
    then the per-clip (x - mean) / (std + 1e-8) with the unbiased std."""
    out = power_to_db(mel, top_db=None) @ _dct(cfg.n_mfcc, cfg.n_mels, mel.device)
    mean = out.mean(dim=(1, 2), keepdim=True)
    n = out.shape[1] * out.shape[2]
    var = ((out - mean) ** 2).sum(dim=(1, 2), keepdim=True) / (n - 1)
    return (out - mean) / (torch.sqrt(var) + 1e-8)


def mfcc(waveform: torch.Tensor, cfg: FeatureConfig) -> torch.Tensor:
    """(B, S) → (B, frames, n_mfcc), globally z-normalized per clip."""
    return mfcc_from_mel(mel_spectrogram(waveform, cfg), cfg)


def compute_deltas(features: torch.Tensor) -> torch.Tensor:
    """Replicate-pad central difference over the time axis (axis 1) of a
    (B, T, F) tensor: (x[t+1] - x[t-1]) / 2."""
    padded = torch.cat([features[:, :1], features, features[:, -1:]], dim=1)
    return (padded[:, 2:, :] - padded[:, :-2, :]) / 2.0


def stack_features(mel: torch.Tensor, cfg: FeatureConfig) -> torch.Tensor:
    """(B, T, n_mels) power mel → (B, num_features, T): the mel branch (dB
    or PCEN), then MFCCs and their deltas when enabled."""
    parts = [pcen(mel) if cfg.use_pcen else log_mel_norm(mel)]
    if cfg.use_mfcc:
        mf = mfcc_from_mel(mel, cfg)
        d1 = compute_deltas(mf)
        parts += [mf, d1]
        if cfg.use_delta_delta:
            parts.append(compute_deltas(d1))
    return torch.cat(parts, dim=2).transpose(1, 2)


# ---------------------------------------------------------------------------
# Full stacked front end
# ---------------------------------------------------------------------------


def no_contrast(cfg: FeatureConfig) -> None:
    """Raises for configs with spectral contrast, which waits for its slice."""
    if cfg.use_spectral_contrast:
        raise NotImplementedError(
            "use_spectral_contrast is not ported to the PyTorch front end yet"
        )


def extract_features(waveform: torch.Tensor, cfg: FeatureConfig) -> torch.Tensor:
    """(B, segment_samples) → (B, num_features, num_frames) feature image:
    mel (+dB or PCEN) and MFCC (+deltas, +delta-deltas) from the optionally
    pre-emphasized signal. Shipped config yields (B, 90, 101)."""
    no_contrast(cfg)
    emph = (
        pre_emphasis(waveform, cfg.pre_emphasis_coef)
        if cfg.use_pre_emphasis
        else waveform
    )
    return stack_features(mel_spectrogram(emph, cfg), cfg)


def process(waveform: torch.Tensor, cfg: FeatureConfig) -> torch.Tensor:
    """normalize → center pad/trim → extract_features, batched."""
    waveform = peak_normalize(waveform)
    waveform = pad_or_trim(waveform, cfg.segment_samples)
    return extract_features(waveform, cfg)


def extract_features_fast(
    waveform: Union[torch.Tensor, np.ndarray],
    cfg: FeatureConfig,
    device: Union[str, torch.device] = "cuda",
) -> torch.Tensor:
    """The serving front end. `waveform` is placed on `device` (default the
    card; raises if there is none), then routed by that device: the fused
    CUDA kernel on the card for every config both its launches take, the
    plain chain otherwise."""
    from . import frontend_kernel

    dev = resolve_device(device)
    waveform = torch.as_tensor(waveform, dtype=torch.float32, device=dev)
    if dev.type == "cuda" and frontend_kernel.card_supports(
        cfg, waveform.shape[-1]
    ):
        return frontend_kernel.extract_features_fused(waveform, cfg)
    return extract_features(waveform, cfg)
