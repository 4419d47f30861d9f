"""Batched PyTorch audio feature front end.

The port of `cough_detector_tpu/ops/frontend.py`: every stage is a function
of a batch of waveforms `(B, n_samples)` on any device, with the same
numerics (HTK mel scale, unnormalized filters, reflect-pad centered STFT
with a periodic Hann window, power-dB with amin=1e-10, orthonormal DCT-II,
unbiased-std z-normalization).

`extract_features` is the plain chain. `extract_features_fast` is what the
serving path calls: on a CUDA tensor it runs the hand-written fused kernel
(ops/frontend_kernel.py) for every config the JAX launcher sends to its
Pallas kernel (`frontend_kernel.kernel_supports`), and this chain for the
rest (no MFCCs, or another length), as the JAX launcher falls back.
For a config with spectral contrast the kernel pair computes the mel and
MFCC rows and a third launch the contrast rows, as the JAX launcher's
hybrid branch appends them; `spectral_contrast` is that launch's plain
version.
"""

from __future__ import annotations

import contextlib
import functools
import math
from typing import Iterator, Optional, Union

import numpy as np
import torch
import torch.nn.functional as F

from ..config import FeatureConfig
from ..utils.device import resolve_device
from . import filters

_AMIN = 1e-10
_DB_SCALE = 10.0 / math.log(10.0)


def device_cache(build):
    """Cache a constant tensor per argument tuple (device included), except
    while torch traces (torch.compile, torch.export): a tensor built then
    is the trace's own and becomes a constant of its graph, and a cached
    one would leak into eager calls and later traces."""
    cached = functools.lru_cache(maxsize=32)(build)

    @functools.wraps(build)
    def get(*args):
        if torch.compiler.is_compiling():
            return build(*args)
        return cached(*args)

    return get


@device_cache
def _padded_window(win_length: int, n_fft: int, device: torch.device):
    w = filters.padded_window(win_length, n_fft).astype(np.float32)
    return torch.from_numpy(w).to(device)


@device_cache
def _mel_fb(cfg: FeatureConfig, device: torch.device) -> torch.Tensor:
    fb = filters.mel_filterbank(
        cfg.n_fft // 2 + 1, cfg.n_mels, cfg.sample_rate, cfg.f_min, cfg.f_max
    )
    return torch.from_numpy(fb).to(device)


@device_cache
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


def magnitude_spectrogram(
    waveform: torch.Tensor, n_fft: int, hop_length: int, win_length: int
) -> torch.Tensor:
    """Windowed magnitude spectrogram |rfft| (torchaudio Spectrogram with
    power=1)."""
    return torch.sqrt(power_spectrogram(waveform, n_fft, hop_length, win_length))


def mel_spectrogram(waveform: torch.Tensor, cfg: FeatureConfig) -> torch.Tensor:
    """(B, S) → (B, frames, n_mels) power mel spectrogram (time-major).

    On a CPU tensor the power spectrogram runs in float64 and each bin is
    rounded once to the input's dtype before the mel: a float32 FFT's
    rounding in the bins a sine sweep leaves near zero, which dB and the
    DCT lift into the MFCCs, put the float32 chain up to 8.0e-4 from a
    float64 chain on some CPUs (tools/host_numerics_probe.py), past what
    the 1e-3 parity budget leaves beside the JAX chain's own 6.9e-4. The
    mel sums positive bins, with no cancellation, so it stays in float32
    (in float64 too it moved a detection's printed confidence off the JAX
    CLI's, tests/test_torch_cli.py). A CUDA tensor keeps the float32
    chain: it is the card's plain version, and its times are the float32
    chain's."""
    if waveform.device.type == "cpu":
        spec = power_spectrogram(waveform.double(), cfg.n_fft, cfg.hop_length, cfg.win_length).to(waveform.dtype)
    else:
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
# Spectral contrast
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def fp32_matmul(device: torch.device) -> Iterator[None]:
    """cuBLAS's TF32 off on the card for the duration, restored after."""
    if device.type != "cuda":
        yield
        return
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


@device_cache
def _contrast_dft(n_fft: int, win_length: int, device: torch.device) -> torch.Tensor:
    """(n_fft, 4 * n_freqs): the win_length-window cos and -sin columns, then
    the n_fft-window ones."""
    c4, s4 = filters.dft_matrices(n_fft, win_length)
    c5, s5 = filters.dft_matrices(n_fft, n_fft)
    return torch.from_numpy(np.concatenate([c4, s4, c5, s5], axis=1)).to(device)


@device_cache
def _centroid_freqs(sample_rate: int, n_freqs: int, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(
        np.linspace(0, sample_rate // 2, n_freqs, dtype=np.float32)
    ).to(device)


def contrast_band_edges(n_freqs: int, n_bands: int) -> np.ndarray:
    """torch.logspace(0, log10(n_freqs), n_bands + 2).int() (truncated),
    clipped to [0, n_freqs]: 1, 2, 4, 10, 23, 52, 116, 257 at n_fft 512."""
    edges = np.logspace(0.0, np.log10(n_freqs), n_bands + 2)
    return np.clip(edges.astype(np.int64), 0, n_freqs)


def _tail_sums_rank(band: torch.Tensor, n_top: int, n_bot: int) -> tuple:
    """Exact top-`n_top` / bottom-`n_bot` sums along the last axis from a
    stable descending rank: element a's rank is |{b : x_b > x_a}| +
    |{b < a : x_b == x_a}|, a permutation of 0..W-1, so the tail sums equal
    summing a stable sort's slices. One (W, W) compare serves both tails."""
    w = band.shape[-1]
    idx = torch.arange(w, device=band.device)
    tie = idx[None, :] < idx[:, None]  # [a, b]: b before a
    a = band[..., :, None]
    b = band[..., None, :]
    rank = ((b > a) | ((b == a) & tie)).sum(dim=-1)
    zero = torch.zeros((), dtype=band.dtype, device=band.device)
    top = torch.where(rank < n_top, band, zero).sum(dim=-1)
    bot = torch.where(rank >= w - n_bot, band, zero).sum(dim=-1)
    return top, bot


def spectral_contrast(
    waveform: torch.Tensor, cfg: FeatureConfig, method: str = "fft",
    tails: str = "auto",
) -> torch.Tensor:
    """(B, S) → (B, T, n_bands+1): per-band peak-valley contrast and the
    spectral centroid, z-normalized per clip with the unbiased std.

    The reference's hand-rolled contrast (reference:
    src/preprocessing.py:242-303): log-spaced bands of the power
    spectrogram, log1p(mean of the top 20% of a band's bins) − log1p(mean
    of the bottom 20%), and a Nyquist-normalized centroid of the
    n_fft-window magnitude spectrogram. A single-bin band contributes 0
    (the reference's empty peak slice is NaN there), and the centroid of a
    silent frame is 0 (torchaudio's is 0/0).

    `method`: "fft" (torch.fft, the parity reference) or "gemm" (the four
    DFT projections of both windows as one FP32 matmul over one frames
    tensor, cuBLAS's TF32 off for the call; the plain version of the
    contrast launch, ops/frontend_kernel.py::spectral_contrast_fused). `tails`: "select" (torch.topk) or "rank" (stable-rank masked
    sums, `_tail_sums_rank`); "auto", and any value other than "rank",
    means "select". Both select exactly and differ only in the order of
    the sums.
    """
    n_freqs = cfg.n_fft // 2 + 1
    if method == "gemm":
        frames = frame_signal(waveform, cfg.n_fft, cfg.hop_length)
        with fp32_matmul(waveform.device):
            out = frames @ _contrast_dft(cfg.n_fft, cfg.win_length, waveform.device)
        re4, im4, re5, im5 = out.split(n_freqs, dim=2)
        spec = re4 * re4 + im4 * im4
        mag = torch.sqrt(re5 * re5 + im5 * im5)
    elif method == "fft":
        spec = power_spectrogram(waveform, cfg.n_fft, cfg.hop_length, cfg.win_length)
        mag = magnitude_spectrogram(waveform, cfg.n_fft, cfg.hop_length, cfg.n_fft)
    else:
        raise ValueError(f"Unknown STFT method: {method!r}")
    return contrast_from_spectra(spec, mag, cfg, tails)


def contrast_from_spectra(
    spec: torch.Tensor, mag: torch.Tensor, cfg: FeatureConfig, tails: str = "auto"
) -> torch.Tensor:
    """`spectral_contrast` after its two spectrograms: the win_length-window
    power `spec` and the n_fft-window magnitude `mag`, each
    (B, T, n_freqs), → (B, T, n_bands+1), z-normalized per clip."""
    n_freqs = cfg.n_fft // 2 + 1
    t = spec.shape[1]
    edges = contrast_band_edges(n_freqs, cfg.n_contrast_bands)

    rows = []
    for i in range(cfg.n_contrast_bands):
        low, high = int(edges[i]), int(edges[i + 1])
        high = min(max(high, low + 1), n_freqs)
        band = spec[:, :, low:high]
        n_bins = band.shape[2]
        if n_bins == 1:
            rows.append(torch.zeros(spec.shape[:2], dtype=spec.dtype, device=spec.device))
            continue
        top_idx = min(max(1, int(n_bins * 0.8)), n_bins - 1)
        bot_idx = max(1, int(n_bins * 0.2))
        n_top = n_bins - top_idx
        if tails == "rank" and (n_top > 1 or bot_idx > 1):
            tops, bots = _tail_sums_rank(band, n_top, bot_idx)
            peaks, valleys = tops / n_top, bots / bot_idx
        else:
            peaks = (
                band.amax(dim=2) if n_top == 1
                else band.topk(n_top, dim=2).values.mean(dim=2)
            )
            valleys = (
                band.amin(dim=2) if bot_idx == 1
                else band.topk(bot_idx, dim=2, largest=False).values.mean(dim=2)
            )
        rows.append(torch.log1p(peaks) - torch.log1p(valleys))

    freqs = _centroid_freqs(cfg.sample_rate, n_freqs, spec.device)
    mag_sum = mag.sum(dim=2)
    live = mag_sum > 0
    centroid = torch.where(
        live, (mag * freqs).sum(dim=2) / torch.where(live, mag_sum, 1.0), 0.0
    )
    rows.append(centroid / (cfg.sample_rate / 2.0))

    contrast = torch.stack(rows, dim=2)[:, :t, :]
    mean = contrast.mean(dim=(1, 2), keepdim=True)
    n = contrast.shape[1] * contrast.shape[2]
    var = ((contrast - mean) ** 2).sum(dim=(1, 2), keepdim=True) / (n - 1)
    return (contrast - mean) / (torch.sqrt(var) + 1e-8)


# ---------------------------------------------------------------------------
# Full stacked front end
# ---------------------------------------------------------------------------


def extract_features(waveform: torch.Tensor, cfg: FeatureConfig) -> torch.Tensor:
    """(B, segment_samples) → (B, num_features, num_frames) feature image:
    mel (+dB or PCEN) and MFCC (+deltas, +delta-deltas) from the optionally
    pre-emphasized signal, then the spectral contrast rows of the original
    signal when enabled. Shipped config yields (B, 90, 101)."""
    emph = (
        pre_emphasis(waveform, cfg.pre_emphasis_coef)
        if cfg.use_pre_emphasis
        else waveform
    )
    feats = stack_features(mel_spectrogram(emph, cfg), cfg)
    if cfg.use_spectral_contrast:
        feats = torch.cat([feats, spectral_contrast(waveform, cfg).transpose(1, 2)], dim=1)
    return feats


def process(waveform: torch.Tensor, cfg: FeatureConfig) -> torch.Tensor:
    """normalize → center pad/trim → extract_features, batched."""
    waveform = peak_normalize(waveform)
    waveform = pad_or_trim(waveform, cfg.segment_samples)
    return extract_features(waveform, cfg)


def make_feature_fn(cfg: FeatureConfig):
    """The JAX package's jitted feature extractor, as a plain callable:
    (B, segment_samples) → (B, H, T) through `extract_features`."""
    return functools.partial(extract_features, cfg=cfg)


def make_process_fn(cfg: FeatureConfig):
    """The JAX package's jitted normalize → pad/trim → features pipeline for
    raw 16 kHz batches, as a plain callable (`process`)."""
    return functools.partial(process, cfg=cfg)


def extract_features_fast(
    waveform: Union[torch.Tensor, np.ndarray],
    cfg: FeatureConfig,
    device: Union[str, torch.device] = "cuda",
) -> torch.Tensor:
    """The serving front end. `waveform` is placed on `device` (default the
    card; raises if there is none), then routed by that device: the fused
    CUDA kernel on the card for every config the kernel computes, the
    plain chain otherwise."""
    from . import frontend_kernel

    dev = resolve_device(device)
    waveform = torch.as_tensor(waveform, dtype=torch.float32, device=dev)
    if dev.type == "cuda" and frontend_kernel.kernel_supports(
        cfg, waveform.shape[-1]
    ):
        return frontend_kernel.extract_features_fused(waveform, cfg)
    return extract_features(waveform, cfg)
