"""Constant filter/transform matrices for the audio front end.

The port's own numpy copy of `cough_detector_tpu/ops/filters.py`: the same
float64 construction cast to float32, so both packages feed bit-identical
constants to their front ends.

Numerics follow the torchaudio conventions the reference relies on
(reference: src/preprocessing.py:94-127): HTK mel scale, unnormalized
triangular filters, periodic Hann window, orthonormal DCT-II.
"""

from __future__ import annotations

import functools

import numpy as np


def hann_window(win_length: int, dtype=np.float64) -> np.ndarray:
    """Periodic Hann window (torch.hann_window(periodic=True) semantics)."""
    n = np.arange(win_length, dtype=dtype)
    return 0.5 * (1.0 - np.cos(2.0 * np.pi * n / win_length))


def padded_window(win_length: int, n_fft: int, dtype=np.float64) -> np.ndarray:
    """Hann window zero-padded symmetrically to n_fft.

    torch.stft centers a shorter window inside the FFT frame with
    left pad (n_fft - win_length) // 2.
    """
    w = hann_window(win_length, dtype)
    left = (n_fft - win_length) // 2
    out = np.zeros(n_fft, dtype=dtype)
    out[left : left + win_length] = w
    return out


def _hz_to_mel_htk(f):
    return 2595.0 * np.log10(1.0 + np.asarray(f, dtype=np.float64) / 700.0)


def _mel_to_hz_htk(m):
    return 700.0 * (10.0 ** (np.asarray(m, dtype=np.float64) / 2595.0) - 1.0)


def mel_filterbank(
    n_freqs: int,
    n_mels: int,
    sample_rate: int,
    f_min: float,
    f_max: float,
    dtype=np.float32,
) -> np.ndarray:
    """Triangular mel filterbank, shape (n_freqs, n_mels).

    HTK mel scale, no area normalization. Laid out so `power_spec @ fb`
    maps (frames, n_freqs) → (frames, n_mels).
    """
    all_freqs = np.linspace(0.0, sample_rate / 2.0, n_freqs)
    m_pts = np.linspace(_hz_to_mel_htk(f_min), _hz_to_mel_htk(f_max), n_mels + 2)
    f_pts = _mel_to_hz_htk(m_pts)
    f_diff = f_pts[1:] - f_pts[:-1]  # (n_mels + 1,)
    slopes = f_pts[None, :] - all_freqs[:, None]  # (n_freqs, n_mels + 2)
    down = -slopes[:, :-2] / f_diff[None, :-1]
    up = slopes[:, 2:] / f_diff[None, 1:]
    fb = np.maximum(0.0, np.minimum(down, up))
    return fb.astype(dtype)


def dct_matrix(n_mfcc: int, n_mels: int, dtype=np.float32) -> np.ndarray:
    """Orthonormal DCT-II matrix, shape (n_mels, n_mfcc).

    `log_mel @ dct` maps (frames, n_mels) → (frames, n_mfcc); the
    torchaudio create_dct(norm='ortho') convention.
    """
    n = np.arange(n_mels, dtype=np.float64)
    k = np.arange(n_mfcc, dtype=np.float64)
    dct = np.cos(np.pi / n_mels * (n[:, None] + 0.5) * k[None, :]) * 2.0
    dct[:, 0] *= 1.0 / np.sqrt(2.0)
    dct *= 1.0 / np.sqrt(2.0 * n_mels)
    return dct.astype(dtype)


@functools.lru_cache(maxsize=16)
def dft_matrices(n_fft: int, win_length: int, dtype=np.dtype(np.float32)):
    """Real/imag DFT-as-matmul operators with the window folded in.

    Returns (C, S), each shaped (n_fft, n_freqs) with n_freqs = n_fft//2 + 1,
    such that for a frame x of n_fft samples:
        real = x @ C,  imag = x @ S,  |X|^2 = real^2 + imag^2.
    The arrays are shared by every caller: treat them as read-only.
    """
    w = padded_window(win_length, n_fft)
    n = np.arange(n_fft, dtype=np.float64)
    k = np.arange(n_fft // 2 + 1, dtype=np.float64)
    ang = 2.0 * np.pi * n[:, None] * k[None, :] / n_fft
    c = (np.cos(ang) * w[:, None]).astype(dtype)
    s = (-np.sin(ang) * w[:, None]).astype(dtype)
    return c, s
