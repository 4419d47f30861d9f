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


@functools.lru_cache(maxsize=64)  # chip_smoke.py's every-config checks use 32 (n_fft, win_length) pairs
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


@functools.lru_cache(maxsize=8)
def four_step_dft_matrices(n_fft: int, win_length: int, n1: int = 16, dtype=np.dtype(np.float32)):
    """Two-stage (four-step, Bailey) rDFT as dense matmuls with exact zeros.

    Returns (M1c, M1s, twc, tws, M2c, M2s) such that for a frame x (n_fft,):
        B = x @ (M1c + i·M1s)          stage-1 DFT over n1, window folded in
        C = B ⊙ (twc + i·tws)          twiddle, elementwise
        X = C @ (M2c + i·M2s)          stage-2 DFT over n2 → the rfft bins
    with layouts j = k1*n2_len + n2 and output k in [0, n_fft//2 + 1). The
    stage sums are 16 and 32 terms long where the plain DFT's is n_fft, so
    the error follows an FFT's. The arrays are shared by every caller:
    treat them as read-only.
    """
    if n_fft % n1:
        raise ValueError(f"n_fft={n_fft} is not a multiple of n1={n1}")
    n2 = n_fft // n1
    n_freqs = n_fft // 2 + 1
    w = padded_window(win_length, n_fft)

    n = np.arange(n_fft)
    n1_of, n2_of = n // n2, n % n2
    j = np.arange(n_fft)  # j = k1*n2 + n2
    k1_of_j, n2_of_j = j // n2, j % n2

    # M1[n, j] = win[n] · ω_{n1}^{n1(n)·k1(j)} · [n2(n) == n2(j)]
    ang1 = -2.0 * np.pi * np.outer(n1_of, k1_of_j) / n1
    delta1 = (n2_of[:, None] == n2_of_j[None, :]).astype(np.float64)
    m1c = (np.cos(ang1) * delta1 * w[:, None]).astype(dtype)
    m1s = (np.sin(ang1) * delta1 * w[:, None]).astype(dtype)

    # tw[j] = ω_N^{k1(j)·n2(j)}
    ang_t = -2.0 * np.pi * k1_of_j * n2_of_j / n_fft
    twc = np.cos(ang_t).astype(dtype)[None, :]
    tws = np.sin(ang_t).astype(dtype)[None, :]

    # M2[j, k] = ω_{n2}^{n2(j)·k2(k)} · [k1(k) == k1(j)], k = k2*n1 + k1
    k = np.arange(n_freqs)
    k1_of_k, k2_of_k = k % n1, k // n1
    ang2 = -2.0 * np.pi * np.outer(n2_of_j, k2_of_k) / n2
    delta2 = (k1_of_j[:, None] == k1_of_k[None, :]).astype(np.float64)
    m2c = (np.cos(ang2) * delta2).astype(dtype)
    m2s = (np.sin(ang2) * delta2).astype(dtype)
    return m1c, m1s, twc, tws, m2c, m2s
