"""The FFT plans of launches A and C (csrc/frontend_kernel.cu:
spectral_fft_kernel, contrast_fft_kernel) on the CPU.

The kernels run only on the card (chip_smoke.py holds them there against
their plain versions and these models). Here their arithmetic's CPU models,
`power_mel_fft_reference` and `spectral_contrast_fft_reference` (the same
packing, Stockham stages, twiddle table and post-twiddles in torch ops),
are held against float64 `numpy.fft.rfft` of the same windowed frames,
against the plain versions, and, through the whole feature stack, against
the JAX package's Pallas kernel in interpret mode on the configs the plans
take. Bluestein's stage (a prime factor past the cap) against float64
`numpy.fft.fft`, and the kernel's own FFT stages, built for the host with
g++ from the kernel source and run by 256 threads that meet at a barrier
as a block's do, against float64 `numpy.fft.fft` and the models; the
contrast plan's band stage (`band_value_sorted`, and `block_tails` for a band
past `kWideBand`) built so too, warps' shuffles and ballots emulated,
against the stable-rank tails. Then the
plan rule (the Python mirror, and the C rule itself built with g++ from
the kernel source where g++ is found), the tables' layout and the custom
ops' fakes at the FFT geometry. Inputs are made from a seed with numpy.
Budget: 1e-3 max-relative (docs/PARITY.md).
"""

import dataclasses
import shutil
import subprocess

import numpy as np
import pytest
import torch

from cough_detector_tpu.config import FeatureConfig as JaxFeatureConfig
from cough_detector_tpu.ops import frontend as jax_frontend
from cough_detector_tpu.ops.pallas import frontend_kernel as jax_kernel
from cough_detector_tpu_torch.config import FeatureConfig
from cough_detector_tpu_torch.ops import filters, frontend, frontend_kernel
from cough_detector_tpu_torch.utils import kernel_build
from test_torch_frontend import _rel

TOL = 1e-3
CONTRAST = dict(use_spectral_contrast=True)
NFFT2048 = dict(n_fft=2048, win_length=2048, hop_length=512, n_mels=128, f_max=8000.0)
NFFT1024 = dict(n_fft=1024, win_length=1024, hop_length=256, n_mels=128, f_max=8000.0)
NFFT4096 = dict(n_fft=4096, win_length=4096, hop_length=1024, n_mels=128, f_max=8000.0)
SR44K = dict(sample_rate=44100, hop_length=441, n_mels=128, f_max=22050.0)  # a 10 ms hop at 44.1 kHz
# chip_smoke.py's coverage_configs, by name, and what launch A's plan and
# the contrast launch's plan are for each (0 GEMM unstaged, 1 GEMM staged,
# 2 FFT; contrast 0-3 the GEMM's LayoutC levels, 4 FFT).
COVERAGE = {
    "mels160": (dict(n_mels=160, f_max=8000.0), 2, None),
    "mels256": (dict(n_mels=256, f_max=8000.0), 2, None),
    "nfft2048": (NFFT2048, 2, None),
    "librosa22k": (dict(NFFT2048, sample_rate=22050, f_max=11025.0), 2, None),
    "clip5s_128": (dict(segment_duration=5.0, n_mels=128, f_max=8000.0), 1, None),
    "clip10s": (dict(segment_duration=10.0), 1, None),
    "hop4": (dict(hop_length=4), 1, None),
    "nfft1024_contrast": (dict(NFFT1024, **CONTRAST), 2, 4),
    "nfft2048_contrast": (dict(NFFT2048, **CONTRAST), 2, 4),
    "bands17": (dict(n_contrast_bands=17, **CONTRAST), 1, 0),
    "clip60s_128_all_flags": (dict(segment_duration=60.0, n_mels=128, f_max=8000.0, use_pcen=True,
                                   use_pre_emphasis=True, use_delta_delta=True, **CONTRAST), 1, 2),
    "hop4_contrast": (dict(hop_length=4, **CONTRAST), 1, 0),
    "nfft4096_contrast": (dict(NFFT4096, **CONTRAST), 2, 4),
    "nfft2000_contrast": (dict(n_fft=2000, win_length=2000, hop_length=500, n_mels=128, f_max=8000.0, **CONTRAST),
                          2, 4),
    "nfft3000_contrast": (dict(n_fft=3000, win_length=3000, hop_length=750, n_mels=128, f_max=8000.0, **CONTRAST),
                          2, 4),
    "nfft768_mels256": (dict(n_fft=768, win_length=768, hop_length=192, n_mels=256, f_max=8000.0), 2, None),
    "nfft1792_contrast": (dict(n_fft=1792, win_length=1792, hop_length=448, n_mels=128, f_max=8000.0, **CONTRAST),
                          2, 4),
    "nfft2744_contrast": (dict(n_fft=2744, win_length=2744, hop_length=686, n_mels=128, f_max=8000.0, **CONTRAST),
                          2, 4),
    "nfft896_mels256": (dict(n_fft=896, win_length=896, hop_length=224, n_mels=256, f_max=8000.0), 2, None),
    "nfft1760_contrast": (dict(n_fft=1760, win_length=1760, hop_length=440, n_mels=128, f_max=8000.0, **CONTRAST),
                          2, 4),
    "nfft2662_contrast": (dict(n_fft=2662, win_length=2662, hop_length=665, n_mels=128, f_max=8000.0, **CONTRAST),
                          2, 4),
    "nfft880_mels256": (dict(n_fft=880, win_length=880, hop_length=220, n_mels=256, f_max=8000.0), 2, None),
    "sr44k_nfft1764_contrast": (dict(SR44K, n_fft=1764, win_length=1764, **CONTRAST), 2, 4),
    "sr44k_nfft882": (dict(SR44K, n_fft=882, win_length=882), 2, None),
    "sr44k_nfft1323": (dict(SR44K, n_fft=1323, win_length=1323), 2, None),
    "sr44k_nfft1323_contrast": (dict(SR44K, n_fft=1323, win_length=1323, **CONTRAST), 2, 4),
    "sr44k_nfft2205_contrast": (dict(SR44K, n_fft=2205, win_length=2205, **CONTRAST), 2, 4),
    "nfft1125": (dict(n_fft=1125, win_length=1125, hop_length=281, n_mels=128, f_max=8000.0), 2, None),
    "nfft1664_contrast": (dict(n_fft=1664, win_length=1664, hop_length=416, n_mels=128, f_max=8000.0, **CONTRAST),
                          2, 4),
    "nfft2704_contrast": (dict(n_fft=2704, win_length=2704, hop_length=676, n_mels=128, f_max=8000.0, **CONTRAST),
                          2, 4),
    "nfft832_mels256": (dict(n_fft=832, win_length=832, hop_length=208, n_mels=256, f_max=8000.0), 2, None),
    "sr44k_nfft1365": (dict(SR44K, n_fft=1365, win_length=1365), 2, None),
    "nfft2096_contrast": (dict(n_fft=2096, win_length=2096, hop_length=524, n_mels=128, f_max=8000.0, **CONTRAST),
                          2, 4),
    "nfft2192_contrast": (dict(n_fft=2192, win_length=2192, hop_length=548, n_mels=128, f_max=8000.0, **CONTRAST),
                          2, 4),
    "nfft5296_contrast": (dict(n_fft=5296, win_length=5296, hop_length=1324, n_mels=128, f_max=8000.0, **CONTRAST),
                          2, 4),
    "nfft6144_contrast": (dict(n_fft=6144, win_length=6144, hop_length=1536, n_mels=128, f_max=8000.0, **CONTRAST),
                          2, 4),
    "nfft6544_contrast": (dict(n_fft=6544, win_length=6544, hop_length=1636, n_mels=128, f_max=8000.0, **CONTRAST),
                          2, 4),
    "nfft1987_contrast": (dict(n_fft=1987, win_length=1987, hop_length=496, n_mels=128, f_max=8000.0, **CONTRAST),
                          2, 4),
    "sr44k_nfft8192_contrast": (dict(SR44K, n_fft=8192, win_length=8192, hop_length=2048, **CONTRAST), 2, 4),
    "nfft4608_bands8_contrast": (dict(n_fft=4608, win_length=4608, hop_length=1152, n_mels=128, f_max=8000.0,
                                      n_contrast_bands=8, **CONTRAST), 2, 4),
    "nfft2192_mels256": (dict(n_fft=2192, win_length=2192, hop_length=548, n_mels=256, f_max=8000.0), 2, None),
    "nfft1048_mels256": (dict(n_fft=1048, win_length=1048, hop_length=262, n_mels=256, f_max=8000.0), 2, None),
    "sr44k_nfft1965_mels256": (dict(SR44K, n_fft=1965, win_length=1965, n_mels=256), 2, None),
    "hop400_contrast": (dict(hop_length=400, **CONTRAST), 0, 1),
    "nfft2129_mels256_contrast": (dict(n_fft=2129, win_length=2129, hop_length=532, n_mels=256, f_max=8000.0,
                                       **CONTRAST), 0, 3),
    "clip10s_pcen_dd20": (dict(segment_duration=10.0, use_pcen=True, use_delta_delta=True, n_mfcc=20), 1, None),
    "clip10s_mels40_mfcc36_dd": (dict(segment_duration=10.0, n_mels=40, n_mfcc=36, use_delta_delta=True), 1, None),
    "clip120s_128_pcen_dd": (dict(segment_duration=120.0, n_mels=128, f_max=8000.0, use_pcen=True,
                                  use_delta_delta=True), 1, None),
    "shipped": ({}, 1, None),
    "shipped_contrast": (dict(CONTRAST), 1, 0),
}
JAX_STACK = ("nfft2048", "librosa22k", "nfft2048_contrast", "nfft4096_contrast", "nfft2000_contrast",
             "nfft3000_contrast", "nfft768_mels256", "nfft1792_contrast", "nfft896_mels256", "sr44k_nfft1764_contrast",
             "nfft880_mels256", "nfft1760_contrast", "nfft832_mels256", "sr44k_nfft1365", "nfft2192_mels256",
             "nfft2192_contrast", "sr44k_nfft1965_mels256", "nfft4608_bands8_contrast")
# Launch A's FFT layout takes one block an SM on these (its frames and span,
# or Bluestein's tables and rows of 3993 points, past half an SM's shared
# memory).
ONE_BLOCK_A = ("sr44k_nfft8192_contrast", "nfft1987_contrast")
# The JAX Pallas kernel refuses an odd n_fft whose hop divides the segment
# (its frames are a sample short): these take the JAX jnp chain.
JAX_CHAIN = ("sr44k_nfft1365", "sr44k_nfft1965_mels256")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Small tensors: one intra-op thread, restored after the module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(name: str) -> FeatureConfig:
    return FeatureConfig(**COVERAGE[name][0])


def _waves(cfg: FeatureConfig, n: int, seed: int) -> np.ndarray:
    """Noise with a decaying tone burst a clip, from a seed."""
    rng = np.random.default_rng(seed)
    s = cfg.segment_samples
    t = np.arange(s) / cfg.sample_rate
    w = rng.standard_normal((n, s)) * 0.02
    for i in range(n):
        t0 = rng.uniform(0.0, t[-1] / 2)
        burst = np.sin(2 * np.pi * rng.uniform(200, 3000) * t) * np.exp(-np.clip(t - t0, 0, None) / 0.1)
        w[i] += rng.uniform(0.2, 0.8) * burst * (t >= t0)
    return w.astype(np.float32)


def _frames64(w: np.ndarray, cfg: FeatureConfig, pre: bool) -> np.ndarray:
    """(B, T, n_fft) float64 frames: pre-emphasis, reflect pad, hop."""
    x = w.astype(np.float64)
    if pre:
        x = np.concatenate([x[:, :1], x[:, 1:] - cfg.pre_emphasis_coef * x[:, :-1]], axis=1)
    half = cfg.n_fft // 2
    x = np.pad(x, ((0, 0), (half, half)), mode="reflect")
    idx = np.arange(cfg.num_frames)[:, None] * cfg.hop_length + np.arange(cfg.n_fft)[None, :]
    return x[:, idx]


@pytest.mark.parametrize("name, pre", [
    ("nfft2048", False), ("librosa22k", False), ("mels256", False), ("nfft1024_contrast", True),
    ("nfft4096_contrast", False), ("nfft2000_contrast", False), ("nfft3000_contrast", True), ("nfft768_mels256", False),
    ("nfft896_mels256", False), ("sr44k_nfft882", True), ("sr44k_nfft1764_contrast", False),
    ("nfft880_mels256", False), ("sr44k_nfft1323", True), ("nfft1125", False), ("nfft832_mels256", False),
    ("sr44k_nfft1365", True), ("nfft2192_mels256", False), ("nfft1048_mels256", True), ("sr44k_nfft1965_mels256", False),
])
def test_power_mel_fft_model_vs_float64_rfft(name, pre):
    """Launch A's FFT plan's model against the float64 rfft power and mel
    of the same windowed frames, and against the plain version: on an odd
    n_fft two frames through one FFT, 57 frames at n_fft 1125 (its last
    with zeros)."""
    cfg = dataclasses.replace(_cfg(name), use_spectral_contrast=False, use_pre_emphasis=pre)
    w = _waves(cfg, 2, seed=21)
    spec = np.fft.rfft(_frames64(w, cfg, pre) * filters.padded_window(cfg.win_length, cfg.n_fft), axis=-1)
    fb = filters.mel_filterbank(cfg.n_fft // 2 + 1, cfg.n_mels, cfg.sample_rate, cfg.f_min, cfg.f_max)
    want = ((spec.real**2 + spec.imag**2) @ fb.astype(np.float64)).transpose(0, 2, 1)
    got = frontend_kernel.power_mel_fft_reference(torch.from_numpy(w), cfg).numpy()
    assert got.shape == want.shape == (2, cfg.n_mels, cfg.num_frames)
    assert _rel(got, want) < 2e-6
    plain = frontend_kernel.power_mel_reference(torch.from_numpy(w), cfg).numpy()
    assert _rel(got, plain) < 2e-6


@pytest.mark.parametrize("name", [
    "nfft1024_contrast", "nfft2048_contrast", "nfft4096_contrast", "nfft2000_contrast", "nfft3000_contrast",
    "nfft1792_contrast", "nfft2744_contrast", "sr44k_nfft1764_contrast", "nfft1760_contrast", "nfft2662_contrast",
    "sr44k_nfft1323_contrast", "sr44k_nfft2205_contrast", "nfft1664_contrast", "nfft2704_contrast",
    "nfft2096_contrast", "nfft2192_contrast", "nfft5296_contrast", "nfft6144_contrast", "sr44k_nfft8192_contrast",
    "nfft4608_bands8_contrast",
])
def test_contrast_fft_model_vs_float64_rfft(name):
    """The contrast launch's FFT plan's model (both windows through one
    complex FFT, split by conjugate symmetry) against the contrast rows of
    the float64 rfft spectra of each window, and against the plain
    version."""
    cfg = _cfg(name)
    w = _waves(cfg, 2, seed=22)
    frames = _frames64(w, cfg, pre=False)
    spec = np.fft.rfft(frames * filters.padded_window(cfg.win_length, cfg.n_fft), axis=-1)
    mag = np.abs(np.fft.rfft(frames * filters.padded_window(cfg.n_fft, cfg.n_fft), axis=-1))
    want = frontend.contrast_from_spectra(
        torch.from_numpy(spec.real**2 + spec.imag**2), torch.from_numpy(mag), cfg, tails="rank"
    ).numpy().transpose(0, 2, 1)
    got = frontend_kernel.spectral_contrast_fft_reference(torch.from_numpy(w), cfg).numpy()
    assert got.shape == want.shape == (2, cfg.n_contrast_bands + 1, cfg.num_frames)
    assert _rel(got, want) < 1e-5
    plain = frontend_kernel.spectral_contrast_reference(torch.from_numpy(w), cfg).numpy()
    assert _rel(got, plain) < 1e-5


@pytest.mark.parametrize("n_fft, points", [
    (64, 32), (512, 256), (1024, 1024), (2048, 1024), (4096, 4096), (4096, 2048), (2000, 1000), (2000, 2000),
    (3000, 1500), (3000, 3000), (768, 384), (768, 768), (1000, 500),
    (896, 448), (1792, 1792), (2744, 1372), (2744, 2744), (882, 441), (1764, 882), (1764, 1764),
    (880, 440), (1760, 880), (1760, 1760), (2662, 1331), (2662, 2662), (1323, 1323), (2205, 2205), (1125, 1125),
])
def test_stockham_stages_are_the_fft(n_fft, points):
    """The plans' stages for points = 2^a 3^b 5^c 7^d 11^e (one of radix 2
    when a is odd, then radix 4, then the 3s, the 5s, the 7s and the 11s)
    with the table of w = e^{-2 pi i / n_fft} make the FFT of n_fft / 2
    points (launch A on an even n_fft; an odd count, 441, at n_fft 882) and
    of n_fft points (launch C, and launch A on an odd n_fft). The table
    holds w^k for k up to n_fft / 2; past it the stages read the conjugate
    of entry n_fft - k, for an odd n_fft as for an even one."""
    rng = np.random.default_rng(points)
    z = rng.standard_normal((3, points)) + 1j * rng.standard_normal((3, points))
    tw = frontend_kernel._twiddles(n_fft)
    re, im = frontend_kernel._stockham(
        torch.from_numpy(z.real.astype(np.float32)), torch.from_numpy(z.imag.astype(np.float32)),
        torch.from_numpy(tw), n_fft,
    )
    a, b, c, d, e = (next(e for e in range(14) if points % f ** (e + 1)) for f in (2, 3, 5, 7, 11))
    assert points == 2**a * 3**b * 5**c * 7**d * 11**e
    assert frontend_kernel._fft_radices(points) == (
        [2] * (a % 2) + [4] * (a // 2) + [3] * b + [5] * c + [7] * d + [11] * e
    )
    assert _rel(re.numpy() + 1j * im.numpy(), np.fft.fft(z, axis=-1)) < 1e-6
    k = np.arange(n_fft // 2 + 1, n_fft)  # the conjugate rule: w^k = conj w^(n_fft - k)
    w = np.exp(-2j * np.pi * k / n_fft)
    np.testing.assert_allclose(tw[n_fft - k, 0] - 1j * tw[n_fft - k, 1], w, rtol=0, atol=1e-7)


# The generic prime stage (fft_stage_prime): (n_fft, points) with a prime
# factor past 11, the four configs it took from the GEMM among them (832
# and 1365 for launch A, 1664 and 2704 for launch C), and the largest
# prime the plans take (the cap) alone and beside 2s.
PRIME_POINTS = [
    (26, 13), (52, 26), (338, 169), (416, 208), (832, 416), (1365, 1365), (1664, 832), (1664, 1664), (2704, 1352),
    (2704, 2704), (2 * frontend_kernel._FFT_MAX_PRIME, frontend_kernel._FFT_MAX_PRIME),
    (16 * frontend_kernel._FFT_MAX_PRIME, 16 * frontend_kernel._FFT_MAX_PRIME), (2 * 3 * 17 * 19, 3 * 17 * 19),
]


@pytest.mark.parametrize("n_fft, points", PRIME_POINTS)
def test_prime_stages_are_the_fft(n_fft, points):
    """With a prime factor P past 11, the stages end in one of radix P for
    each such factor, smallest first (fft_stage_prime: the twiddled points
    summed in pairs, each output pair a sum over them with powers of w_P
    from the twiddle table), and make the FFT of the points against
    float64 `numpy.fft.fft`."""
    rng = np.random.default_rng(points)
    z = rng.standard_normal((3, points)) + 1j * rng.standard_normal((3, points))
    tw = frontend_kernel._twiddles(n_fft)
    re, im = frontend_kernel._stockham(
        torch.from_numpy(z.real.astype(np.float32)), torch.from_numpy(z.imag.astype(np.float32)),
        torch.from_numpy(tw), n_fft,
    )
    radices = frontend_kernel._fft_radices(points)
    big = [r for r in radices if r > 11]
    assert big and big == sorted(big) and radices[-len(big):] == big and np.prod(radices) == points
    assert _rel(re.numpy() + 1j * im.numpy(), np.fft.fft(z, axis=-1)) < 1e-6


# Bluestein's stage (fft_stage_bluestein): (n_fft, points) with a prime
# factor past the cap, the four configs it takes from the GEMM among them
# (2096 and 2192 for both launches, 1048 and the odd 1965 for launch A),
# the first prime past the cap alone, and 509 (m = 1029 = 3 7^3).
BLUESTEIN_POINTS = [
    (262, 131), (274, 137), (1018, 509), (2096, 1048), (2096, 2096), (2192, 1096), (2192, 2192), (1048, 524),
    (1965, 1965), (4112, 2056),
]


@pytest.mark.parametrize("n_fft, points", BLUESTEIN_POINTS)
def test_bluestein_stage_is_the_fft(n_fft, points):
    """With a prime factor P past the cap, the stages begin with Bluestein's
    (the points times the chirp, zero-padded to m, FFT_m, times
    B^ and conjugated, FFT_m, the conjugate times the chirp), m the
    smallest odd 11-smooth count from 2P - 1, and make the FFT of the
    points against float64 `numpy.fft.fft`; so does the stage alone on P
    points."""
    rng = np.random.default_rng(points)
    z = rng.standard_normal((3, points)) + 1j * rng.standard_normal((3, points))
    tables = frontend_kernel._fft_tables(n_fft)
    big = frontend_kernel._bluestein_prime(n_fft)
    m = frontend_kernel._bluestein_points(big)
    assert big > frontend_kernel._FFT_MAX_PRIME and m % 2 == 1 and m >= 2 * big - 1
    assert frontend_kernel._smooth11(m) and not any(frontend_kernel._smooth11(k) for k in range(2 * big - 1, m, 2))
    assert tables.shape == (n_fft // 2 + 1 + big + 2 * m - 1, 2)
    radices = frontend_kernel._fft_radices(points)
    assert radices[0] == big and max(radices[1:], default=1) <= frontend_kernel._FFT_MAX_PRIME
    re, im = frontend_kernel._stockham(
        torch.from_numpy(z.real.astype(np.float32)), torch.from_numpy(z.imag.astype(np.float32)),
        torch.from_numpy(tables), n_fft,
    )
    assert _rel(re.numpy() + 1j * im.numpy(), np.fft.fft(z, axis=-1)) < 1e-6
    x = z[:, :big]
    yr, yi = frontend_kernel._bluestein(list(torch.from_numpy(x.real.astype(np.float32)).unbind(-1)),
                                        list(torch.from_numpy(x.imag.astype(np.float32)).unbind(-1)))
    got = torch.stack(yr, -1).numpy() + 1j * torch.stack(yi, -1).numpy()
    assert _rel(got, np.fft.fft(x, axis=-1)) < 1e-6


def test_bluestein_tables_layout():
    """Bluestein's tables, after the twiddles: the chirp e^{-pi i s^2 / P}
    (its angle from s^2 mod 2P), B^ = FFT_m(b) / m of the wrapped conjugate
    chirp, each float64 rounded once, and the FFT_m stages' twiddles
    (`_blue_radices`; m - 1: for the stage of radix R at ns, w_{ns R}^{r k}
    at k (R - 1) + r - 1), each the m-point table's entry that `_stockham` reads; the
    convolution they make is the DFT."""
    for p in (131, 137, 509):
        m = frontend_kernel._bluestein_points(p)
        t = frontend_kernel._bluestein_tables(p).astype(np.float64)
        c = t[:p, 0] + 1j * t[:p, 1]
        s = np.arange(p)
        np.testing.assert_allclose(c, np.exp(-1j * np.pi * s**2 / p), rtol=0, atol=1e-6)
        b = np.zeros(m, complex)
        b[:p], b[m - s[1:]] = np.conj(c), np.conj(c[1:])
        np.testing.assert_allclose(t[p : p + m, 0] + 1j * t[p : p + m, 1], np.fft.fft(b) / m, rtol=0, atol=1e-6)
        half, at, ns = frontend_kernel._twiddles(m), p + m, 1
        assert t.shape == (p + 2 * m - 1, 2)
        for r in frontend_kernel._blue_radices(m):
            for k in range(ns):
                for j in range(1, r):
                    idx = j * k * (m // (ns * r))
                    want = half[idx] if 2 * idx <= m else half[m - idx] * np.array([1, -1], np.float32)
                    np.testing.assert_array_equal(t[at + k * (r - 1) + j - 1], want)
                    assert abs(complex(*t[at + k * (r - 1) + j - 1]) - np.exp(-2j * np.pi * idx / m)) < 1e-6
            at, ns = at + ns * (r - 1), ns * r
        assert at == t.shape[0] and ns == m
        x = np.random.default_rng(p).standard_normal(p)
        a = np.fft.fft(np.concatenate([x * c, np.zeros(m - p)]))
        y = np.fft.ifft(a * (t[p : p + m, 0] + 1j * t[p : p + m, 1]) * m)[:p] * c
        assert _rel(y, np.fft.fft(x)) < 1e-5


def test_fft_radices_refuse_other_primes():
    """The stage lists the kernels have: every prime up to the cap
    (_FFT_MAX_PRIME, the C source's kFftMaxPrime) by fft_stage_prime, one
    prime past it by Bluestein's stage, first; none for two primes past the cap
    or a prime whose Bluestein convolution passes a pass of its scratch
    (4096 points), and the plan rule sends such an n_fft to the GEMM."""
    cap = frontend_kernel._FFT_MAX_PRIME
    past = next(n for n in range(cap + 1, 2 * cap + 2) if frontend_kernel._prime_factors(n) == [n])
    for p in (13, 17, 19, 23, cap, past, 509, 1997):
        assert frontend_kernel._fft_radices(p) == [p]
        assert frontend_kernel._fft_radices(2 * p) == ([p, 2] if p > cap else [2, p])
    assert frontend_kernel._bluestein_points(1997) == 3993 and frontend_kernel._bluestein_points(1999) == 4125
    for points in (past * 137, 1999, 2 * 1999, 3 * 5 * 4099):
        with pytest.raises(ValueError):
            frontend_kernel._fft_radices(points)
    for n_fft in (1999, 2 * 1999, 4 * 1999, 2 * 4099):
        assert not frontend_kernel._fft_fits(n_fft, frontend_kernel._spectral_points(n_fft))
    assert frontend_kernel._fft_fits(2 * 1997, 1997)


@pytest.mark.parametrize("name", JAX_STACK)
def test_feature_stack_through_the_fft_models_matches_jax(name):
    """The whole feature image as the card computes it on these configs
    (launch A's FFT model, launch B's plain version, and the contrast
    launch's FFT model on contrast configs) against the JAX package's
    launcher with its Pallas kernel in interpret mode (the jnp chain for
    JAX_CHAIN), at B = 2."""
    cfg = _cfg(name)
    base = dataclasses.replace(cfg, use_spectral_contrast=False)
    assert frontend_kernel.spectral_plan(base) == frontend_kernel.PLAN_FFT
    w = _waves(cfg, 2, seed=23)
    t = torch.from_numpy(w)
    got = frontend_kernel.mel_epilogue_reference(frontend_kernel.power_mel_fft_reference(t, base), base)
    if cfg.use_spectral_contrast:
        assert frontend_kernel.contrast_level(cfg) == frontend_kernel.CONTRAST_FFT
        got = torch.cat([got, frontend_kernel.spectral_contrast_fft_reference(t, cfg)], dim=1)
    jcfg = JaxFeatureConfig(**COVERAGE[name][0])
    if name in JAX_CHAIN:
        want = np.asarray(jax_frontend.extract_features(w, jcfg))
    else:
        want = np.asarray(jax_kernel.extract_features_fused(w, jcfg, interpret=True))
    assert got.shape == want.shape == (2, cfg.num_features, cfg.num_frames)
    assert _rel(got.numpy(), want) < TOL


@pytest.mark.parametrize("name", list(COVERAGE))
def test_plan_mirror(name):
    """Each coverage config's plans, from the config alone: the shipped
    config and everything off an n_fft from 640 (or past 128 mels for
    launch A) whose largest prime factor is at most the cap on the GEMM,
    the rest on the FFT; the FFT layouts fit a
    block, two blocks an SM (launch A one past n_fft 4096 where
    ONE_BLOCK_A says so), and launch C's frames a block are a power of
    two."""
    cfg = _cfg(name)
    base = dataclasses.replace(cfg, use_spectral_contrast=False)
    plan_a, plan_c = COVERAGE[name][1:]
    assert frontend_kernel.spectral_plan(base) == plan_a
    smem = frontend_kernel.spectral_smem_bytes(base)
    if plan_a == frontend_kernel.PLAN_FFT:
        frames = frontend_kernel.spectral_fft_frames(base)
        assert frames * cfg.n_fft // 2 <= 8192 and (name in ONE_BLOCK_A) == (2 * (smem + 1024) > 233472)
        assert smem <= 232448
    else:
        assert smem == frontend_kernel._ring_bytes(
            frontend_kernel._span_floats(cfg.hop_length, frontend_kernel._support(cfg)[2]) if plan_a else 0
        )
    if plan_c is not None:
        assert frontend_kernel.contrast_level(cfg) == plan_c
        assert frontend_kernel.contrast_smem_bytes(cfg) <= 232448
        if plan_c == frontend_kernel.CONTRAST_FFT:
            frames = frontend_kernel._fft_layout(cfg.n_fft, cfg.n_fft, cfg.hop_length,
                                                 frontend_kernel._geometry(cfg).n_pow, contrast=True)[0]
            assert frames & (frames - 1) == 0 and frames * cfg.n_fft <= 8192


def test_shipped_config_keeps_its_gemm_plans():
    """The shipped config (n_fft 512, 64 mels) keeps its GEMM plans, staged,
    and so does an n_fft that the FFT plans do not fit: one with a prime
    factor past 1997 (its Bluestein convolution passes a pass of the
    scratch: 3821, 2 x 4049), or past a block's points (launch A past
    16384, launch C past 8192). An n_fft with a prime factor past the cap (_FFT_MAX_PRIME)
    that fits takes the FFT plans: 131 ms at 16 kHz, 137 ms on 256 mels,
    an odd 3 x 5 x 131 at 44.1 kHz."""
    shipped = FeatureConfig()
    assert frontend_kernel.spectral_plan(shipped) == frontend_kernel.PLAN_GEMM_STAGED
    assert frontend_kernel.contrast_level(FeatureConfig(use_spectral_contrast=True)) == 0
    assert frontend_kernel._FFT_MAX_PRIME < 131
    for kw in (dict(n_fft=2096, win_length=2096, hop_length=524), dict(n_fft=2192, n_mels=256, f_max=8000.0),
               dict(n_fft=1965, win_length=1965, hop_length=441, sample_rate=44100, n_mels=256, f_max=8000.0)):
        cfg = FeatureConfig(use_spectral_contrast=True, **kw)
        assert frontend_kernel._bluestein_prime(cfg.n_fft) > frontend_kernel._FFT_MAX_PRIME
        assert frontend_kernel.spectral_plan(cfg) == frontend_kernel.PLAN_FFT
        assert frontend_kernel.contrast_level(cfg) == frontend_kernel.CONTRAST_FFT
    for n_fft, fft_a in ((3821, False), (2 * 4049, False), (8200, True), (16400, False)):
        assert frontend_kernel._spectral_fft(n_fft, n_fft // 4, 256) == fft_a, n_fft
        assert not frontend_kernel._contrast_fft(n_fft, n_fft // 4, 0)[0], n_fft  # even with no power rows


def _c_plan_rules():
    """The plan rules of csrc/frontend_kernel.cu, built for the host with
    g++ (its layouts and plans are plain C++): a program that reads
    "a n_fft hop kpad n_mels n_pow n_frames n_bands" lines and prints
    plan_a, its shared memory, plan_c, its shared memory, and LayoutF's
    frames for each launch; "b n_frames n_mels n_mfcc use_pcen
    delta_delta" lines, for which it prints launch B's plan_b, its shared
    memory a block and its threads a block; and "f n_fft hop n_mels n_pow"
    lines, for which it prints the n_fft's largest prime factor, whether
    plan_a and plan_c take their FFT plans, and LayoutF's frames and bytes
    for each launch."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is not installed")
    src = (kernel_build._CSRC / "frontend_kernel.cu").read_text()

    def between(a, b):
        i = src.index(a)
        return src[i : src.index(b, i)]

    code = "\n".join([
        "#include <cstddef>\n#include <cstdio>\n#include <cstdint>\n#define __host__\n#define __device__",
        between("constexpr int kWarpsA", "// Launch A's shared memory, in floats"),
        between("struct LayoutA {", "// x rounded to TF32"),
        between("struct LayoutC {", "__device__ __forceinline__ float warp_sum"),
        between("// The largest prime factor of n (n >= 1", "__device__ __forceinline__ float2 cmul"),
        r"""int main() {
  int n_fft, hop, kpad, n_mels, n_pow, n_frames, n_bands;
  char kind;
  while (scanf(" %c", &kind) == 1) {
    if (kind == 'f') {
      int P;
      if (scanf("%d %d %d %d", &n_fft, &hop, &n_mels, &P) != 4) return 1;
      const LayoutF fa(n_fft, hop), fc(n_fft, hop, P);
      printf("%d %d %d %d %zu %d %zu\n", largest_prime(n_fft), plan_a(n_fft, hop, 16, n_mels) == kPlanFft,
             plan_c(n_fft, hop, 16, P, 1, 6) == kPlanCFft, fa.frames, fa.bytes(), fc.frames, fc.bytes());
      continue;
    }
    if (kind == 'b') {
      int T, M, C, pcen, dd;
      if (scanf("%d %d %d %d %d", &T, &M, &C, &pcen, &dd) != 5) return 1;
      const int n = plan_b(T, M, C, pcen, dd);
      printf("%d %zu %d\n", n, smem_b(T, M, C, pcen, dd), threads_b(n));
      continue;
    }
    if (scanf("%d %d %d %d %d %d %d", &n_fft, &hop, &kpad, &n_mels, &n_pow, &n_frames, &n_bands) != 7) return 1;
    const int a = plan_a(n_fft, hop, kpad, n_mels), c = plan_c(n_fft, hop, kpad, n_pow, n_frames, n_bands);
    const size_t sa = a == kPlanFft ? LayoutF(n_fft, hop).bytes() : LayoutA(hop, kpad, a == kPlanGemmStaged).bytes(2);
    const size_t sc = c == kPlanCFft ? LayoutF(n_fft, hop, n_pow).bytes()
                                     : LayoutC(hop, kpad, n_pow, n_frames, n_bands + 1).bytes(2);
    printf("%d %zu %d %zu %d %d\n", a, sa, c, sc, LayoutF(n_fft, hop).frames, LayoutF(n_fft, hop, n_pow).frames);
  }
}""",
    ])
    return gxx, code


def test_plan_mirrors_equal_the_c_rules(tmp_path):
    """Launch A's and the contrast launch's plans and shared memory, from
    the Python mirrors, equal the kernel source's own rules (compiled for
    the host) over a grid of configs: n_fft from 256 to 4096, powers of two,
    other even 5-smooth counts (640 to 3000), even ones with a factor of 7
    (672 to 2744) or of 11 (704 to 2662), odd ones (675 to 2205), ones
    with a factor of 13 (832 to 2704, odd 1365), now on the FFT plans, and
    ones with a prime factor past the cap (1048, 2096, 2192 and the odd
    1965: Bluestein's stage), and the prime 2129, past what Bluestein's
    scratch takes (the GEMM), hops from 4 to past n_fft,
    32 to 256 mels, 1 and 10 s clips, 6 and 17 bands; and so do LayoutF's
    frames a block for each launch, launch C's rounded down to a power of
    two (8 at n_fft 768, 4 at 1200), launch A's even on an odd n_fft (two
    frames a row)."""
    gxx, code = _c_plan_rules()
    (tmp_path / "plans.cpp").write_text(code)
    subprocess.run([gxx, "-std=c++17", "-O1", "-o", str(tmp_path / "plans"), str(tmp_path / "plans.cpp")], check=True)
    cfgs = [
        FeatureConfig(n_fft=n, win_length=min(win, n), hop_length=hop, n_mels=mels, f_max=8000.0,
                      segment_duration=dur, use_spectral_contrast=True, n_contrast_bands=bands)
        for n, win in ((256, 200), (512, 400), (768, 768), (1024, 1024), (1024, 400), (2048, 2048), (4096, 4096),
                       (640, 640), (1000, 1000), (1200, 1200), (2000, 2000), (3000, 3000), (1792, 1792), (1125, 1125),
                       (896, 896), (1764, 1764), (2744, 2744), (672, 672), (1760, 1760), (880, 880), (2662, 2662),
                       (1323, 1323), (2205, 2205), (704, 704), (675, 675), (693, 693), (832, 832), (1365, 1365),
                       (1664, 1664), (2704, 2704), (1048, 1048), (2096, 2096), (2192, 2192), (1965, 1965),
                       (2129, 2129))
        for hop in (4, 160, 512, 3000) for mels in (32, 128, 256) for dur in (1.0, 10.0) for bands in (6, 17)
        if not (hop == 4 and dur == 10.0)
    ]
    lines = []
    for c in cfgs:
        g = frontend_kernel._geometry(c)
        lines.append(f"a {c.n_fft} {c.hop_length} {frontend_kernel._support(c)[2]} {c.n_mels} {g.n_pow} "
                     f"{c.num_frames} {c.n_contrast_bands}")
        lines.append(f"a {c.n_fft} {c.hop_length} {g.kpad} {c.n_mels} {g.n_pow} {c.num_frames} {c.n_contrast_bands}")
    out = subprocess.run([str(tmp_path / "plans")], input="\n".join(lines), capture_output=True, text=True,
                         check=True).stdout.split("\n")
    seen, frames_c = set(), {}
    for i, c in enumerate(cfgs):
        a, sa, _, _, fa, _ = map(int, out[2 * i].split())
        _, _, cl, sc, _, fc = map(int, out[2 * i + 1].split())
        assert (a, sa) == (frontend_kernel.spectral_plan(c), frontend_kernel.spectral_smem_bytes(c)), c
        assert (cl, sc) == (frontend_kernel.contrast_level(c), frontend_kernel.contrast_smem_bytes(c)), c
        n_pow = frontend_kernel._geometry(c).n_pow
        assert fa == frontend_kernel._spectral_layout(c.n_fft, c.hop_length)[0], c
        assert fa % 2 == 0 or c.n_fft % 2 == 0, c
        assert fc == frontend_kernel._fft_layout(c.n_fft, c.n_fft, c.hop_length, n_pow, contrast=True)[0], c
        assert fc & (fc - 1) == 0, c
        seen.update({("a", a, c.n_fft), ("c", cl, c.n_fft)})
        frames_c.setdefault(c.n_fft, set()).add(fc)
    plans = {(x, plan) for x, plan, _ in seen}
    assert {("a", 0), ("a", 1), ("a", 2), ("c", 0), ("c", 1), ("c", 3), ("c", 4)} <= plans
    for n_fft in (1200, 2000, 3000):  # radix-3 and radix-5 stages
        assert ("a", 2, n_fft) in seen and ("c", 4, n_fft) in seen
    for n_fft in (640, 768, 1000):  # from kFftMinNfft (640) on
        assert ("a", 2, n_fft) in seen and ("c", 4, n_fft) in seen
    assert ("c", 4, 512) not in seen and ("a", 1, 512) in seen  # under it: the GEMM
    for n_fft in (672, 896, 1764, 1792, 2744):  # radix-7 stages
        assert ("a", 2, n_fft) in seen and ("c", 4, n_fft) in seen
    for n_fft in (704, 880, 1760, 2662, 693):  # radix-11 stages
        assert ("a", 2, n_fft) in seen and ("c", 4, n_fft) in seen
    for n_fft in (675, 693, 1125, 1323, 2205):  # an odd n_fft: launch A's two frames a row
        assert ("a", 2, n_fft) in seen and ("c", 4, n_fft) in seen
    for n_fft in (832, 1365, 1664, 2704):  # a factor of 13: fft_stage_prime
        assert ("a", 2, n_fft) in seen and ("c", 4, n_fft) in seen
    for n_fft in (1048, 2096, 2192, 1965):  # a prime factor past the cap: Bluestein's stage
        assert ("a", 2, n_fft) in seen and ("c", 4, n_fft) in seen
    assert not {("a", 2, 2129), ("c", 4, 2129)} & seen  # nothing fits: the GEMM
    assert max(frames_c[768]) == 8 and max(frames_c[1200]) == 4


def test_fft_plan_rule_over_every_n_fft(tmp_path):
    """For every n_fft from 64 to 8192, at hop n_fft / 4 and 160, on 128
    and 256 mels: the n_fft's largest prime factor, whether launches A and
    C take their FFT plans, and LayoutF's frames and bytes for each launch,
    from the Python mirrors, equal the kernel source's own rules (compiled
    for the host); no n_fft from 640 whose rows, Bluestein scratch and
    tables fit a block takes a GEMM plan, and every one whose largest prime
    factor is at most the cap (kFftMaxPrime, _FFT_MAX_PRIME), or past it
    up to 1997, fits."""
    gxx, code = _c_plan_rules()
    (tmp_path / "plans.cpp").write_text(code)
    subprocess.run([gxx, "-std=c++17", "-O1", "-o", str(tmp_path / "plans"), str(tmp_path / "plans.cpp")], check=True)
    cases = [(n, hop, mels, n // 4 + 1) for n in range(64, 8193) for hop in (max(n // 4, 1), 160) for mels in (128, 256)]
    out = subprocess.run([str(tmp_path / "plans")], input="\n".join(f"f {n} {h} {m} {p}" for n, h, m, p in cases),
                         capture_output=True, text=True, check=True).stdout.split("\n")
    cap, fk = frontend_kernel._FFT_MAX_PRIME, frontend_kernel
    taken = 0
    for (n, hop, mels, n_pow), line in zip(cases, out):
        got = tuple(map(int, line.split()))
        fa, fc = fk._spectral_layout(n, hop), fk._fft_layout(n, n, hop, n_pow, contrast=True)
        want = (fk._largest_prime(n), int(fk._spectral_fft(n, hop, mels)), int(fk._contrast_fft(n, hop, n_pow)[0]),
                *fa, *fc)
        assert got == want, (n, hop, mels, got, want)
        fits = (fk._fft_fits(n, fk._spectral_points(n)) and got[4] <= 232448,
                fk._fft_fits(n, n) and got[6] <= 232448)
        if n >= 640 or mels > 128:
            assert got[1] == int(fits[0]), (n, hop, mels, got)
        if n >= 640:
            assert got[2] == int(fits[1]), (n, hop, mels, got)
            taken += got[1]
        if got[0] <= 1997:
            assert fits[0] and (fits[1] or n > 8192 or got[0] > cap), (n, hop, mels, got)
    assert len(out) >= len(cases) and taken > 0


# The kernel source's FFT stages on the host: CUDA's names for g++, a
# block's threads as std::threads, its barrier and each warp's as a
# std::barrier.
HOST_PRELUDE = """\
#include <algorithm>
#include <barrier>
#include <cmath>
#include <cstddef>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <memory>
#include <thread>
#include <vector>
#define __host__
#define __device__
#define __forceinline__ inline
#define __noinline__ __attribute__((noinline))
struct float2 { float x, y; };
struct float4 { float x, y, z, w; };
inline float2 make_float2(float x, float y) { return {x, y}; }
inline float4 make_float4(float x, float y, float z, float w) { return {x, y, z, w}; }
struct Dim3 { unsigned x; };
thread_local Dim3 threadIdx;
std::barrier<>* block_barrier;
std::barrier<>* warp_barriers[8];
inline void __syncthreads() { block_barrier->arrive_and_wait(); }
inline void __syncwarp() { warp_barriers[threadIdx.x / 32]->arrive_and_wait(); }
std::barrier<>* named_barriers[16];
inline void bar_sync(int id, int) { named_barriers[id]->arrive_and_wait(); }
inline unsigned __umulhi(unsigned a, unsigned b) { return (unsigned)(((unsigned long long)a * b) >> 32); }
inline int __ffs(int x) { return __builtin_ffs(x); }
using std::min;
// A warp's lanes exchange 4-byte values through its slots, between two of
// its barriers: the shuffles, the ballot.
struct uint4 { unsigned x, y, z, w; };
struct int4 { int x, y, z, w; };
unsigned warp_slots[8][32];
template <class T> inline T lane_value(T v, int src) {
  static_assert(sizeof(T) == 4, "4-byte lanes");
  const int w = threadIdx.x / 32;
  std::memcpy(&warp_slots[w][threadIdx.x % 32], &v, 4);
  __syncwarp();
  T r;
  std::memcpy(&r, &warp_slots[w][src], 4);
  __syncwarp();
  return r;
}
template <class T> inline T __shfl_xor_sync(unsigned, T v, int m) { return lane_value(v, (threadIdx.x % 32) ^ m); }
template <class T> inline T __shfl_sync(unsigned, T v, int src) { return lane_value(v, src); }
inline unsigned __ballot_sync(unsigned, int p) {
  const int w = threadIdx.x / 32;
  warp_slots[w][threadIdx.x % 32] = p != 0;
  __syncwarp();
  unsigned m = 0;
  for (int j = 0; j < 32; ++j) m |= warp_slots[w][j] << j;
  __syncwarp();
  return m;
}
inline int __popc(unsigned x) { return __builtin_popcount(x); }
inline unsigned atomicAdd(unsigned* a, unsigned v) { return __atomic_fetch_add(a, v, __ATOMIC_RELAXED); }
inline float __uint_as_float(unsigned u) { float f; std::memcpy(&f, &u, 4); return f; }
template <class T> inline T __ldg(const T* p) { return *p; }
"""
# Step 3 of launch A ('a') or C ('c') on one block's rows, as the kernels
# call fft_rows (the same instances), by kThreadsA threads: reads "kind
# n_fft hop n_pow", LayoutF's tables and the rows' points (packed in
# BlueOrder, as the kernels pack them for Bluestein's stage); stages the
# tables as stage_tables does (the n_fft twiddles apart where LayoutF reads
# them through L1), a named barrier for each group of Bluestein's gw
# warps; prints LayoutF's Bluestein prime, m, gw, end and twl1, then the
# points.
HOST_MAIN = r"""
int main() {
  char kind;
  int n_fft, hop, n_pow;
  if (scanf(" %c %d %d %d", &kind, &n_fft, &hop, &n_pow) != 4) return 1;
  const LayoutF lay = kind == 'a' ? LayoutF(n_fft, hop) : LayoutF(n_fft, hop, n_pow);
  const int points = kind == 'a' ? fft_points_a(n_fft) : n_fft;
  const int rows = kind == 'a' && n_fft % 2 ? lay.rows : lay.frames;
  std::vector<float> smem(lay.end, -1e30f);
  float* base = smem.data();
  float2* buf = reinterpret_cast<float2*>(base);
  std::vector<float2> tables(lay.tables);
  for (auto& t : tables)
    if (scanf("%f %f", &t.x, &t.y) != 2) return 2;
  const int skip = lay.twl1() ? n_fft / 2 + 1 + lay.bp + lay.bm : 0;
  std::copy(tables.begin() + skip, tables.end(), reinterpret_cast<float2*>(base + lay.tw));
  const float2* tw = lay.twl1() ? tables.data() : reinterpret_cast<const float2*>(base + lay.tw);
  const BlueOrder<true> order(points, lay.bp);  // the kernels' packing, where Bluestein's stage runs first
  for (int i = 0; i < rows * points; ++i) {
    float2& v = buf[i / points * points + order(i % points)];
    if (scanf("%f %f", &v.x, &v.y) != 2) return 3;
  }
  std::barrier<> bar(kThreadsA);
  block_barrier = &bar;
  std::unique_ptr<std::barrier<>> warps[kWarpsA], groups[kWarpsA];
  for (int w = 0; w < kWarpsA; ++w) {
    warps[w] = std::make_unique<std::barrier<>>(32);
    warp_barriers[w] = warps[w].get();
    groups[w] = std::make_unique<std::barrier<>>(32 * std::max(lay.gw, 1));
    named_barriers[1 + w] = groups[w].get();
  }
  const int lp = largest_prime(n_fft);
  std::vector<std::thread> threads;
  for (int t = 0; t < kThreadsA; ++t)
    threads.emplace_back([&, t] {
      threadIdx.x = t;
      const Bluestein bl(lay, base, tables.data(), n_fft);
      if (kind == 'a') {
        if (lay.bp)
          fft_rows<11, 1, kBluesteinA>(buf, rows, points, n_fft, tw, &bl);
        else
          fft_rows<11, 1, 0>(buf, rows, points, n_fft, tw, &bl);
      } else if (lp <= 7) {
        fft_rows<7, 0, 0>(buf, rows, points, n_fft, tw, &bl);
      } else if (lp == 11) {
        fft_rows<11, 0, 0>(buf, rows, points, n_fft, tw, &bl);
      } else if (lp <= kFftMaxPrime) {
        fft_rows<11, kPrimeC, 0>(buf, rows, points, n_fft, tw, &bl);
      } else {
        fft_rows<11, kPrimeC, kBluesteinC>(buf, rows, points, n_fft, tw, &bl);
      }
    });
  for (auto& th : threads) th.join();
  printf("%d %d %d %d %d\n", lay.bp, lay.bm, lay.gw, lay.end, (int)lay.twl1());
  for (int i = 0; i < rows * points; ++i) printf("%.9g %.9g\n", buf[i].x, buf[i].y);
}
"""


@pytest.fixture(scope="module")
def host_stages(tmp_path_factory):
    """The kernel source's FFT stages (fft_rows and every stage under it,
    LayoutF, the Bluestein operands) built for the host with g++."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is not installed")
    src = (kernel_build._CSRC / "frontend_kernel.cu").read_text()

    def between(a, b):
        i = src.index(a)
        return src[i : src.index(b, i)]

    code = "\n".join([
        HOST_PRELUDE,
        between("constexpr int kWarpsA", "// Launch A's shared memory, in floats"),
        between("struct LayoutA {", "// x rounded to TF32"),
        between("struct LayoutC {", "__device__ __forceinline__ float warp_sum"),
        between("// The largest prime factor of n (n >= 1", "// One frame's contrast in one band"),
        HOST_MAIN,
    ])
    d = tmp_path_factory.mktemp("host_stages")
    (d / "stages.cpp").write_text(code)
    subprocess.run([gxx, "-std=c++20", "-O2", "-pthread", "-w", "-o", str(d / "stages"), str(d / "stages.cpp")],
                   check=True)
    return d / "stages"


@pytest.mark.parametrize("kind, n_fft, hop", [
    ("a", 2048, 512), ("a", 2000, 500), ("a", 1764, 441), ("a", 1323, 441), ("a", 832, 208), ("a", 1365, 441),
    ("a", 2192, 548), ("a", 1048, 262), ("a", 1965, 441), ("a", 4112, 1028), ("a", 5296, 1324), ("a", 6544, 1636),
    ("a", 5872, 1468), ("a", 3376, 844), ("a", 1987, 496),
    ("c", 2048, 512), ("c", 1792, 448), ("c", 2662, 665), ("c", 1664, 416), ("c", 2192, 548), ("c", 2096, 524),
    ("c", 1965, 441), ("c", 6544, 1636), ("c", 5296, 1324), ("c", 5872, 1468), ("c", 1987, 496),
])
def test_kernel_fft_stages_built_for_the_host(host_stages, kind, n_fft, hop):
    """The kernels' own FFT step (fft_rows as launch A's instance and
    launch C's by the n_fft's largest prime factor call it, on LayoutF's
    rows, tables and Bluestein scratch in one block's shared memory),
    built for the host and run by 256 threads meeting at a barrier, make
    each row's FFT against float64 `numpy.fft.fft`, and equal the CPU
    model (`_stockham`) but for the device's fused multiply-adds; LayoutF's
    Bluestein prime, m and bytes equal the mirror's."""
    n_pow = n_fft // 4 if kind == "c" else 0
    frames, nbytes = (frontend_kernel._spectral_layout(n_fft, hop) if kind == "a"
                      else frontend_kernel._fft_layout(n_fft, n_fft, hop, n_pow, contrast=True))
    points = n_fft if kind == "c" or n_fft % 2 else n_fft // 2
    rows = frames // 2 if kind == "a" and n_fft % 2 else frames
    tables = frontend_kernel._fft_tables(n_fft)
    rng = np.random.default_rng(n_fft)
    z = (rng.standard_normal((rows, points)) + 1j * rng.standard_normal((rows, points))).astype(np.complex64)
    text = "\n".join([f"{kind} {n_fft} {hop} {n_pow}", *(f"{a:.9g} {b:.9g}" for a, b in tables),
                      *(f"{v.real:.9g} {v.imag:.9g}" for v in z.reshape(-1))])
    out = subprocess.run([str(host_stages)], input=text, capture_output=True, text=True, check=True).stdout.split("\n")
    bp, m, gw, end, _ = map(int, out[0].split())
    assert bp == frontend_kernel._bluestein_prime(n_fft) and 4 * end == nbytes
    assert m == (frontend_kernel._bluestein_points(bp) if bp else 0) and (gw > 0) == (bp > 0)
    got = np.array([line.split() for line in out[1 : 1 + rows * points]], dtype=np.float64)
    got = (got[:, 0] + 1j * got[:, 1]).reshape(rows, points)
    assert _rel(got, np.fft.fft(z.astype(np.complex128), axis=-1)) < 1e-6
    re, im = frontend_kernel._stockham(torch.from_numpy(z.real.copy()), torch.from_numpy(z.imag.copy()),
                                       torch.from_numpy(tables), n_fft)
    assert _rel(got, re.numpy() + 1j * im.numpy()) < 1e-7


# Bluestein's FFT of m points alone (blue_stage in its row mode, the
# stages fft_stage_bluestein runs for one transform), by kThreadsA threads
# in groups of gw warps, each group through its own two rows of the
# scratch, meeting at its warp's barrier or its named one: reads "P gw"
# lines, then for each the stages' twiddles and the groups' rows (float32
# pairs) from the binary file argv[1]; writes the rows after the transform
# to argv[2]; prints m, the stages of both transforms and the last radix a
# line.
ROW_MAIN = r"""
int main(int argc, char** argv) {
  FILE* in = fopen(argv[1], "rb");
  FILE* out = fopen(argv[2], "wb");
  int P, gw;
  while (scanf("%d %d", &P, &gw) == 2) {
    LayoutF lay(P, P);  // launch A on the prime n_fft P: Bluestein's m
    const int m = lay.bm, groups = kWarpsA / gw;
    lay.gw = gw;
    lay.span = 0;
    lay.blue = lay.tw = 4 * groups * m;  // the stages' twiddles past the rows (twl1: the chirp and B^ unread)
    std::vector<float> smem(lay.blue + 2 * (m - 1), -1e30f);
    float* base = smem.data();
    float2* rows_at = reinterpret_cast<float2*>(base);
    if (fread(base + lay.blue, 8, m - 1, in) != (size_t)(m - 1)) return 2;
    for (int g = 0; g < groups; ++g)
      if (fread(rows_at + 2 * g * m, 8, m, in) != (size_t)m) return 3;
    std::vector<float2*> result(groups);
    std::barrier<> bar(kThreadsA);
    block_barrier = &bar;
    std::unique_ptr<std::barrier<>> warps[kWarpsA], rows[kWarpsA];
    for (int w = 0; w < kWarpsA; ++w) {
      warps[w] = std::make_unique<std::barrier<>>(32);
      warp_barriers[w] = warps[w].get();
      rows[w] = std::make_unique<std::barrier<>>(32 * gw);
      named_barriers[1 + w] = rows[w].get();
    }
    std::vector<std::thread> threads;
    for (int t = 0; t < kThreadsA; ++t)
      threads.emplace_back([&, t] {
        threadIdx.x = t;
        const Bluestein bl(lay, base, rows_at, P);
        const int group = (t >> 5) / gw, lane = t - 32 * gw * group;
        float2 *a = bl.scratch + 2 * group * m, *b = a + m;
        const float2* tw = bl.tw;
        const BlueStages stages(m);
        for (int s = 0, ns = 1; s < stages.count / 2; ++s) {
          const int r = blue_radix(m, ns);
          blue_stage_at(a, b, ns, kRow, bl, tw, nullptr, lane, 1 + group);
          std::swap(a, b);
          tw += ns * (r - 1);
          ns *= r;
        }
        if (lane == 0) result[group] = a;
        if (t == 0) printf("%d %d %d\n", bl.m, stages.count, stages.last);
      });
    for (auto& th : threads) th.join();
    for (int g = 0; g < groups; ++g) fwrite(result[g], 8, m, out);
  }
  fclose(out);
}
"""


@pytest.fixture(scope="module")
def host_rows(tmp_path_factory):
    """The kernel source's Bluestein row stages (blue_stage and the radix
    DFTs, LayoutF, the Bluestein operands) built for the host with g++."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is not installed")
    src = (kernel_build._CSRC / "frontend_kernel.cu").read_text()

    def between(a, b):
        i = src.index(a)
        return src[i : src.index(b, i)]

    code = "\n".join([
        HOST_PRELUDE,
        between("constexpr int kWarpsA", "// Launch A's shared memory, in floats"),
        between("struct LayoutA {", "// x rounded to TF32"),
        between("struct LayoutC {", "__device__ __forceinline__ float warp_sum"),
        between("// The largest prime factor of n (n >= 1", "// One frame's contrast in one band"),
        ROW_MAIN,
    ])
    d = tmp_path_factory.mktemp("host_rows")
    (d / "rows.cpp").write_text(code)
    subprocess.run([gxx, "-std=c++20", "-O2", "-pthread", "-w", "-o", str(d / "rows"), str(d / "rows.cpp")],
                   check=True)
    return d / "rows"


def test_bluestein_row_fft_built_for_the_host(host_rows, tmp_path):
    """Bluestein's FFT of m points, as each group of warps runs it through
    its own two rows (the kernel's blue_stage, built for the host and run
    by 256 threads), for every m that _bluestein_points gives for the
    primes from 127 to 1997 (275 to 3993), in groups of 1, 2, 4 and 8
    warps (the wide m's rows take the larger groups in LayoutF): each
    group's row is the FFT of its input against float64 `numpy.fft.fft`
    (1e-6, a float32 FFT's rounding), and equals the CPU model (`_stockham`
    with the m-point table, whose entries the stages' twiddles hold) but
    for the device's fused multiply-adds (1e-7); the stages are both
    transforms' (radix 15, else 9, else m's least prime factor:
    `_blue_radices`) and the last radix that list's last."""
    fk = frontend_kernel
    sizes = {}
    for p in range(127, 1998):
        if fk._prime_factors(p) == [p]:
            sizes.setdefault(fk._bluestein_points(p), p)
    cases, rows_in = [], []
    rng = np.random.default_rng(1997)
    for m, p in sorted(sizes.items()):
        for gw in (1, 2, 4, 8):
            z = (rng.standard_normal((8 // gw, m)) + 1j * rng.standard_normal((8 // gw, m))).astype(np.complex64)
            cases.append((m, p, gw, z))
            rows_in += [fk._bluestein_tables(p)[p + m :].reshape(-1), z.view(np.float32).reshape(-1)]
    assert all(fk._bluestein_tables(p).shape == (p + 2 * m - 1, 2) for m, p in sizes.items())
    assert [m for m, _ in sorted(sizes.items())][:: len(sizes) - 1] == [275, 3993] and len(cases) == 4 * len(sizes)
    np.concatenate(rows_in).astype(np.float32).tofile(tmp_path / "in.bin")
    out = subprocess.run([str(host_rows), str(tmp_path / "in.bin"), str(tmp_path / "out.bin")],
                         input="\n".join(f"{p} {gw}" for _, p, gw, _ in cases), capture_output=True, text=True,
                         check=True).stdout.split("\n")
    got_all = np.fromfile(tmp_path / "out.bin", dtype=np.complex64)
    at = 0
    for (m, p, gw, z), line in zip(cases, out):
        radices = fk._blue_radices(m)
        assert tuple(map(int, line.split())) == (m, 2 * len(radices), radices[-1]), (m, gw, line)
        got = got_all[at : at + z.size].reshape(z.shape).astype(np.complex128)
        at += z.size
        assert _rel(got, np.fft.fft(z.astype(np.complex128), axis=-1)) < 1e-6, (m, gw)
        re, im = fk._stockham(torch.from_numpy(z.real.copy()), torch.from_numpy(z.imag.copy()),
                              torch.from_numpy(fk._twiddles(m)), m, radices)
        assert _rel(got, re.numpy() + 1j * im.numpy()) < 1e-7, (m, gw)
    assert at == got_all.size

# Launch C's FFT plan's band stage on one block's power rows, by
# kThreadsA threads: reads "frames n_pow n_bands", the bands (first bin,
# bins, top and bottom tail lengths) and the rows; runs step 4 as
# contrast_fft_kernel does (band_value_sorted a warp a (frame, band) to
# kWideBand bins, then wide_bands), prints kWideBand, the (n_bands, frames)
# rows, then each wide (frame, band)'s tails' sums by block_tails, called
# one after another on one scratch.
BAND_MAIN = r"""
int main() {
  int frames, n_pow, n_bands;
  if (scanf("%d %d %d", &frames, &n_pow, &n_bands) != 3) return 1;
  std::vector<int4> bands(n_bands);
  for (auto& b : bands)
    if (scanf("%d %d %d %d", &b.x, &b.y, &b.z, &b.w) != 4) return 2;
  std::vector<float> pw(frames * n_pow), con(n_bands * frames, -1e30f);
  for (auto& v : pw)
    if (scanf("%f", &v) != 1) return 3;
  std::vector<unsigned> scratch(3 * 512 + 2 * kWarpsA, 0xdeadbeefu), scratch2(scratch);
  std::vector<float2> sums(n_bands * frames);
  std::barrier<> bar(kThreadsA);
  block_barrier = &bar;
  std::unique_ptr<std::barrier<>> warps[kWarpsA];
  for (int w = 0; w < kWarpsA; ++w) {
    warps[w] = std::make_unique<std::barrier<>>(32);
    warp_barriers[w] = warps[w].get();
  }
  std::vector<std::thread> threads;
  for (int t = 0; t < kThreadsA; ++t)
    threads.emplace_back([&, t] {
      threadIdx.x = t;
      const int lane = t & 31, warp = t >> 5;
      bool wide = false;
      for (int i = 0; i < n_bands; ++i) wide |= __ldg(bands.data() + i).y > kWideBand;
      for (int item = warp; item < frames * n_bands; item += kWarpsA) {
        const int f = item / n_bands, i = item - f * n_bands;
        const int4 bd = __ldg(bands.data() + i);
        if (bd.y > kWideBand) continue;
        const float v = band_value_sorted(pw.data() + f * n_pow, bd, lane);
        if (lane == 0) con[i * frames + f] = v;
      }
      if (wide) wide_bands(pw.data(), n_pow, bands.data(), n_bands, frames, con.data(), frames, scratch.data());
      __syncthreads();
      for (int i = t; i < 512; i += kThreadsA) scratch2[i] = 0u;
      __syncthreads();
      int q = 0;
      for (int f = 0; f < frames; ++f)
        for (int i = 0; i < n_bands; ++i) {
          const int4 bd = bands[i];
          if (bd.y <= kWideBand) continue;
          const float2 s = block_tails(pw.data() + f * n_pow + bd.x, bd.y, bd.z, bd.w, scratch2.data(), q);
          if (t == 0) sums[i * frames + f] = s;
        }
    });
  for (auto& th : threads) th.join();
  printf("%d\n", kWideBand);
  for (float v : con) printf("%.9g\n", v);
  for (int f = 0; f < frames; ++f)
    for (int i = 0; i < n_bands; ++i)
      if (bands[i].y > kWideBand) printf("%.9g %.9g\n", sums[i * frames + f].x, sums[i * frames + f].y);
}
"""


@pytest.fixture(scope="module")
def host_bands(tmp_path_factory):
    """The kernel source's band stage (band_value_sorted, block_tails, wide_bands
    and the warp reductions under them) built for the host with g++."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is not installed")
    src = (kernel_build._CSRC / "frontend_kernel.cu").read_text()

    def between(a, b):
        i = src.index(a)
        return src[i : src.index(b, i)]

    code = "\n".join([
        HOST_PRELUDE,
        between("constexpr int kWarpsA", "// Launch A's shared memory, in floats"),
        between("__device__ __forceinline__ float warp_sum", "// The clip's z-norm"),
        between("// One frame's contrast in one band, by a warp, for the FFT plan", "// A group's span into shared memory"),
        BAND_MAIN,
    ])
    d = tmp_path_factory.mktemp("host_bands")
    (d / "bands.cpp").write_text(code)
    subprocess.run([gxx, "-std=c++20", "-O2", "-pthread", "-w", "-o", str(d / "bands"), str(d / "bands.cpp")],
                   check=True)
    return d / "bands"


def _band_rows(kind: str, n: int, rng: np.random.Generator) -> np.ndarray:
    """n power values: "ties" small integers (exact sums, ranks full of
    ties), "zeros" mostly zero, "flat" one value, "power" squared normals
    over eight decades (a spectrum's spread)."""
    if kind == "ties":
        return rng.integers(0, 4, n).astype(np.float32)
    if kind == "zeros":
        return (rng.integers(0, 7, n) * (rng.random(n) < 0.1)).astype(np.float32)
    if kind == "flat":
        return np.full(n, 0.375, np.float32)
    return (rng.standard_normal(n) ** 2 * 10.0 ** rng.uniform(-6, 2, n)).astype(np.float32)


def _run_bands(exe, bands: list, rows: np.ndarray) -> tuple:
    """Step 4 on the host over (frames, n_pow) power rows: kWideBand, the
    contrast rows (n_bands, frames) and each wide (frame, band)'s tails'
    sums."""
    frames, n_pow = rows.shape
    text = "\n".join([f"{frames} {n_pow} {len(bands)}", *(" ".join(map(str, b)) for b in bands),
                      *(f"{v:.9g}" for v in rows.reshape(-1))])
    out = subprocess.run([str(exe)], input=text, capture_output=True, text=True, check=True).stdout.split("\n")
    n = len(bands) * frames
    con = np.array(out[1 : 1 + n], dtype=np.float64).reshape(len(bands), frames)
    sums = np.array([line.split() for line in out[1 + n :] if line], dtype=np.float64)
    return int(out[0]), con, sums.reshape(-1, 2)


def _rank_tails(band: np.ndarray, n_top: int, n_bot: int) -> tuple:
    """The stable-rank tails' sums in float64 (frontend's rule)."""
    top, bot = frontend._tail_sums_rank(torch.from_numpy(band.astype(np.float64)), n_top, n_bot)
    return float(top), float(bot)


@pytest.mark.parametrize("kind", ["ties", "zeros", "flat", "power"])
def test_block_tails_built_for_the_host(host_bands, kind):
    """The wide bands' selection (block_tails: a radix select by the block,
    8 bits a pass), built for the host and run by 256 threads with warps'
    shuffles and ballots emulated, one band after another on one scratch,
    equals the stable-rank tails on widths from 33 to 2048, one-bin tails
    and tails of all but one bin among them: exactly where the sums are
    exact (small integers), else to float32 rounding; and step 4's rows,
    by band_value_sorted to kWideBand bins and block_tails past it, equal the
    rank tails' contrast."""
    rng = np.random.default_rng(["ties", "zeros", "flat", "power"].index(kind))
    widths = (33, 64, 100, 255, 256, 257, 511, 512, 513, 581, 705, 868, 1024, 1500, 2048)
    bands, lo = [], 0
    for i, w in enumerate(widths):
        n_top, n_bot = ((1, 1), (w - 1, 1), (1, w - 1))[i % 3] if i % 2 else (
            w - min(max(1, int(w * 0.8)), w - 1), max(1, int(w * 0.2)))
        bands.append((lo, w, n_top, n_bot))
        lo += w
    rows = _band_rows(kind, 2 * lo, rng).reshape(2, lo)
    wide_band, con, sums = _run_bands(host_bands, bands, rows)
    wide = [b for b in bands if b[1] > wide_band]
    assert 33 <= wide_band <= 512
    assert sums.shape == (2 * len(wide), 2)
    exact = kind != "power"
    for f in range(2):
        for j, (lo_b, w, n_top, n_bot) in enumerate(wide):
            top, bot = _rank_tails(rows[f, lo_b : lo_b + w], n_top, n_bot)
            got = sums[f * len(wide) + j]
            if exact:
                assert (got[0], got[1]) == (top, bot), (kind, w, n_top, n_bot)
            else:
                np.testing.assert_allclose(got, (top, bot), rtol=1e-6, atol=0)
        for i, (lo_b, w, n_top, n_bot) in enumerate(bands):
            top, bot = _rank_tails(rows[f, lo_b : lo_b + w], n_top, n_bot)
            want = np.log1p(top / n_top) - np.log1p(bot / n_bot)
            assert abs(con[i, f] - want) <= 1e-6 * max(1.0, abs(want)), (kind, w, n_top, n_bot)


@pytest.mark.parametrize("name", ["nfft4096_contrast", "nfft5296_contrast", "nfft4608_bands8_contrast",
                                  "sr44k_nfft8192_contrast"])
def test_band_stage_built_for_the_host_on_config_bands(host_bands, name):
    """Step 4 built for the host on a config's own bands and its frames a
    group (LayoutF), on a float64 rfft power row of seeded audio: the rows
    equal the contrast of the stable-rank tails."""
    cfg = _cfg(name)
    geo = frontend_kernel._geometry(cfg)
    frames = frontend_kernel._fft_layout(cfg.n_fft, cfg.n_fft, cfg.hop_length, geo.n_pow, contrast=True)[0]
    w = _waves(cfg, 1, seed=24)
    spec = np.fft.rfft(_frames64(w, cfg, pre=False)[0, :frames] * filters.padded_window(cfg.win_length, cfg.n_fft))
    rows = (spec.real**2 + spec.imag**2)[:, geo.pow_lo : geo.pow_lo + geo.n_pow].astype(np.float32)
    bands = list(zip(geo.offsets, geo.widths, geo.tops, geo.bots))
    _, con, _ = _run_bands(host_bands, bands, rows)
    for f in range(frames):
        for i, (lo, n, n_top, n_bot) in enumerate(bands):
            top, bot = _rank_tails(rows[f, lo : lo + n], n_top, n_bot)
            want = np.log1p(top / n_top) - np.log1p(bot / n_bot) if n > 1 else 0.0
            assert abs(con[i, f] - want) <= 1e-6 * max(1.0, abs(want)), (name, f, i, n)


def test_epilogue_plan_mirrors_equal_the_c_rules(tmp_path):
    """Launch B's plan (blocks a clip), shared memory a block and threads a
    block, from the Python mirrors, equal the kernel source's own rules
    (compiled for the host) over a grid of configs: clips of 1 to 60 s at
    hops of 160 and 4, 32 to 256 mels, 8 to 36 MFCCs, PCEN and
    delta-deltas. The grid reaches every plan: one block, portable and
    non-portable clusters (blocks that fit three, two and one an SM),
    device memory."""
    gxx, code = _c_plan_rules()
    (tmp_path / "plans.cpp").write_text(code)
    subprocess.run([gxx, "-std=c++17", "-O1", "-o", str(tmp_path / "plans"), str(tmp_path / "plans.cpp")], check=True)
    cfgs = [
        FeatureConfig(segment_duration=dur, hop_length=hop, n_mels=mels, f_max=8000.0, n_mfcc=c, use_pcen=pcen,
                      use_delta_delta=dd)
        for dur, hop in ((1.0, 160), (2.0, 160), (3.0, 160), (4.5, 160), (5.0, 160), (10.0, 160), (20.0, 160),
                         (30.0, 160), (60.0, 160), (1.0, 4))
        for mels in (32, 40, 64, 128, 256) for c in (8, 13, 20, 36) for pcen in (False, True) for dd in (False, True)
    ]
    lines = [f"b {c.num_frames} {c.n_mels} {c.n_mfcc} {int(c.use_pcen)} {int(c.use_delta_delta)}" for c in cfgs]
    out = subprocess.run([str(tmp_path / "plans")], input="\n".join(lines), capture_output=True, text=True,
                         check=True).stdout.split("\n")
    seen = set()
    for i, c in enumerate(cfgs):
        n, smem, threads = map(int, out[i].split())
        assert (n, smem, threads) == (frontend_kernel.epilogue_blocks(c), frontend_kernel.epilogue_smem_bytes(c),
                                      frontend_kernel.epilogue_threads(c)), c
        assert smem <= 232448, c
        seen.add((n, max(k for k in (1, 2, 3) if smem <= 233472 // k - 1024)))
    assert {0, 1, 4, 8, 9, 16} <= {n for n, _ in seen}
    assert {k for n, k in seen if n >= 2} == {1, 2, 3}


def test_twiddle_table_layout():
    """(n_fft / 2 + 1, 2) float32: e^{-2 pi i k / n_fft} as (cos, -sin),
    computed in float64 and rounded once; its quarter and half points are
    the exact (0, -1) and (-1, 0) within a rounding of pi."""
    for n_fft in (1024, 2048, 4096):
        tw = frontend_kernel._twiddles(n_fft)
        assert tw.dtype == np.float32 and tw.shape == (n_fft // 2 + 1, 2)
        k = np.arange(n_fft // 2 + 1)
        np.testing.assert_array_equal(tw[:, 0], np.cos(2 * np.pi * k / n_fft).astype(np.float32))
        np.testing.assert_array_equal(tw[:, 1], (-np.sin(2 * np.pi * k / n_fft)).astype(np.float32))
        assert tuple(tw[0]) == (1.0, 0.0) and tw[n_fft // 4, 1] == -1.0 and tw[n_fft // 2, 0] == -1.0
        assert abs(tw[n_fft // 4, 0]) < 1e-7 and abs(tw[n_fft // 2, 1]) < 1e-7


@pytest.mark.parametrize("name", ["nfft2048", "librosa22k", "mels256"])
def test_filter_ranges_layout(name):
    """Launch A's FFT plan reads each mel's nonzero bins as a range: its
    first bin, its bins and their offset in one packed weight array, mel
    after mel. Unpacked, they are the filterbank over the used bins."""
    cfg = _cfg(name)
    k = frontend_kernel._fft_constants(cfg, torch.device("cpu"))
    fb = filters.mel_filterbank(cfg.n_fft // 2 + 1, cfg.n_mels, cfg.sample_rate, cfg.f_min, cfg.f_max)
    assert k.fb_ranges.dtype == torch.int32 and k.fb_ranges.shape == (cfg.n_mels, 3)
    lo, n, off = k.fb_ranges.numpy().T
    weights = k.fb_w.numpy()
    np.testing.assert_array_equal(off, np.concatenate([[0], np.cumsum(n)[:-1]]))
    assert int(off[-1] + n[-1]) == weights.size < 3 * k.n_used
    unpacked = np.zeros((k.n_used, cfg.n_mels), np.float32)
    for m in range(cfg.n_mels):
        unpacked[lo[m] : lo[m] + n[m], m] = weights[off[m] : off[m] + n[m]]
        assert n[m] == 0 or (weights[off[m]] > 0 and weights[off[m] + n[m] - 1] > 0)
    np.testing.assert_array_equal(unpacked, fb[: k.n_used])
    assert not fb[k.n_used :].any()
    assert k.window.shape == (cfg.n_fft,) and k.twiddles.shape == (cfg.n_fft // 2 + 1, 2)


@pytest.mark.parametrize("name", ["nfft2048", "nfft2048_contrast"])
def test_wrappers_on_cpu_run_the_plain_versions(name):
    """On a CPU tensor the wrappers of the FFT-plan configs run the plain
    versions and launch nothing."""
    cfg = _cfg(name)
    base = dataclasses.replace(cfg, use_spectral_contrast=False)
    w = torch.from_numpy(_waves(cfg, 2, seed=24))
    counters = frontend_kernel.LAUNCH_COUNTERS + frontend_kernel.PLAN_COUNTERS
    before = tuple(getattr(frontend_kernel, c) for c in counters)
    assert torch.equal(frontend_kernel.power_mel_fused(w, base), frontend_kernel.power_mel_reference(w, base))
    if cfg.use_spectral_contrast:
        assert torch.equal(frontend_kernel.spectral_contrast_fused(w, cfg),
                           frontend_kernel.spectral_contrast_reference(w, cfg))
    assert tuple(getattr(frontend_kernel, c) for c in counters) == before


def test_graph_replays_count_the_fft_plans(monkeypatch):
    """A captured program's replay adds its captured launches to every
    counter, the FFT plans' own (PLAN_COUNTERS) among them, so a main path
    through a graph shows which plan's kernel ran."""
    from cough_detector_tpu_torch.utils import graphs

    names = frontend_kernel.LAUNCH_COUNTERS + frontend_kernel.PLAN_COUNTERS
    assert frontend_kernel.PLAN_COUNTERS == ("SPECTRAL_FFT_LAUNCHES", "CONTRAST_FFT_LAUNCHES")
    for n in names:
        monkeypatch.setattr(frontend_kernel, n, 0)
    graphs._add_launches((1, 1, 1, 1, 1))
    graphs._add_launches((1, 1, 0, 0, 0))
    assert graphs._launches() == (2, 2, 1, 1, 1)
    assert (frontend_kernel.SPECTRAL_FFT_LAUNCHES, frontend_kernel.CONTRAST_FFT_LAUNCHES) == (1, 1)


@pytest.mark.parametrize("name", ["nfft2048", "nfft2048_contrast"])
def test_custom_ops_fakes_at_the_fft_geometry(name):
    """The custom ops' fakes (what torch.export traces) give the real
    shapes at the FFT plans' configs."""
    cfg = _cfg(name)
    args = frontend_kernel._op_args(cfg)
    w = torch.from_numpy(_waves(cfg, 2, seed=25))
    mel = torch.ops.cdt.power_mel(w, *frontend_kernel._op_args(dataclasses.replace(cfg, use_spectral_contrast=False)))
    assert mel.shape == (2, cfg.n_mels, cfg.num_frames)
    base_args = frontend_kernel._op_args(dataclasses.replace(cfg, use_spectral_contrast=False))
    torch.library.opcheck(torch.ops.cdt.power_mel.default, (w, *base_args))
    torch.library.opcheck(torch.ops.cdt.mel_epilogue.default, (mel, *base_args))
    if cfg.use_spectral_contrast:
        rows = torch.ops.cdt.spectral_contrast(w, *args)
        assert rows.shape == (2, cfg.n_contrast_bands + 1, cfg.num_frames)
        torch.library.opcheck(torch.ops.cdt.spectral_contrast.default, (w, *args))
