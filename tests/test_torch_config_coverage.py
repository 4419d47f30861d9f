"""Every config the JAX launcher sends to its Pallas kernel, on the port's
card route, on the CPU.

The JAX launcher (cough_detector_tpu/ops/pallas/frontend_kernel.py) runs
its kernel for every config with MFCCs at segment length, and appends the
contrast rows for a contrast config. The port's three launches take the
same set: more than 128 mels and an n_fft whose rows, Bluestein scratch
and tables fit a block, odd or even, from 640 on by FFT (launches A and C's
FFT plans: radix stages, a generic prime stage to kFftMaxPrime, Bluestein's
past it), any other n_fft past shared memory with the waveform gathered
from device memory, clips past 4 s over
a thread-block cluster (or in device memory past 16 blocks), a hop of 4,
and any contrast bands.
The kernels run only on the card (chip_smoke.py holds them there); here
the same numpy inputs go through the port's card route with device="cpu"
(the launches' plain versions) and through the JAX package, and the
launches' plans are held against the values the card's library returned.

JAX references at B = 2: the Pallas kernel in interpret mode (the hybrid
for contrast configs) where it runs in a few seconds here (1.5-6.1 s a
config), the jnp chain for the 10 s clip (14.8 s interpreted) and the hop
of 4 (4001 frames, 59.2 s interpreted: too slow for Tier-1), which compute
the same function. Budget: 1e-3 max-relative (docs/PARITY.md).
"""

import dataclasses

import numpy as np
import pytest
import torch

from cough_detector_tpu.config import FeatureConfig as JaxFeatureConfig
from cough_detector_tpu.data import synth
from cough_detector_tpu.ops import frontend as jax_frontend
from cough_detector_tpu.ops.pallas import frontend_kernel as jax_kernel
from cough_detector_tpu_torch.config import FeatureConfig
from cough_detector_tpu_torch.ops import frontend, frontend_kernel
from test_torch_frontend import _rel

TOL = 1e-3
CONTRAST = dict(use_spectral_contrast=True)
NFFT2048 = dict(n_fft=2048, win_length=2048, hop_length=512, n_mels=128, f_max=8000.0)
SR44K = dict(sample_rate=44100, hop_length=441, n_mels=128, f_max=22050.0)  # a 10 ms hop at 44.1 kHz
CONFIGS = {
    "mels160": dict(n_mels=160, f_max=8000.0),
    "mels256": dict(n_mels=256, f_max=8000.0),
    "nfft2048": NFFT2048,
    "librosa22k": dict(NFFT2048, sample_rate=22050, f_max=11025.0),
    "clip5s_128": dict(segment_duration=5.0, n_mels=128, f_max=8000.0),
    "clip10s": dict(segment_duration=10.0),
    "hop4": dict(hop_length=4),
    "nfft1024_contrast": dict(n_fft=1024, win_length=1024, hop_length=256, n_mels=128, f_max=8000.0, **CONTRAST),
    "nfft2048_contrast": dict(NFFT2048, **CONTRAST),
    "bands17": dict(n_contrast_bands=17, **CONTRAST),
}
# Configs chip_smoke.py adds for the plans no config above reaches: the
# FFT plans at n_fft 4096, 2000, 3000 (radix-3 and radix-5 stages) and 768
# at 256 mels, and at n_fft 1792, 2744 and 896 at 256 mels (radix-7
# stages), 1764 with contrast and 882 at 44.1 kHz (a 40 and a 20 ms window
# at a 10 ms hop; 441 points, odd, a frame of launch A); at n_fft 1760 and
# 2662 with contrast and 880 at 256 mels (radix-11 stages), and on an odd
# n_fft, launch A two frames a row: 30 ms at 44.1 kHz with and without
# contrast (1323), 50 ms with contrast (2205) and n_fft 1125 (57 frames, a
# lone last one); n_fft with a prime factor of 13, on the FFT plans since
# their generic prime stage (1664 and 2704 with contrast, 832 at 256 mels,
# the odd 1365 at 44.1 kHz); n_fft with a prime factor past the generic
# stage's cap, on the FFT plans since their Bluestein stage (131 and 137 ms
# windows at 16 kHz with contrast, 2096 and 2192; 2192 and 1048 at 256
# mels; the odd 1965 at 44.1 kHz on 256 mels); contrast bands past 512
# bins, taken by the block (5296, 6144, 4608 with 8 bands, 8192 at 44.1
# kHz); the widest Bluestein convolutions, rows over two and four warps
# (6544, a prime 409: m 825; the prime n_fft 1987: m 3993); since the FFT
# plans took
# every n_fft they fit, the GEMM plans' span from device memory (launch A
# unstaged, the contrast launch's levels 1 and 3) and launch A's GEMM plan
# over two mel groups, reached by a 25 ms hop with contrast (level 1) and
# the prime n_fft 2129 on 256 mels with contrast, which no FFT layout
# fits (two mel groups, level 3); two 10 s clips for launch B's
# cluster route's other branches (PCEN with delta-deltas and its 32-MFCC
# DCT; 36 MFCCs of 40 mels, the MFCC and delta tiles after the mel tile);
# and a 120 s clip, past a cluster of 16: launch B in device memory.
EXTRA = {
    "clip60s_128_all_flags": dict(segment_duration=60.0, n_mels=128, f_max=8000.0, use_pcen=True,
                                  use_pre_emphasis=True, use_delta_delta=True, **CONTRAST),
    "hop4_contrast": dict(hop_length=4, **CONTRAST),
    "nfft4096_contrast": dict(n_fft=4096, win_length=4096, hop_length=1024, n_mels=128, f_max=8000.0, **CONTRAST),
    "nfft2000_contrast": dict(n_fft=2000, win_length=2000, hop_length=500, n_mels=128, f_max=8000.0, **CONTRAST),
    "nfft3000_contrast": dict(n_fft=3000, win_length=3000, hop_length=750, n_mels=128, f_max=8000.0, **CONTRAST),
    "nfft768_mels256": dict(n_fft=768, win_length=768, hop_length=192, n_mels=256, f_max=8000.0),
    "nfft1792_contrast": dict(n_fft=1792, win_length=1792, hop_length=448, n_mels=128, f_max=8000.0, **CONTRAST),
    "nfft2744_contrast": dict(n_fft=2744, win_length=2744, hop_length=686, n_mels=128, f_max=8000.0, **CONTRAST),
    "nfft896_mels256": dict(n_fft=896, win_length=896, hop_length=224, n_mels=256, f_max=8000.0),
    "nfft1760_contrast": dict(n_fft=1760, win_length=1760, hop_length=440, n_mels=128, f_max=8000.0, **CONTRAST),
    "nfft2662_contrast": dict(n_fft=2662, win_length=2662, hop_length=665, n_mels=128, f_max=8000.0, **CONTRAST),
    "nfft880_mels256": dict(n_fft=880, win_length=880, hop_length=220, n_mels=256, f_max=8000.0),
    "sr44k_nfft1764_contrast": dict(SR44K, n_fft=1764, win_length=1764, **CONTRAST),
    "sr44k_nfft882": dict(SR44K, n_fft=882, win_length=882),
    "sr44k_nfft1323": dict(SR44K, n_fft=1323, win_length=1323),
    "sr44k_nfft1323_contrast": dict(SR44K, n_fft=1323, win_length=1323, **CONTRAST),
    "sr44k_nfft2205_contrast": dict(SR44K, n_fft=2205, win_length=2205, **CONTRAST),
    "nfft1125": dict(n_fft=1125, win_length=1125, hop_length=281, n_mels=128, f_max=8000.0),
    "nfft1664_contrast": dict(n_fft=1664, win_length=1664, hop_length=416, n_mels=128, f_max=8000.0, **CONTRAST),
    "nfft2704_contrast": dict(n_fft=2704, win_length=2704, hop_length=676, n_mels=128, f_max=8000.0, **CONTRAST),
    "nfft832_mels256": dict(n_fft=832, win_length=832, hop_length=208, n_mels=256, f_max=8000.0),
    "sr44k_nfft1365": dict(SR44K, n_fft=1365, win_length=1365),
    "nfft2096_contrast": dict(n_fft=2096, win_length=2096, hop_length=524, n_mels=128, f_max=8000.0, **CONTRAST),
    "nfft2192_contrast": dict(n_fft=2192, win_length=2192, hop_length=548, n_mels=128, f_max=8000.0, **CONTRAST),
    "nfft5296_contrast": dict(n_fft=5296, win_length=5296, hop_length=1324, n_mels=128, f_max=8000.0, **CONTRAST),
    "nfft6144_contrast": dict(n_fft=6144, win_length=6144, hop_length=1536, n_mels=128, f_max=8000.0, **CONTRAST),
    "nfft6544_contrast": dict(n_fft=6544, win_length=6544, hop_length=1636, n_mels=128, f_max=8000.0, **CONTRAST),
    "nfft1987_contrast": dict(n_fft=1987, win_length=1987, hop_length=496, n_mels=128, f_max=8000.0, **CONTRAST),
    "sr44k_nfft8192_contrast": dict(SR44K, n_fft=8192, win_length=8192, hop_length=2048, **CONTRAST),
    "nfft4608_bands8_contrast": dict(n_fft=4608, win_length=4608, hop_length=1152, n_mels=128, f_max=8000.0,
                                     n_contrast_bands=8, **CONTRAST),
    "nfft2192_mels256": dict(n_fft=2192, win_length=2192, hop_length=548, n_mels=256, f_max=8000.0),
    "nfft1048_mels256": dict(n_fft=1048, win_length=1048, hop_length=262, n_mels=256, f_max=8000.0),
    "sr44k_nfft1965_mels256": dict(SR44K, n_fft=1965, win_length=1965, n_mels=256),
    "hop400_contrast": dict(hop_length=400, **CONTRAST),
    "nfft2129_mels256_contrast": dict(n_fft=2129, win_length=2129, hop_length=532, n_mels=256, f_max=8000.0,
                                      **CONTRAST),
    "clip10s_pcen_dd20": dict(segment_duration=10.0, use_pcen=True, use_delta_delta=True, n_mfcc=20),
    "clip10s_mels40_mfcc36_dd": dict(segment_duration=10.0, n_mels=40, n_mfcc=36, use_delta_delta=True),
    "clip120s_128_pcen_dd": dict(segment_duration=120.0, n_mels=128, f_max=8000.0, use_pcen=True,
                                 use_delta_delta=True),
}
JNP = ("clip10s", "hop4")  # too long in interpret mode: the JAX jnp chain instead

# What the card's library returned for each config (chip_smoke.py's
# every-config checks, NVIDIA H100 80GB HBM3): launch A's shared memory and
# its plan (0 the GEMM with its span from device memory, 1 staged, 2 the
# FFT); launch B's shared memory a block and its blocks a clip (0: device
# memory); the contrast launch's shared memory and plan (LayoutC's level
# 0-3, 4 the FFT).
PLANS_ON_CARD = {
    "mels160": (89480, 2, 75008, 1, None, None),
    "mels256": (89480, 2, 119936, 1, None, None),
    "nfft2048": (96264, 2, 24704, 1, None, None),
    "librosa22k": (96264, 2, 30848, 1, None, None),
    "clip5s_128": (118096, 1, 74208, 4, None, None),
    "clip10s": (118096, 1, 69344, 4, None, None),
    "hop4": (36464, 1, 73440, 15, None, None),
    "nfft1024_contrast": (89096, 2, 40576, 1, 87656, 4),
    "nfft2048_contrast": (96264, 2, 24704, 1, 94200, 4),
    "bands17": (118096, 1, 30080, 1, 221840, 0),
    "clip60s_128_all_flags": (118096, 1, 219104, 15, 91760, 2),
    "hop4_contrast": (36464, 1, 73440, 15, 207888, 0),
    "nfft4096_contrast": (110600, 2, 16512, 1, 107976, 4),
    "nfft2000_contrast": (94008, 2, 25216, 1, 92024, 4),
    "nfft3000_contrast": (96008, 2, 19584, 1, 79288, 4),
    "nfft768_mels256": (86024, 2, 102528, 1, None, None),
    "nfft1792_contrast": (93192, 2, 26752, 1, 82536, 4),
    "nfft2744_contrast": (87816, 2, 20608, 1, 72584, 4),
    "nfft896_mels256": (86920, 2, 90240, 1, None, None),
    "nfft1760_contrast": (91528, 2, 27264, 1, 81080, 4),
    "nfft2662_contrast": (98496, 2, 21120, 1, 70432, 4),
    "nfft880_mels256": (85368, 2, 91264, 1, None, None),
    "sr44k_nfft1764_contrast": (91736, 2, 60032, 1, 81272, 4),
    "sr44k_nfft882": (100560, 2, 60032, 1, None, None),
    "sr44k_nfft1323": (93508, 2, 59520, 1, None, None),
    "sr44k_nfft1323_contrast": (93508, 2, 59520, 1, 62452, 4),
    "sr44k_nfft2205_contrast": (79396, 2, 59520, 1, 57996, 4),
    "nfft1125": (86628, 2, 37504, 1, None, None),
    "nfft1664_contrast": (86536, 2, 28288, 1, 76696, 4),
    "nfft2704_contrast": (100056, 2, 20608, 1, 71528, 4),
    "nfft832_mels256": (84872, 2, 95360, 1, None, None),
    "sr44k_nfft1365": (95852, 2, 59520, 1, None, None),
    "nfft2096_contrast": (107720, 2, 24192, 1, 85736, 4),
    "nfft2192_contrast": (110840, 2, 23680, 1, 87816, 4),
    "nfft5296_contrast": (112144, 2, 14976, 1, 94464, 4),
    "nfft6144_contrast": (104456, 2, 13952, 1, 102280, 4),
    "nfft6544_contrast": (111744, 2, 13440, 1, 89520, 4),
    "nfft1987_contrast": (223296, 2, 25216, 1, 229264, 4),
    "sr44k_nfft8192_contrast": (139272, 2, 19584, 1, 136136, 4),
    "nfft4608_bands8_contrast": (101384, 2, 15488, 1, 77704, 4),
    "nfft2192_mels256": (110840, 2, 47232, 1, None, None),
    "nfft1048_mels256": (107720, 2, 80000, 1, None, None),
    "sr44k_nfft1965_mels256": (111388, 2, 118912, 1, None, None),
    "hop400_contrast": (32816, 0, 14720, 1, 92912, 1),
    "nfft2129_mels256_contrast": (32816, 0, 48256, 1, 32880, 3),
    "clip10s_pcen_dd20": (118096, 1, 75488, 4, None, None),
    "clip10s_mels40_mfcc36_dd": (118096, 1, 76576, 7, None, None),
    "clip120s_128_pcen_dd": (118096, 1, 128, 0, None, None),
}
SMEM = 232448  # bytes of shared memory a block may use on sm_90


def _cfg(name: str) -> FeatureConfig:
    return FeatureConfig(**{**CONFIGS, **EXTRA}[name])


def _waves(cfg: FeatureConfig, n: int, seed: int) -> np.ndarray:
    """n clips of the config's segment length and sample rate: a synthetic
    cough, then a non-cough."""
    dur = cfg.segment_duration
    return np.stack([
        (synth.synthetic_cough if i % 2 == 0 else synth.synthetic_non_cough)(seed + i, dur, cfg.sample_rate)
        for i in range(n)
    ]).astype(np.float32)


def _launches() -> tuple:
    return tuple(getattr(frontend_kernel, c) for c in frontend_kernel.LAUNCH_COUNTERS)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Small tensors: one intra-op thread for the module (its module-scoped
    work included), restored after it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_card_route_matches_jax(name):
    """extract_features_fast, the route every path calls, on the CPU (the
    launches' plain versions) against the JAX package at B = 2."""
    cfg = _cfg(name)
    w = _waves(cfg, 2, seed=11)
    before = _launches()
    got = frontend.extract_features_fast(w, cfg, device="cpu").numpy()
    assert _launches() == before
    jcfg = JaxFeatureConfig(**{**CONFIGS, **EXTRA}[name])
    if name in JNP:
        want = np.asarray(jax_frontend.extract_features(w, jcfg))
    else:
        want = np.asarray(jax_kernel.extract_features_fused(w, jcfg, interpret=True))
    assert got.shape == want.shape == (2, cfg.num_features, cfg.num_frames)
    assert _rel(got, want) < TOL


@pytest.mark.parametrize("name", list(CONFIGS))
def test_split_models_hold_the_plain_versions(name):
    """The 3xTF32 models of launch A and the contrast launch, which
    chip_smoke.py holds the kernels against, agree with the plain versions
    at each config's geometry (2048-tap frames, 256 mels)."""
    cfg = _cfg(name)
    base = dataclasses.replace(cfg, use_spectral_contrast=False)
    w = torch.from_numpy(_waves(cfg, 2, seed=13))
    mel = frontend_kernel.power_mel_reference(w, base)
    model = frontend_kernel.power_mel_split_reference(w, base)
    assert _rel(model.numpy(), mel.numpy()) < 1e-4
    if cfg.use_spectral_contrast:
        want = frontend_kernel.spectral_contrast_reference(w, cfg).numpy()
        got = frontend_kernel.spectral_contrast_split_reference(w, cfg).numpy()
        assert _rel(got, want) < 1e-4


@pytest.mark.parametrize("name", list(PLANS_ON_CARD))
def test_plans_match_the_card(name):
    """Each launch's shared memory and plan, from the Python mirrors,
    equal what the card's library returned; each fits a block."""
    cfg = _cfg(name)
    base = dataclasses.replace(cfg, use_spectral_contrast=False)
    got = (
        frontend_kernel.spectral_smem_bytes(base),
        frontend_kernel.spectral_plan(base),
        frontend_kernel.epilogue_smem_bytes(cfg),
        frontend_kernel.epilogue_blocks(cfg),
    )
    if cfg.use_spectral_contrast:
        got += (frontend_kernel.contrast_smem_bytes(cfg), frontend_kernel.contrast_level(cfg))
    else:
        got += (None, None)
    assert got == PLANS_ON_CARD[name]
    assert all(v <= SMEM for v in (got[0], got[2], got[4] or 0))


@pytest.mark.parametrize("n_fft, hop", [(1323, 441), (882, 441), (1764, 441), (1125, 281), (1001, 147), (2048, 512)])
def test_num_frames_counts_the_framing(n_fft, hop):
    """num_frames is the count of frames the reflect-padded segment holds
    (torch.stft's, center=True): the JAX config's segment // hop + 1 for an
    even n_fft, one fewer for an odd n_fft whose hop divides the segment
    (its padding is a sample short of the last frame)."""
    kw = dict(sample_rate=44100, n_fft=n_fft, win_length=n_fft, hop_length=hop, n_mels=128, f_max=22050.0)
    cfg = FeatureConfig(**kw)
    frames = frontend.frame_signal(torch.zeros((1, cfg.segment_samples)), n_fft, hop)
    assert cfg.num_frames == frames.shape[1]
    short = n_fft % 2 == 1 and cfg.segment_samples % hop == 0
    assert cfg.num_frames == JaxFeatureConfig(**kw).num_frames - short


@pytest.mark.parametrize("name, frames", [("sr44k_nfft1323", 100), ("sr44k_nfft1323_contrast", 100), ("nfft1125", 57)])
def test_odd_n_fft_matches_the_jax_chain(name, frames):
    """An odd n_fft (30 ms at 44.1 kHz, a 10 ms hop: 100 frames, with and
    without contrast; n_fft 1125, 57 frames) against the JAX jnp chain at
    B = 2 (the JAX Pallas kernel refuses an odd n_fft whose hop divides the
    segment: its frames are a sample short): the card route on the CPU
    (the launches' plain versions), and the whole feature image as the card
    computes it there (launch A's FFT model, two frames through one FFT and
    a lone last frame with zeros; launch B's plain version; the contrast
    launch's FFT model)."""
    cfg = _cfg(name)
    base = dataclasses.replace(cfg, use_spectral_contrast=False)
    assert frontend_kernel.spectral_plan(base) == frontend_kernel.PLAN_FFT
    w = _waves(cfg, 2, seed=19)
    got = frontend.extract_features_fast(w, cfg, device="cpu").numpy()
    t = torch.from_numpy(w)
    card = frontend_kernel.mel_epilogue_reference(frontend_kernel.power_mel_fft_reference(t, base), base)
    if cfg.use_spectral_contrast:
        assert frontend_kernel.contrast_level(cfg) == frontend_kernel.CONTRAST_FFT
        card = torch.cat([card, frontend_kernel.spectral_contrast_fft_reference(t, cfg)], dim=1)
    want = np.asarray(jax_frontend.extract_features(w, JaxFeatureConfig(**EXTRA[name])))
    assert got.shape == card.shape == want.shape == (2, cfg.num_features, frames)
    assert _rel(got, want) < TOL
    assert _rel(card.numpy(), want) < TOL


@pytest.mark.parametrize("n_mels, want", [
    (32, (4, 1)), (64, (8, 1)), (128, (16, 1)), (129, (16, 2)), (160, (16, 2)),
    (256, (16, 2)), (257, (16, 3)), (300, (16, 3)), (200, (16, 2)), (96, (16, 1)),
])
def test_mel_groups(n_mels, want):
    """Launch A's mel groups: the fewest groups of at most 128 mels, each
    of the narrowest width (32, 64 or 128) that holds its share."""
    tiles, groups = frontend_kernel.mel_groups(n_mels)
    assert (tiles, groups) == want
    assert 8 * tiles * groups >= n_mels and 8 * tiles * (groups - 1) < n_mels


def test_table_stream_per_mel_group():
    """At 160 mels launch A's chunk stream is one stream a mel group: the
    same DFT chunks, then the filterbank's columns of the group's mels."""
    cfg = _cfg("mels160")
    k = frontend_kernel._constants(cfg, torch.device("cpu"))
    assert (k.mel_tiles, k.n_groups) == (16, 2)
    n_passes = -(-2 * k.n_bins // 256)
    ks, width = k.kpad // 8, 8 * k.mel_tiles
    per_pass = (ks + width // 16) * 4096
    groups = k.table.reshape(k.n_groups, n_passes, per_pass)
    assert torch.equal(groups[0, :, : ks * 4096], groups[1, :, : ks * 4096])
    for g in range(k.n_groups):
        v = groups[g, :, ks * 4096 :].reshape(n_passes, 16, 2, width // 8, 2, 8, 4)
        fb = (v[:, :, 0] + v[:, :, 1]).permute(0, 1, 3, 5, 2, 4).reshape(-1, width)
        cols = slice(g * width, min((g + 1) * width, cfg.n_mels))
        n = cols.stop - cols.start
        np.testing.assert_allclose(fb[: k.n_used, :n], k.fb[:, cols], atol=2e-7)
        assert not fb[:, n:].any()


@pytest.mark.parametrize("batch, n_frames, groups", [(3, 101, 2), (5, 4001, 1), (2, 201, 3)])
def test_spectral_grid_with_mel_groups(batch, n_frames, groups):
    """Every (clip, row tile, mel group) is one block of launch A's grid x,
    as the kernel maps blockIdx.x."""
    tiles = -(-n_frames // 128)
    blocks = frontend_kernel.spectral_grid(batch, n_frames, groups)
    assert blocks == batch * tiles * groups
    clip, t0, grp = frontend_kernel.spectral_block(np.arange(blocks), n_frames, groups)
    assert np.unique(clip * tiles * groups + grp * tiles + t0 // 128).size == blocks
    assert clip.max() == batch - 1 and grp.max() == groups - 1 and t0.max() == (tiles - 1) * 128


@pytest.mark.parametrize("name, blocks, frames, per_sm", [
    ("clip5s_128", 4, 126, 3), ("clip10s", 4, 251, 3), ("clip10s_pcen_dd20", 4, 251, 3),
    ("clip10s_mels40_mfcc36_dd", 7, 143, 3), ("hop4", 15, 267, 3), ("clip60s_128_all_flags", 15, 401, 1),
])
def test_epilogue_cluster_takes_the_fewest_blocks(name, blocks, frames, per_sm):
    """Launch B's cluster: for per_sm = 3, 2, 1 blocks an SM (233,472 B an
    SM, 1 KB reserved a block), the fewest blocks (up to 16) whose share of
    the clip's frames, with its halo (5 frames a side with PCEN, else 1 +
    delta_delta), fits per_sm an SM. One block fewer would not, and no
    cluster of 16 fits more an SM. 256 threads a block."""
    cfg = _cfg(name)
    assert frontend_kernel.epilogue_blocks(cfg) == blocks
    assert frontend_kernel.epilogue_threads(cfg) == 256
    assert -(-cfg.num_frames // blocks) == frames
    m, c, dd = cfg.n_mels, cfg.n_mfcc, cfg.use_delta_delta
    halo = 5 if cfg.use_pcen else 1 + int(dd)
    smem = 4 * frontend_kernel._layout_b_floats(frames, m, c, dd, halo, frontend_kernel._RED_BC)
    assert smem == frontend_kernel.epilogue_smem_bytes(cfg) <= SMEM

    def share(k):
        return 233472 // k - 1024

    assert smem <= share(per_sm) and frontend_kernel._cluster_bytes(cfg, blocks - 1) > share(per_sm)
    if per_sm < 3:
        assert frontend_kernel._cluster_bytes(cfg, 16) > share(per_sm + 1)


@pytest.mark.parametrize("name", ["clip10s_pcen_dd20", "clip10s_mels40_mfcc36_dd"])
def test_cluster_branches_match_jax(name):
    """The configs that reach launch B's cluster route's PCEN,
    delta-delta, 32-MFCC and two-pass DCT branches on the card, through the
    port's card route on the CPU (the plain versions) against the JAX jnp
    chain at B = 2 (10 s clips: too long in interpret mode, as clip10s)."""
    cfg = _cfg(name)
    w = _waves(cfg, 2, seed=17)
    got = frontend.extract_features_fast(w, cfg, device="cpu").numpy()
    want = np.asarray(jax_frontend.extract_features(w, JaxFeatureConfig(**EXTRA[name])))
    assert got.shape == want.shape == (2, cfg.num_features, cfg.num_frames)
    assert _rel(got, want) < TOL


def test_contrast_bands_in_device_memory():
    """The contrast launch reads its bands from one int32 table: per band
    its first bin (from the first power bin), bins, top and bottom tail
    lengths; 17 bands, more than the 16 it once took by value."""
    cfg = _cfg("bands17")
    g = frontend_kernel._geometry(cfg)
    bands = frontend_kernel._contrast_constants(cfg, torch.device("cpu")).bands
    assert bands.dtype == torch.int32 and bands.shape == (17, 4) and bands.is_contiguous()
    assert bands.T.tolist() == [list(g.offsets), list(g.widths), list(g.tops), list(g.bots)]
    assert max(frontend_kernel._geometry(_cfg("nfft2048_contrast")).widths) == 239


def test_kernel_supports_is_the_jax_launchers_test(monkeypatch):
    """Over a grid of configs and lengths, kernel_supports (the card route)
    holds exactly where the JAX launcher calls its Pallas kernel: with
    MFCCs at segment length, for a contrast config too (its hybrid). The
    JAX launcher's kernel and chains are stubbed to record the call."""
    called = []

    def run(waves, cfg, interpret):
        called.append("kernel")
        return np.zeros((waves.shape[0], cfg.num_features, cfg.num_frames), np.float32)

    def chain(waves, cfg):
        called.append("chain")
        return np.zeros((waves.shape[0], cfg.num_features, cfg.num_frames), np.float32)

    monkeypatch.setattr(jax_kernel, "_run", run)
    monkeypatch.setattr(jax_frontend, "extract_features", chain)
    monkeypatch.setattr(
        jax_frontend, "spectral_contrast",
        lambda waves, cfg, method="fft": np.zeros((waves.shape[0], cfg.num_frames, cfg.n_contrast_bands + 1)),
    )
    grid = [
        dict(use_mfcc=mfcc, use_spectral_contrast=con, use_pcen=pcen, n_mels=mels, hop_length=hop)
        for mfcc in (True, False) for con in (True, False) for pcen in (True, False)
        for mels, hop in ((64, 160), (256, 4))
    ]
    for kw in grid:
        cfg, jcfg = FeatureConfig(**kw), JaxFeatureConfig(**kw)
        for n in (cfg.segment_samples, cfg.segment_samples - 1, cfg.segment_samples + 400):
            called.clear()
            jax_kernel.extract_features_fused(np.zeros((1, n), np.float32), jcfg, interpret=True)
            assert frontend_kernel.kernel_supports(cfg, n) == ("kernel" in called), (kw, n, called)


@pytest.mark.parametrize("name", ["mels160", "clip10s"])
def test_custom_ops_fakes_at_the_new_geometry(name):
    """The custom ops' fakes (what torch.export traces) give the real
    shapes at more than 128 mels and at 1001 frames."""
    cfg = _cfg(name)
    args = frontend_kernel._op_args(cfg)
    w = torch.from_numpy(_waves(cfg, 2, seed=3))
    mel = torch.ops.cdt.power_mel(w, *args)
    assert mel.shape == (2, cfg.n_mels, cfg.num_frames)
    torch.library.opcheck(torch.ops.cdt.power_mel.default, (w, *args))
    torch.library.opcheck(torch.ops.cdt.mel_epilogue.default, (mel, *args))
