"""Fused front end: raw waveform batch → stacked feature image, in
hand-written CUDA kernels (csrc/frontend_kernel.cu).

The port of `cough_detector_tpu/ops/pallas/frontend_kernel.py`. It covers
every in-kernel branch of the Pallas kernel: the dB and PCEN mel branches,
MFCCs with deltas and optional delta-deltas, and pre-emphasis; and the
contrast rows its launcher appends.

`extract_features_fused` runs the pair through its two wrappers:
`power_mel_fused` (launch A: framing, windowed DFT, power, mel, on the
tensor cores in 3xTF32) and `mel_epilogue_fused` (launch B: log, dB or
PCEN, DCT, z-norm, deltas, FP32 with frames across threads). On a CUDA tensor each launches its kernel or
raises, and adds one to its counter, `SPECTRAL_LAUNCHES` or
`EPILOGUE_LAUNCHES`; on a CPU tensor each runs its plain version
(`power_mel_reference`, `mel_epilogue_reference`): the same function in
plain torch ops, with the band-limited windowed DFT as two FP32 matmuls and
the shared epilogue of ops/frontend.py. `frontend_kernel_reference` chains
the two plain versions. `power_mel_split_reference` models launch A's
TF32 operand splitting on any device; tests and chip_smoke.py hold the
kernel and the JAX package against it.

For a config with spectral contrast, `extract_features_fused` is the JAX
launcher's hybrid in three launches: the pair runs on the config without
contrast, and the contrast launch (`spectral_contrast_fused`: framing, one
3xTF32 DFT over both windows, band tails by stable rank, centroid, z-norm;
counter `CONTRAST_LAUNCHES`) appends the contrast rows of the
un-emphasized waves. Its plain version is `spectral_contrast_reference`
(`frontend.spectral_contrast(method="gemm")`), its arithmetic's model
`spectral_contrast_split_reference`. The pair's launches compute no
contrast rows and refuse a contrast config.

Unlike the JAX launcher, a config the kernel does not cover (no MFCC, or a
waveform length other than segment_samples) raises ValueError instead of
running the plain chain. On a CUDA tensor the launches also
raise for what the card cannot take: more than 128 mels or a hop under 8
samples (launch A), more than 16 contrast bands or a band past 128 bins
(the contrast launch), or a block's shared memory past the card's 227 KB
(any launch). `card_supports` is the predicate callers route on
(ops/frontend.py::extract_features_fast, the detector's warning): it
holds exactly when every launch the config needs takes it on the card,
and is computed from the config alone (`spectral_smem_bytes`,
`epilogue_smem_bytes` and `contrast_smem_bytes` mirror the kernels'
layouts), so it needs neither the built library nor a card.

Each launch is also registered as a torch custom op, `cdt::power_mel`,
`cdt::mel_epilogue` and `cdt::spectral_contrast`, taking the config as
plain numbers: under torch.compile or torch.export
`extract_features_fused` calls those, so a traced program
(models/export.py) holds the launches as opaque nodes and runs the same
wrappers, counters included, when it is called.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from ..config import FeatureConfig
from . import filters
from .frontend import (
    contrast_band_edges, contrast_from_spectra, frame_signal, pre_emphasis,
    spectral_contrast, stack_features,
)

# Launches of each kernel since import (or since a caller last set it to 0),
# replays of captured programs included (utils/graphs.py adds a graph's
# captured launches on every replay).
SPECTRAL_LAUNCHES = 0
EPILOGUE_LAUNCHES = 0
CONTRAST_LAUNCHES = 0
LAUNCH_COUNTERS = ("SPECTRAL_LAUNCHES", "EPILOGUE_LAUNCHES", "CONTRAST_LAUNCHES")

_MAX_SMEM = 232448  # bytes of shared memory one block may use on sm_90
_MAX_BLOCKS = 2**31 - 1  # a launch's grid x; launch A folds the clip into it
_MEL_TILES = (4, 8, 16)  # launch A's mel widths, in n-tiles of 8 mels
_PASS_COLS = 256  # launch A's DFT columns per pass (re and im of 128 bins)
_CHUNK = 4096  # floats in one chunk of launch A's table stream (16 KB)
_ROWS_A = 128  # frames one launch A block owns
_SLOTS_A = 2  # launch A's smallest ring
_BARRIERS_A = 12 * 4  # bytes of launch A's ring barriers and counters (4 slots)
_RED_B = 32  # floats of launch B's reduction slots
_RED_C = 16  # floats of the contrast launch's reduction slots
_MAX_BANDS = 16  # contrast bands the contrast launch takes
_MAX_BAND_BINS = 128  # bins of its widest band: 4 a lane of the warp that selects it


def kernel_supports(cfg: FeatureConfig, n_samples: int) -> bool:
    """Whether the fused kernel computes this config at this length (with
    spectral contrast, through the hybrid)."""
    return cfg.use_mfcc and n_samples == cfg.segment_samples


def _support(cfg: FeatureConfig) -> tuple:
    """[j0, j1): the taps where the window is nonzero, and kpad, j1 - j0
    rounded up to two k-steps of 8 taps (launch A's DFT depth)."""
    c, _ = filters.dft_matrices(cfg.n_fft, cfg.win_length)
    support = np.nonzero(np.any(c != 0, axis=1))[0]
    j0, j1 = int(support[0]), int(support[-1]) + 1
    return j0, j1, -(-(j1 - j0) // 16) * 16


def _span_floats(hop: int, kpad: int) -> int:
    """The staged waveform span of a 128-frame tile, as LayoutA counts it:
    `skew` pad floats after every hop samples."""
    skew = (4 - hop) % 8
    return ((((_ROWS_A - 1) * hop + kpad) // hop + 1) * (hop + skew) + 3) // 4 * 4


def spectral_smem_bytes(hop: int, kpad: int) -> int:
    """Launch A's shared memory with its smallest ring, as
    csrc/frontend_kernel.cu's LayoutA counts it (cdt_frontend_smem_a)."""
    return 4 * (_SLOTS_A * _CHUNK + _span_floats(hop, kpad)) + _BARRIERS_A


def epilogue_smem_bytes(cfg: FeatureConfig) -> int:
    """Launch B's shared memory, as csrc/frontend_kernel.cu's LayoutB counts
    it (cdt_frontend_smem_b): reduction slots, the DCT table padded to whole
    passes of its DCT (8, 16 or 32 MFCCs a pass), the clip's power mel; the
    MFCC tile and, with delta-deltas, the delta tile take the mel tile's
    rows where n_mfcc <= 32 and 2 * n_mfcc <= n_mels, and follow it
    otherwise."""
    m, c, t = cfg.n_mels, cfg.n_mfcc, cfg.num_frames
    kc = 8 if c <= 8 else 16 if c <= 16 else 32
    floats = m * -(-c // kc) * kc + m * t
    if not (c <= 32 and 2 * c <= m):
        floats += (2 if cfg.use_delta_delta else 1) * c * t
    return 4 * (_RED_B + floats)


def spectral_grid(batch: int, n_frames: int) -> int:
    """Launch A's blocks, all on grid x: `batch` clips of `n_frames`
    frames, each in ceil(n_frames / 128) row tiles. The kernel folds the
    clip into grid x (block i is clip i // tiles, row tile i % tiles), so a
    batch is bounded by grid x's 2^31 - 1 blocks, not by grid y's 65,535."""
    return batch * -(-n_frames // _ROWS_A)


def spectral_block(block: int, n_frames: int) -> tuple:
    """(clip, first frame) of launch A's block `block`, as the kernel
    computes them from blockIdx.x."""
    tiles = -(-n_frames // _ROWS_A)
    return block // tiles, block % tiles * _ROWS_A


def _spectral_refusal(cfg: FeatureConfig) -> str:
    """Why launch A cannot take this config on the card ('' if it can)."""
    if cfg.n_mels > 8 * _MEL_TILES[-1] or cfg.hop_length < 8:
        return (
            f"the spectral kernel takes at most {8 * _MEL_TILES[-1]} mels and a hop "
            f"of at least 8 samples, got {cfg.n_mels} and {cfg.hop_length}"
        )
    smem = spectral_smem_bytes(cfg.hop_length, _support(cfg)[2])
    if smem > _MAX_SMEM:
        return _smem_refusal(smem, cfg)
    return ""


def _smem_refusal(smem: int, cfg: FeatureConfig) -> str:
    return (
        f"config needs {smem} bytes of shared memory per block, "
        f"more than the card's {_MAX_SMEM}: {cfg}"
    )


def card_supports(cfg: FeatureConfig, n_samples: int) -> bool:
    """Whether every launch the config needs takes it at this length on the
    card: `kernel_supports`, launch A's limits (at most 128 mels, a hop of
    at least 8 samples, its shared memory), launch B's shared memory and,
    for a config with spectral contrast, the contrast launch's limits (at
    most 16 bands of at most 128 bins, its shared memory)."""
    return (
        kernel_supports(cfg, n_samples)
        and not _spectral_refusal(cfg)
        and epilogue_smem_bytes(cfg) <= _MAX_SMEM
        and not (cfg.use_spectral_contrast and _contrast_refusal(cfg))
    )


def _no_contrast(cfg: FeatureConfig) -> None:
    if cfg.use_spectral_contrast:
        raise ValueError(
            "the front-end launches compute no spectral contrast rows: pass "
            "the config without contrast (extract_features_fused appends them)"
        )


def _check_config(cfg: FeatureConfig, n_samples: int) -> None:
    if not kernel_supports(cfg, n_samples):
        raise ValueError(
            f"the fused front-end kernel needs use_mfcc=True and waveforms of "
            f"segment_samples={cfg.segment_samples}; got use_mfcc="
            f"{cfg.use_mfcc} and length {n_samples} "
            f"(ops.frontend.extract_features covers every config)"
        )
    _no_contrast(cfg)


class _Constants(NamedTuple):
    cos: torch.Tensor  # (n_fft, n_used) windowed cos
    sin: torch.Tensor  # (n_fft, n_used) windowed -sin
    fb: torch.Tensor   # (n_used, n_mels)
    dct: torch.Tensor  # (n_mels, n_mfcc)
    n_used: int        # DFT bins that feed any mel band
    j0: int            # window support [j0, j1) within the frame
    j1: int
    kpad: int          # j1 - j0 rounded up to two k-steps of 8 taps
    n_bins: int        # n_used rounded up to 8 (sets launch A's DFT passes)
    mel_tiles: int     # n_mels in n-tiles of 8, rounded up to _MEL_TILES
                       # (0: more mels than launch A takes)
    table: torch.Tensor  # launch A's chunk stream (see _constants)


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32 as `cvt.rna.tf32.f32` rounds it (to nearest,
    ties away from zero): add 0x1000 to the bits and clear the low 13."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _split(x: torch.Tensor) -> tuple:
    """hi + lo ≈ x, each a TF32 value; x - hi is exact in float32."""
    hi = tf32_round(x)
    return hi, tf32_round(x - hi)


def _tiles(m: np.ndarray) -> torch.Tensor:
    """The hi/lo TF32 split of a (K, N) matrix, K and N multiples of 8, as
    the B tiles launch A's wgmma reads (K-major, no swizzle): (K / 8, 16 N),
    per k-step of 8 rows the hi tile then the lo tile, each N / 8 column
    groups x 2 row groups of 4 x 8 columns x 4 rows."""
    k, n = m.shape
    v = torch.from_numpy(np.ascontiguousarray(m, np.float32))
    v = v.reshape(k // 8, 2, 4, n // 8, 8).permute(0, 3, 1, 4, 2)  # s nc kc n kk
    hi, lo = _split(v.contiguous())
    return torch.stack([hi, lo], dim=1).reshape(k // 8, 16 * n)


@functools.lru_cache(maxsize=16)
def _constants(cfg: FeatureConfig, device: torch.device) -> _Constants:
    """Band-limited tables: bins past the filterbank's last nonzero row feed
    no mel band, so the DFT stops there (128 of 257 bins at f_max=4 kHz).
    Launch A's tables are split into hi/lo TF32 here, once per config, and
    laid out as the stream of 16 KB chunks its ring reads: per pass of 256
    DFT columns (128 bins), one chunk per k-step of the DFT over the
    window's support [j0, j0 + kpad), its cos and -sin columns interleaved
    bin by bin (zero past n_used), then the filterbank's rows for the
    pass's bins (zero past n_used), 16 k-steps of 8 * mel_tiles mels (zero
    past n_mels), 256 / (8 * mel_tiles) k-steps a chunk."""
    c, s = filters.dft_matrices(cfg.n_fft, cfg.win_length)
    fb = filters.mel_filterbank(
        cfg.n_fft // 2 + 1, cfg.n_mels, cfg.sample_rate, cfg.f_min, cfg.f_max
    )
    n_used = int(np.max(np.nonzero(np.any(fb != 0, axis=1))[0])) + 1
    j0, j1, kpad = _support(cfg)
    dct = filters.dct_matrix(cfg.n_mfcc, cfg.n_mels)

    n_bins = -(-n_used // 8) * 8
    n_passes = -(-2 * n_bins // _PASS_COLS)
    table = np.zeros((kpad, n_passes * _PASS_COLS), np.float32)
    table[: j1 - j0, 0 : 2 * n_used : 2] = c[j0:j1, :n_used]
    table[: j1 - j0, 1 : 2 * n_used : 2] = s[j0:j1, :n_used]
    mel_tiles = next((m for m in _MEL_TILES if 8 * m >= cfg.n_mels), 0)
    mel_cols = 8 * (mel_tiles or -(-cfg.n_mels // 8))
    fb_pad = np.zeros((n_passes * _PASS_COLS // 2, mel_cols), np.float32)
    fb_pad[:n_used, : cfg.n_mels] = fb[:n_used]
    stream = []
    for p in range(n_passes):
        stream.append(_tiles(table[:, p * _PASS_COLS : (p + 1) * _PASS_COLS]))
        bins = slice(p * _PASS_COLS // 2, (p + 1) * _PASS_COLS // 2)
        stream.append(_tiles(fb_pad[bins]).reshape(-1, _CHUNK))

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(device)

    return _Constants(
        dev(c[:, :n_used]), dev(s[:, :n_used]), dev(fb[:n_used]), dev(dct),
        n_used, j0, j1, kpad, n_bins, mel_tiles, torch.cat(stream).reshape(-1).to(device),
    )


def _check_mel(cfg: FeatureConfig, mel: torch.Tensor) -> None:
    want = (cfg.n_mels, cfg.num_frames)
    if not cfg.use_mfcc or mel.ndim != 3 or tuple(mel.shape[1:]) != want:
        raise ValueError(
            f"the fused epilogue needs use_mfcc=True and a (B, n_mels, "
            f"num_frames) = (B, {want[0]}, {want[1]}) power mel; got use_mfcc="
            f"{cfg.use_mfcc} and shape {tuple(mel.shape)}"
        )
    _no_contrast(cfg)


def _frames(waves: torch.Tensor, cfg: FeatureConfig) -> torch.Tensor:
    """(B, segment_samples) → (B, num_frames, n_fft): pre-emphasis, reflect
    pad, framing."""
    if cfg.use_pre_emphasis:
        waves = pre_emphasis(waves, cfg.pre_emphasis_coef)
    half = cfg.n_fft // 2
    return F.pad(waves, (half, half), mode="reflect").unfold(
        -1, cfg.n_fft, cfg.hop_length
    )


def power_mel_reference(
    waves: torch.Tensor, cfg: FeatureConfig = FeatureConfig()
) -> torch.Tensor:
    """Launch A's function in plain torch ops, FP32 matmuls:
    (B, segment_samples) → power mel (B, n_mels, num_frames)."""
    _check_config(cfg, waves.shape[-1])
    k = _constants(cfg, waves.device)
    frames = _frames(waves, cfg)
    re = frames @ k.cos
    im = frames @ k.sin
    return ((re * re + im * im) @ k.fb).transpose(1, 2)


def _split_matmul(a: torch.Tensor, b: torch.Tensor, passes: int) -> torch.Tensor:
    if passes == 1:
        return tf32_round(a) @ tf32_round(b)
    (a_hi, a_lo), (b_hi, b_lo) = _split(a), _split(b)
    return (a_lo @ b_hi + a_hi @ b_lo) + a_hi @ b_hi


def power_mel_split_reference(
    waves: torch.Tensor, cfg: FeatureConfig = FeatureConfig(), passes: int = 3
) -> torch.Tensor:
    """Launch A's arithmetic in plain torch ops: (B, segment_samples) →
    power mel (B, n_mels, num_frames), the DFT and the mel each with TF32
    operands. passes=3 is the kernel's 3xTF32: both operands split into
    hi + lo (`tf32_round`), then a_lo·b_hi + a_hi·b_lo and a_hi·b_hi.
    passes=1 is a single TF32 product. Every product of two TF32 values is
    exact in float32, so only the sums round: the kernel adds the three
    products k-step by k-step (8 taps) into one accumulator, this model sums
    each over all of K first, a difference far below the 1e-3 budget. For
    tests and chip_smoke.py; nothing on the main path calls it."""
    _check_config(cfg, waves.shape[-1])
    if passes not in (1, 3):
        raise ValueError(f"passes must be 1 or 3, got {passes}")
    k = _constants(cfg, waves.device)
    frames = _frames(waves, cfg)[..., k.j0 : k.j1]
    re = _split_matmul(frames, k.cos[k.j0 : k.j1], passes)
    im = _split_matmul(frames, k.sin[k.j0 : k.j1], passes)
    return _split_matmul(re * re + im * im, k.fb, passes).transpose(1, 2)


def mel_epilogue_reference(
    mel: torch.Tensor, cfg: FeatureConfig = FeatureConfig()
) -> torch.Tensor:
    """Launch B's arithmetic in plain torch ops: power mel
    (B, n_mels, num_frames) → (B, num_features, num_frames)."""
    _check_mel(cfg, mel)
    return stack_features(mel.transpose(1, 2), cfg)


def frontend_kernel_reference(
    waves: torch.Tensor, cfg: FeatureConfig = FeatureConfig()
) -> torch.Tensor:
    """The kernel pair's arithmetic in plain torch ops: (B, segment_samples)
    → (B, num_features, num_frames)."""
    return mel_epilogue_reference(power_mel_reference(waves, cfg), cfg)


@functools.lru_cache(maxsize=1)
def build() -> ctypes.CDLL:
    """The kernel library, built and loaded on first call, with its C
    signatures declared."""
    from ..utils import kernel_build

    lib = kernel_build.load("frontend_kernel")
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.cdt_frontend_spectral.argtypes = [
        p, i, i, i, i, i, i, i, p, i, i, i, i, f, p, p,
    ]
    lib.cdt_frontend_spectral.restype = i
    lib.cdt_frontend_epilogue.argtypes = [p, i, i, i, p, i, i, i, i, p, p]
    lib.cdt_frontend_epilogue.restype = i
    lib.cdt_frontend_smem_a.argtypes = [i, i]
    lib.cdt_frontend_smem_a.restype = ctypes.c_size_t
    lib.cdt_frontend_smem_b.argtypes = [i, i, i, i]
    lib.cdt_frontend_smem_b.restype = ctypes.c_size_t
    ints = ctypes.POINTER(i)
    lib.cdt_frontend_contrast.argtypes = [
        p, i, i, i, i, i, i, i, p, i, i, i, p, f, i, ints, ints, ints, ints, p, p,
    ]
    lib.cdt_frontend_contrast.restype = i
    lib.cdt_frontend_smem_c.argtypes = [i, i, i, i, i]
    lib.cdt_frontend_smem_c.restype = ctypes.c_size_t
    lib.cdt_error_string.argtypes = [i]
    lib.cdt_error_string.restype = ctypes.c_char_p
    return lib


def _check_cuda(x: torch.Tensor, ndim: int, name: str) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if x.dtype != torch.float32 or x.ndim != ndim:
        raise ValueError(
            f"expected a {ndim}-d float32 tensor for {name}, got "
            f"{tuple(x.shape)} {x.dtype}"
        )
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _raise_on(err: int, lib: ctypes.CDLL, kernel: str) -> None:
    if err:
        raise RuntimeError(
            f"frontend {kernel} kernel launch failed: "
            f"{lib.cdt_error_string(err).decode()} (cudaError {err})"
        )


def power_mel_fused(
    waves: torch.Tensor, cfg: FeatureConfig = FeatureConfig()
) -> torch.Tensor:
    """Launch A: (B, segment_samples) float32 → power mel
    (B, n_mels, num_frames). CUDA tensors launch the kernel on the current
    stream (no synchronise); CPU tensors run power_mel_reference."""
    global SPECTRAL_LAUNCHES
    _check_config(cfg, waves.shape[-1])
    if waves.device.type == "cpu":
        return power_mel_reference(waves, cfg)
    _check_cuda(waves, 2, "waves")
    b = waves.shape[0]
    t, n_mels = cfg.num_frames, cfg.n_mels
    if spectral_grid(b, t) > _MAX_BLOCKS:
        raise ValueError(f"batch {b} needs more than the spectral kernel's {_MAX_BLOCKS} blocks")
    mel = torch.empty((b, n_mels, t), dtype=torch.float32, device=waves.device)
    if b == 0:
        return mel
    refusal = _spectral_refusal(cfg)
    if refusal:
        raise ValueError(refusal)
    k = _constants(cfg, waves.device)
    lib = build()
    with torch.cuda.device(waves.device):
        err = lib.cdt_frontend_spectral(
            waves.data_ptr(), b, waves.shape[1], t, cfg.n_fft,
            cfg.hop_length, k.j0, k.kpad, k.table.data_ptr(), k.n_bins,
            n_mels, k.mel_tiles, int(cfg.use_pre_emphasis),
            float(cfg.pre_emphasis_coef), mel.data_ptr(),
            torch.cuda.current_stream().cuda_stream,
        )
    _raise_on(err, lib, "spectral")
    SPECTRAL_LAUNCHES += 1
    return mel


def mel_epilogue_fused(
    mel: torch.Tensor, cfg: FeatureConfig = FeatureConfig()
) -> torch.Tensor:
    """Launch B: power mel (B, n_mels, num_frames) float32 →
    (B, num_features, num_frames). CUDA tensors launch the kernel on the
    current stream (no synchronise); CPU tensors run
    mel_epilogue_reference."""
    global EPILOGUE_LAUNCHES
    _check_mel(cfg, mel)
    if mel.device.type == "cpu":
        return mel_epilogue_reference(mel, cfg)
    _check_cuda(mel, 3, "mel")
    b, t = mel.shape[0], cfg.num_frames
    out = torch.empty((b, cfg.num_features, t), dtype=torch.float32, device=mel.device)
    if b == 0:
        return out
    smem = epilogue_smem_bytes(cfg)
    if smem > _MAX_SMEM:
        raise ValueError(_smem_refusal(smem, cfg))
    lib = build()
    dct = _constants(cfg, mel.device).dct
    with torch.cuda.device(mel.device):
        err = lib.cdt_frontend_epilogue(
            mel.data_ptr(), b, t, cfg.n_mels, dct.data_ptr(), cfg.n_mfcc,
            int(cfg.use_pcen), int(cfg.use_delta_delta), cfg.num_features,
            out.data_ptr(), torch.cuda.current_stream().cuda_stream,
        )
    _raise_on(err, lib, "epilogue")
    EPILOGUE_LAUNCHES += 1
    return out


# -- the contrast launch ------------------------------------------------------------


class _ContrastGeometry(NamedTuple):
    j0: int          # [j0, j1): taps where either window is nonzero
    j1: int
    kpad: int        # j1 - j0 rounded up to two k-steps of 8 taps
    pow_lo: int      # the bands read power bins [pow_lo, pow_lo + n_pow)
    n_pow: int
    n_freqs: int     # magnitude bins, all of them, for the centroid
    n_passes: int    # DFT passes of 256 columns: power pairs, then magnitude pairs
    offsets: tuple   # per band: first bin, from pow_lo
    widths: tuple    # per band: bins
    tops: tuple      # per band: bins in the top tail
    bots: tuple      # per band: bins in the bottom tail


@functools.lru_cache(maxsize=32)
def _geometry(cfg: FeatureConfig) -> _ContrastGeometry:
    """The contrast launch's shapes, from the bands of
    ops/frontend.py::contrast_from_spectra and the supports of its two
    windows (the win_length Hann for the bands' power, the n_fft Hann for
    the centroid's magnitude)."""
    n_freqs = cfg.n_fft // 2 + 1
    edges = contrast_band_edges(n_freqs, cfg.n_contrast_bands)
    lows, widths, tops, bots = [], [], [], []
    for i in range(cfg.n_contrast_bands):
        low = int(edges[i])
        high = min(max(int(edges[i + 1]), low + 1), n_freqs)
        n = high - low
        lows.append(low)
        widths.append(n)
        tops.append(n - min(max(1, int(n * 0.8)), n - 1) if n > 1 else 1)
        bots.append(max(1, int(n * 0.2)))
    pow_lo = int(edges[0])
    n_pow = max((lo + n for lo, n in zip(lows, widths)), default=pow_lo) - pow_lo
    c4, _ = filters.dft_matrices(cfg.n_fft, cfg.win_length)
    c5, _ = filters.dft_matrices(cfg.n_fft, cfg.n_fft)
    support = np.nonzero(np.any(c4 != 0, axis=1) | np.any(c5 != 0, axis=1))[0]
    j0, j1 = int(support[0]), int(support[-1]) + 1
    return _ContrastGeometry(
        j0, j1, -(-(j1 - j0) // 16) * 16, pow_lo, n_pow, n_freqs,
        -(-2 * (n_pow + n_freqs) // _PASS_COLS), tuple(lo - pow_lo for lo in lows),
        tuple(widths), tuple(tops), tuple(bots),
    )


def contrast_smem_bytes(cfg: FeatureConfig) -> int:
    """The contrast launch's shared memory with its smallest ring, as
    csrc/frontend_kernel.cu's LayoutC counts it (cdt_frontend_smem_c): the
    ring's two slots, the tile's waveform span, the tile's power over the
    bands' bins (128 rows), the clip's contrast rows, reduction slots."""
    g = _geometry(cfg)
    rows = (_ROWS_A * g.n_pow + 3) // 4 * 4
    con = (cfg.num_frames * (cfg.n_contrast_bands + 1) + 3) // 4 * 4
    span = _span_floats(cfg.hop_length, g.kpad)
    return 4 * (_SLOTS_A * _CHUNK + span + rows + con + _RED_C) + _BARRIERS_A


def contrast_grid(batch: int, n_frames: int) -> tuple:
    """(blocks, row tiles a block): the contrast launch takes one clip a
    block, on grid x, and loops over its ceil(n_frames / 128) row tiles,
    since the per-clip z-norm spans every frame."""
    return batch, -(-n_frames // _ROWS_A)


def _contrast_refusal(cfg: FeatureConfig) -> str:
    """Why the contrast launch cannot take this config on the card ('' if
    it can)."""
    g = _geometry(cfg)
    if cfg.n_contrast_bands > _MAX_BANDS or max(g.widths, default=0) > _MAX_BAND_BINS:
        return (
            f"the contrast kernel takes at most {_MAX_BANDS} bands of at most "
            f"{_MAX_BAND_BINS} bins, got {cfg.n_contrast_bands} of up to {max(g.widths)}"
        )
    if cfg.hop_length < 8:
        return f"the contrast kernel takes a hop of at least 8 samples, got {cfg.hop_length}"
    smem = contrast_smem_bytes(cfg)
    if smem > _MAX_SMEM:
        return _smem_refusal(smem, cfg)
    return ""


class _ContrastConstants(NamedTuple):
    cols: torch.Tensor   # (j1 - j0, 2 (n_pow + n_freqs)): the DFT columns
    table: torch.Tensor  # the chunk stream the contrast launch's ring reads
    freqs: torch.Tensor  # (n_freqs,): the centroid's bin frequencies


@functools.lru_cache(maxsize=16)
def _contrast_constants(cfg: FeatureConfig, device: torch.device) -> _ContrastConstants:
    """The contrast launch's DFT over both windows' support [j0, j1): per
    power bin of the bands (win_length window) its cos and -sin columns,
    interleaved, then the same for every bin of the n_fft window, zero
    past them. Split into hi/lo TF32 here, once per config, and laid out
    as launch A's tables are (`_tiles`): per pass of 256 columns, one 16 KB
    chunk per k-step of 8 taps over [j0, j0 + kpad)."""
    g = _geometry(cfg)
    c4, s4 = filters.dft_matrices(cfg.n_fft, cfg.win_length)
    c5, s5 = filters.dft_matrices(cfg.n_fft, cfg.n_fft)
    taps, bins, p2 = slice(g.j0, g.j1), slice(g.pow_lo, g.pow_lo + g.n_pow), 2 * g.n_pow
    table = np.zeros((g.kpad, g.n_passes * _PASS_COLS), np.float32)
    table[: g.j1 - g.j0, 0:p2:2] = c4[taps, bins]
    table[: g.j1 - g.j0, 1:p2:2] = s4[taps, bins]
    table[: g.j1 - g.j0, p2 : p2 + 2 * g.n_freqs : 2] = c5[taps]
    table[: g.j1 - g.j0, p2 + 1 : p2 + 2 * g.n_freqs : 2] = s5[taps]
    stream = torch.cat([
        _tiles(table[:, p * _PASS_COLS : (p + 1) * _PASS_COLS]) for p in range(g.n_passes)
    ])
    freqs = np.linspace(0, cfg.sample_rate // 2, g.n_freqs, dtype=np.float32)
    cols = table[: g.j1 - g.j0, : 2 * (g.n_pow + g.n_freqs)]
    return _ContrastConstants(
        torch.from_numpy(np.ascontiguousarray(cols)).to(device),
        stream.reshape(-1).to(device), torch.from_numpy(freqs).to(device),
    )


def _check_contrast(cfg: FeatureConfig, n_samples: int) -> None:
    if n_samples != cfg.segment_samples:
        raise ValueError(
            f"the contrast kernel needs waveforms of segment_samples="
            f"{cfg.segment_samples}, got length {n_samples} "
            f"(ops.frontend.spectral_contrast covers every length)"
        )


def spectral_contrast_reference(
    waves: torch.Tensor, cfg: FeatureConfig = FeatureConfig(use_spectral_contrast=True)
) -> torch.Tensor:
    """The contrast launch's function in plain torch ops:
    (B, segment_samples) → contrast rows (B, n_contrast_bands + 1,
    num_frames), by `spectral_contrast(method="gemm")` (one FP32 DFT
    matmul over both windows, cuBLAS's TF32 off, `torch.topk` tails)."""
    _check_contrast(cfg, waves.shape[-1])
    return spectral_contrast(waves, cfg, method="gemm").transpose(1, 2)


def spectral_contrast_split_reference(
    waves: torch.Tensor, cfg: FeatureConfig = FeatureConfig(use_spectral_contrast=True),
    passes: int = 3,
) -> torch.Tensor:
    """The contrast launch's arithmetic in plain torch ops: (B,
    segment_samples) → (B, n_contrast_bands + 1, num_frames), its DFT with
    TF32 operands over both windows' support (passes=3: the kernel's
    3xTF32, as `power_mel_split_reference` models launch A's; passes=1: one
    TF32 product), its tails by stable rank as the kernel selects them.
    For tests and chip_smoke.py; nothing on the main path calls it."""
    _check_contrast(cfg, waves.shape[-1])
    if passes not in (1, 3):
        raise ValueError(f"passes must be 1 or 3, got {passes}")
    g = _geometry(cfg)
    k = _contrast_constants(cfg, waves.device)
    frames = frame_signal(waves, cfg.n_fft, cfg.hop_length)[..., g.j0 : g.j1]
    out = _split_matmul(frames, k.cols, passes)
    sq = out[..., 0::2] ** 2 + out[..., 1::2] ** 2
    spec = torch.zeros(sq.shape[:2] + (g.n_freqs,), dtype=sq.dtype, device=sq.device)
    spec[..., g.pow_lo : g.pow_lo + g.n_pow] = sq[..., : g.n_pow]
    mag = torch.sqrt(sq[..., g.n_pow :])
    return contrast_from_spectra(spec, mag, cfg, tails="rank").transpose(1, 2)


def spectral_contrast_fused(
    waves: torch.Tensor, cfg: FeatureConfig = FeatureConfig(use_spectral_contrast=True)
) -> torch.Tensor:
    """The contrast launch: (B, segment_samples) float32, not pre-emphasized
    → contrast rows (B, n_contrast_bands + 1, num_frames). CUDA tensors
    launch the kernel on the current stream (no synchronise); CPU tensors
    run spectral_contrast_reference."""
    global CONTRAST_LAUNCHES
    _check_contrast(cfg, waves.shape[-1])
    if waves.device.type == "cpu":
        return spectral_contrast_reference(waves, cfg)
    _check_cuda(waves, 2, "waves")
    b, t = waves.shape[0], cfg.num_frames
    if contrast_grid(b, t)[0] > _MAX_BLOCKS:
        raise ValueError(f"batch {b} needs more than the contrast kernel's {_MAX_BLOCKS} blocks")
    out = torch.empty((b, cfg.n_contrast_bands + 1, t), dtype=torch.float32, device=waves.device)
    if b == 0:
        return out
    refusal = _contrast_refusal(cfg)
    if refusal:
        raise ValueError(refusal)
    g = _geometry(cfg)
    k = _contrast_constants(cfg, waves.device)
    lib = build()
    n = cfg.n_contrast_bands
    bands = [(ctypes.c_int * max(n, 1))(*v) for v in (g.offsets, g.widths, g.tops, g.bots)]
    with torch.cuda.device(waves.device):
        err = lib.cdt_frontend_contrast(
            waves.data_ptr(), b, waves.shape[1], t, cfg.n_fft, cfg.hop_length,
            g.j0, g.kpad, k.table.data_ptr(), g.n_passes, g.n_pow, g.n_freqs,
            k.freqs.data_ptr(), float(cfg.sample_rate / 2.0), n, *bands,
            out.data_ptr(), torch.cuda.current_stream().cuda_stream,
        )
    _raise_on(err, lib, "contrast")
    CONTRAST_LAUNCHES += 1
    return out


# -- the launches as custom ops --------------------------------------------------


def _op_args(cfg: FeatureConfig) -> tuple:
    """The config as the custom ops take it: every field, in order."""
    return dataclasses.astuple(cfg)


@torch.library.custom_op("cdt::power_mel", mutates_args=())
def _power_mel_op(
    waves: torch.Tensor, sample_rate: int, n_mels: int, n_fft: int, hop_length: int,
    win_length: int, f_min: float, f_max: float, segment_duration: float, n_mfcc: int,
    use_mfcc: bool, use_pcen: bool, use_pre_emphasis: bool, pre_emphasis_coef: float,
    use_delta_delta: bool, use_spectral_contrast: bool, n_contrast_bands: int,
) -> torch.Tensor:
    """Launch A (`power_mel_fused`): the kernel on a CUDA tensor, or a raise;
    its plain version on a CPU tensor. The result is contiguous, as the
    fake's is."""
    cfg = FeatureConfig(
        sample_rate, n_mels, n_fft, hop_length, win_length, f_min, f_max, segment_duration,
        n_mfcc, use_mfcc, use_pcen, use_pre_emphasis, pre_emphasis_coef, use_delta_delta,
        use_spectral_contrast, n_contrast_bands,
    )
    return power_mel_fused(waves.contiguous(), cfg).contiguous()


@_power_mel_op.register_fake
def _(waves, *fields):
    cfg = FeatureConfig(*fields)
    return waves.new_empty((waves.shape[0], cfg.n_mels, cfg.num_frames))


@torch.library.custom_op("cdt::mel_epilogue", mutates_args=())
def _mel_epilogue_op(
    mel: torch.Tensor, sample_rate: int, n_mels: int, n_fft: int, hop_length: int,
    win_length: int, f_min: float, f_max: float, segment_duration: float, n_mfcc: int,
    use_mfcc: bool, use_pcen: bool, use_pre_emphasis: bool, pre_emphasis_coef: float,
    use_delta_delta: bool, use_spectral_contrast: bool, n_contrast_bands: int,
) -> torch.Tensor:
    """Launch B (`mel_epilogue_fused`): the kernel on a CUDA tensor, or a
    raise; its plain version on a CPU tensor."""
    cfg = FeatureConfig(
        sample_rate, n_mels, n_fft, hop_length, win_length, f_min, f_max, segment_duration,
        n_mfcc, use_mfcc, use_pcen, use_pre_emphasis, pre_emphasis_coef, use_delta_delta,
        use_spectral_contrast, n_contrast_bands,
    )
    return mel_epilogue_fused(mel.contiguous(), cfg).contiguous()


@_mel_epilogue_op.register_fake
def _(mel, *fields):
    cfg = FeatureConfig(*fields)
    return mel.new_empty((mel.shape[0], cfg.num_features, cfg.num_frames))


@torch.library.custom_op("cdt::spectral_contrast", mutates_args=())
def _spectral_contrast_op(
    waves: torch.Tensor, sample_rate: int, n_mels: int, n_fft: int, hop_length: int,
    win_length: int, f_min: float, f_max: float, segment_duration: float, n_mfcc: int,
    use_mfcc: bool, use_pcen: bool, use_pre_emphasis: bool, pre_emphasis_coef: float,
    use_delta_delta: bool, use_spectral_contrast: bool, n_contrast_bands: int,
) -> torch.Tensor:
    """The contrast launch (`spectral_contrast_fused`): the kernel on a CUDA
    tensor, or a raise; its plain version on a CPU tensor."""
    cfg = FeatureConfig(
        sample_rate, n_mels, n_fft, hop_length, win_length, f_min, f_max, segment_duration,
        n_mfcc, use_mfcc, use_pcen, use_pre_emphasis, pre_emphasis_coef, use_delta_delta,
        use_spectral_contrast, n_contrast_bands,
    )
    return spectral_contrast_fused(waves.contiguous(), cfg).contiguous()


@_spectral_contrast_op.register_fake
def _(waves, *fields):
    cfg = FeatureConfig(*fields)
    return waves.new_empty((waves.shape[0], cfg.n_contrast_bands + 1, cfg.num_frames))


def _pair(waves: torch.Tensor, cfg: FeatureConfig) -> torch.Tensor:
    """Both launches; through the custom ops while torch traces."""
    if torch.compiler.is_compiling():
        args = _op_args(cfg)
        return torch.ops.cdt.mel_epilogue(torch.ops.cdt.power_mel(waves, *args), *args)
    return mel_epilogue_fused(power_mel_fused(waves, cfg), cfg)


def _contrast(waves: torch.Tensor, cfg: FeatureConfig) -> torch.Tensor:
    """The contrast launch; through its custom op while torch traces."""
    if torch.compiler.is_compiling():
        return torch.ops.cdt.spectral_contrast(waves, *_op_args(cfg))
    return spectral_contrast_fused(waves, cfg)


def extract_features_fused(
    waves: torch.Tensor, cfg: FeatureConfig = FeatureConfig()
) -> torch.Tensor:
    """(B, segment_samples) float32 → (B, num_features, num_frames), through
    the launches on CUDA tensors and their plain versions on CPU tensors.
    The power mel between them is dropped on return: the caching allocator
    hands its memory out again only to work queued after launch B.

    A config with spectral contrast runs three launches, the JAX
    launcher's hybrid: the pair on the config without contrast, then the
    contrast launch on the same (un-emphasized) waves, its rows stacked
    last."""
    if cfg.use_spectral_contrast and kernel_supports(cfg, waves.shape[-1]):
        base = dataclasses.replace(cfg, use_spectral_contrast=False)
        return torch.cat([_pair(waves, base), _contrast(waves, cfg)], dim=1)
    return _pair(waves, cfg)
