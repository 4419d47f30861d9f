"""Fused front end: raw waveform batch → stacked feature image, in
hand-written CUDA kernels (csrc/frontend_kernel.cu).

The port of `cough_detector_tpu/ops/pallas/frontend_kernel.py`. It covers
every in-kernel branch of the Pallas kernel: the dB and PCEN mel branches,
MFCCs with deltas and optional delta-deltas, and pre-emphasis; and the
contrast rows its launcher appends.

`extract_features_fused` runs the pair through its two wrappers:
`power_mel_fused` (launch A: framing, windowed DFT, power, mel, on the
tensor cores in 3xTF32, or by FFT: `spectral_plan`) and
`mel_epilogue_fused` (launch B: log, dB or PCEN, DCT, z-norm, deltas, FP32
with frames across threads). On a CUDA tensor each launches its kernel or
raises, and adds one to its counter, `SPECTRAL_LAUNCHES` or
`EPILOGUE_LAUNCHES`; on a CPU tensor each runs its plain version
(`power_mel_reference`, `mel_epilogue_reference`): the same function in
plain torch ops, with the band-limited windowed DFT as two FP32 matmuls and
the shared epilogue of ops/frontend.py. `frontend_kernel_reference` chains
the two plain versions. `power_mel_split_reference` models launch A's
TF32 operand splitting on any device, `power_mel_fft_reference` its FFT
plan's arithmetic; tests and chip_smoke.py hold the kernel and the JAX
package against them.

For a config with spectral contrast, `extract_features_fused` is the JAX
launcher's hybrid in three launches: the pair runs on the config without
contrast, and the contrast launch (`spectral_contrast_fused`: framing, one
3xTF32 DFT over both windows, band tails by stable rank, centroid, z-norm;
or its FFT plan: both windows through one FFT, each band sorted; counter
`CONTRAST_LAUNCHES`, and `CONTRAST_FFT_LAUNCHES` for the FFT plan as
`SPECTRAL_FFT_LAUNCHES` is launch A's) appends the contrast rows of the
un-emphasized waves. Its plain version is `spectral_contrast_reference`
(`frontend.spectral_contrast(method="gemm")`), its arithmetic's model
`spectral_contrast_split_reference` (the FFT plan's:
`spectral_contrast_fft_reference`). The pair's launches compute no
contrast rows and refuse a contrast config.

Unlike the JAX launcher, a config the kernel does not cover (no MFCC, or a
waveform length other than segment_samples) raises ValueError instead of
running the plain chain. Every config the JAX launcher sends to its Pallas
kernel (`kernel_supports`) runs the launches on the card: each launch picks,
from the config alone, a plan that fits the card's 227 KB of shared memory
a block. Launches A and C compute their spectra by FFT for an n_fft whose
rows, Bluestein scratch and tables fit a block, odd or even, from 640 on
(launch A also past 128 mels): the FFT plans (`spectral_plan`,
`contrast_level` 4), Stockham stages of radix 2, 4, 3, 5, 7 and 11, one of
each larger prime factor up to `_FFT_MAX_PRIME`, and one of a prime past
it by Bluestein's chirp-z (on an odd n_fft launch A runs two frames
through one FFT). At any other n_fft (a prime factor past 1997, launch A
past 16384, launch C past 8192) launch
A takes more than 128 mels in groups of at most 128, each its own blocks
(`mel_groups`), and gathers its frames from device memory where a
128-frame tile's waveform span passes shared memory (`spectral_staged`);
launch B holds a clip in one block, across a thread-block cluster of up
to 16 (`epilogue_plan`: the fewest whose blocks fit three an SM, else
two, else one), or past that on its span route, a grid of blocks of up
to 128 frames a clip (`epilogue_spans`) in three launches that fold the
clip's reductions through a scratch buffer of partials
(`epilogue_scratch_floats`; model `mel_epilogue_span_reference`,
counter `EPILOGUE_SPAN_LAUNCHES`); the
contrast launch moves its span, its contrast rows and its power rows out
of shared memory in that order (`contrast_level`), and takes any number
of bands of any width. The
mirrors (`spectral_smem_bytes`, `epilogue_smem_bytes`,
`contrast_smem_bytes` and the plans) follow the kernels' layouts, so
buffers and grids are sized without the built library or a card;
chip_smoke.py holds each against the library's own.

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
import math
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from ..config import FeatureConfig
from . import filters
from .frontend import (
    _AMIN, _DB_SCALE, contrast_band_edges, contrast_from_spectra, frame_signal, pre_emphasis,
    spectral_contrast, stack_features,
)

# Launches of each kernel since import (or since a caller last set it to 0),
# replays of captured programs included (utils/graphs.py adds a graph's
# captured launches on every replay). EPILOGUE_LAUNCHES counts a call of
# launch B once, whatever its route runs (the span route: three kernels).
SPECTRAL_LAUNCHES = 0
EPILOGUE_LAUNCHES = 0
CONTRAST_LAUNCHES = 0
LAUNCH_COUNTERS = ("SPECTRAL_LAUNCHES", "EPILOGUE_LAUNCHES", "CONTRAST_LAUNCHES")
# Of those, the launches of the FFT plans' kernels (spectral_fft_kernel,
# contrast_fft_kernel) and the calls of launch B that took its span route
# (span_mfcc_kernel, span_var_kernel, span_rows_kernel), counted the same
# way.
SPECTRAL_FFT_LAUNCHES = 0
CONTRAST_FFT_LAUNCHES = 0
EPILOGUE_SPAN_LAUNCHES = 0
PLAN_COUNTERS = ("SPECTRAL_FFT_LAUNCHES", "CONTRAST_FFT_LAUNCHES", "EPILOGUE_SPAN_LAUNCHES")

_MAX_SMEM = 232448  # bytes of shared memory one block may use on sm_90
_MAX_BLOCKS = 2**31 - 1  # a launch's grid x; launch A folds the clip into it
_MEL_TILES = (4, 8, 16)  # launch A's mel group widths, in n-tiles of 8 mels
_PASS_COLS = 256  # launch A's DFT columns per pass (re and im of 128 bins)
_CHUNK = 4096  # floats in one chunk of launch A's table stream (16 KB)
_ROWS_A = 128  # frames one launch A block owns
_SLOTS_A = 2  # launch A's smallest ring
_BARRIERS_A = 12 * 4  # bytes of launch A's ring barriers and counters (4 slots)
_RED_B = 32  # floats of launch B's reduction slots
_MAX_CLUSTER = 16  # launch B's largest cluster: blocks a clip (past 8, non-portable)
_THREADS_B, _THREADS_BC = 128, 256  # launch B's threads a block: one block a clip, a cluster's block
_RED_BC = 120  # floats of launch B's cluster blocks' reduction slots
_SMEM_SM = 233472  # shared memory of an SM, 1 KB of it reserved a block
_BLOCKS_SM = 3  # launch B's cluster and span blocks an SM at most
_MIN_CLUSTER_SM = 2  # launch B's cluster blocks an SM at least (else the span route)
_MAX_CLUSTER_MFCC = 16  # its MFCCs at most, the dB branch only (else the span route)
_MAX_SPAN, _MIN_SPAN = 128, 64  # launch B's span route: frames a span at most; fewer take fewer blocks an SM
_PARTS_B = 4  # its partials a span (max or min, max, sum, squares)
_RED_C = 16  # floats of the contrast launch's reduction slots
_FFT_POINTS = 8192  # the FFT plans: complex points a block holds (64 KB)
_FFT_MAX_FRAMES = 32  # the FFT plans: frames a block takes at most
_FFT_MIN_NFFT = 640  # the FFT plans: the least n_fft they take (launch A past 128 mels: any)
_FFT_MAX_PRIME = 113  # the FFT plans: the largest prime of fft_stage_prime; past it Bluestein's stage
_SMEM_TWO = _SMEM_SM // 2 - 1024  # bytes a block may use for two blocks an SM
_BLUESTEIN_POINTS = 4096  # Bluestein's convolution: its m points at most
_WARPS_A = 8  # launches A and C: warps a block (256 threads)
_THREADS_C = 384  # the contrast launch's GEMM plan: two MMA warpgroups and a warpgroup of band warps

# Launch A's plans (cdt_frontend_plan_a).
PLAN_GEMM_UNSTAGED, PLAN_GEMM_STAGED, PLAN_FFT = 0, 1, 2
# The contrast launch's FFT plan (cdt_frontend_plan_c; 0-3 are LayoutC's
# levels).
CONTRAST_FFT = 4


def kernel_supports(cfg: FeatureConfig, n_samples: int) -> bool:
    """Whether the fused kernel computes this config at this length (with
    spectral contrast, through the hybrid): the JAX launcher's test."""
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
    `skew` pad floats after every hop samples (none for a hop under 8)."""
    skew = 0 if hop < 8 else (4 - hop) % 8
    return ((((_ROWS_A - 1) * hop + kpad) // hop + 1) * (hop + skew) + 3) // 4 * 4


def _ring_bytes(span: int) -> int:
    return 4 * (_SLOTS_A * _CHUNK + span) + _BARRIERS_A


def spectral_staged(hop: int, kpad: int) -> bool:
    """Whether launch A stages a tile's waveform span in shared memory
    (csrc/frontend_kernel.cu's staged_a, cdt_frontend_plan_a); if not, it
    gathers its frames from device memory (n_fft 2048 at hop 512)."""
    return _ring_bytes(_span_floats(hop, kpad)) <= _MAX_SMEM


def _fft_layout(points: int, n_fft: int, hop: int, n_pow: int = 0, contrast: bool = False,
                per_row: int = 1) -> tuple:
    """(frames, bytes): csrc/frontend_kernel.cu's LayoutF. In floats: the
    points (2 each, rows x points a row), the frames' waveform span, the
    tables (n_fft + 2 for the twiddles, then for a prime past
    _FFT_MAX_PRIME 2 (P + 2 m - 1) for Bluestein's, `_fft_tables`);
    for the contrast launch the group's power rows (frames x n_pow) and the
    reduction slots (its contrast rows go to the output). A row holds
    `per_row` frames: one, or two for launch A on an odd n_fft
    (`_spectral_layout`). Bluestein's scratch, two rows of m points for
    each group of `_bluestein_rows`' warps, takes the span's place and
    grows it where it needs more; where `_bluestein_rows` says so, the
    tables but Bluestein's FFT_m stages' twiddles are read through L1, not
    staged.
    `rows` halves from the most a block takes until the layout fits; the
    contrast launch's most is rounded down to a power of two (its threads
    split evenly over the frames)."""
    bp = _bluestein_prime(n_fft)
    m = _bluestein_points(bp) if bp else 0
    staged = n_fft + 2 + 2 * (bp + 2 * m - 1 if bp else 0)  # floats of the tables
    rows = min(_FFT_POINTS // points, _FFT_MAX_FRAMES // per_row)
    if contrast and rows:
        rows = 1 << (rows.bit_length() - 1)
    while True:
        frames = rows * per_row
        span = _up4((frames - 1) * hop + n_fft)
        rest = 2 * rows * points + (_up4(frames * n_pow) + _RED_C if contrast else 0)
        tw = staged
        if bp:
            gw, l1 = _bluestein_rows(m, span, rest, staged)
            span, tw = _bluestein_region(m, gw, span), 2 * (m - 1) if l1 else staged
        end = rest + span + tw
        if rows <= 1 or 4 * end <= _MAX_SMEM:
            return frames, 4 * end
        rows //= 2


def _up4(n: int) -> int:
    return (n + 3) // 4 * 4


def _bluestein_region(m: int, gw: int, span: int) -> int:
    """LayoutF::scratch: the span's region, in floats, with Bluestein's
    scratch in it, two rows of m points for each group of gw warps."""
    return max(span, _up4(4 * (_WARPS_A // gw) * m))


def _bluestein_rows(m: int, span: int, rest: int, staged: int) -> tuple:
    """(gw, twl1): LayoutF's warps a group of Bluestein's stage (each group
    of gw warps runs its butterflies' FFTs of m points through its own two
    rows) and whether the tables (`staged` floats) but the FFT_m stages'
    twiddles are read through L1, not staged: of gw from 1 up (powers of
    two to 8), all staged and then through L1, the first that lets two
    blocks on an SM; where none does, the first in that order that fits a
    block (else 8, through L1). `rest` is the layout's floats but the
    span's region and the tables."""
    for most in (_SMEM_TWO // 4, _MAX_SMEM // 4):
        for g in (1, 2, 4, 8):
            for l1 in (False, True):
                if rest + _bluestein_region(m, g, span) + (2 * (m - 1) if l1 else staged) <= most:
                    return g, l1
    return _WARPS_A, True


def _spectral_points(n_fft: int) -> int:
    """Launch A's complex points a row of its FFT (fft_points_a): n_fft / 2
    for an even n_fft (a frame's reals packed as complex), n_fft for an odd
    one (two frames a row, the real and imaginary parts)."""
    return n_fft if n_fft % 2 else n_fft // 2


def _spectral_layout(n_fft: int, hop: int) -> tuple:
    """(frames, bytes) of launch A's FFT plan (LayoutF(n_fft, hop))."""
    return _fft_layout(_spectral_points(n_fft), n_fft, hop, per_row=1 + n_fft % 2)


def _prime_factors(n: int) -> list:
    """n's prime factors with multiplicity, smallest first (n >= 1)."""
    out, f = [], 2
    while f * f <= n:
        while n % f == 0:
            out.append(f)
            n //= f
        f += 1 + (f > 2)
    return out + [n] * (n > 1)


def _largest_prime(n: int) -> int:
    """The largest prime factor of n (largest_prime; 1 for n = 1)."""
    return max(_prime_factors(n), default=1)


def _smooth11(n: int) -> bool:
    """Whether n's prime factors are all at most 11 (smooth11)."""
    return max(_prime_factors(n), default=1) <= 11


def _bluestein_prime(n_fft: int) -> int:
    """The prime factor the FFT plans compute by Bluestein's stage
    (bluestein_prime): the largest, where it passes _FFT_MAX_PRIME; else
    0."""
    p = _largest_prime(n_fft)
    return p if p > _FFT_MAX_PRIME else 0


def _bluestein_points(p: int) -> int:
    """Bluestein's convolution length for the prime p (bluestein_points):
    the smallest odd 11-smooth m >= 2p - 1."""
    m = 2 * p - 1
    while not _smooth11(m):
        m += 2
    return m


def _fft_fits(n_fft: int, points: int) -> bool:
    """Whether the FFT plans' kernels take an n_fft at all (fft_fits): from
    64, odd or even, a row of `points` complex points that fits a block,
    and for a prime past _FFT_MAX_PRIME Bluestein's m at most
    _BLUESTEIN_POINTS."""
    bp = _bluestein_prime(n_fft)
    return n_fft >= 64 and points <= _FFT_POINTS and (not bp or _bluestein_points(bp) <= _BLUESTEIN_POINTS)


def _spectral_fft(n_fft: int, hop: int, n_mels: int) -> bool:
    """Whether launch A takes its FFT plan (plan_a's first branch): an
    n_fft `_fft_fits` takes, from 640 on or past 128 mels, whose layout
    fits."""
    return (_fft_fits(n_fft, _spectral_points(n_fft)) and (n_fft >= _FFT_MIN_NFFT or n_mels > 128)
            and _spectral_layout(n_fft, hop)[1] <= _MAX_SMEM)


def spectral_plan(cfg: FeatureConfig) -> int:
    """Launch A's plan (plan_a, cdt_frontend_plan_a): PLAN_FFT for an n_fft
    whose rows, Bluestein scratch and tables fit a block, odd or even
    (`_spectral_fft`), from 640 on, or past 128 mels; else the GEMM,
    PLAN_GEMM_STAGED or PLAN_GEMM_UNSTAGED (`spectral_staged`). The shipped
    config (n_fft 512, 64 mels) takes the GEMM, and so does an n_fft that
    nothing fits (a prime factor past 1997, or past 16384)."""
    if _spectral_fft(cfg.n_fft, cfg.hop_length, cfg.n_mels):
        return PLAN_FFT
    return PLAN_GEMM_STAGED if spectral_staged(cfg.hop_length, _support(cfg)[2]) else PLAN_GEMM_UNSTAGED


def spectral_fft_frames(cfg: FeatureConfig) -> int:
    """Frames a block of launch A's FFT plan takes (LayoutF's frames, even
    on an odd n_fft); its grid is batch x ceil(num_frames / frames)
    blocks."""
    return _spectral_layout(cfg.n_fft, cfg.hop_length)[0]


def spectral_smem_bytes(cfg: FeatureConfig) -> int:
    """Launch A's shared memory under its plan, as csrc/frontend_kernel.cu
    counts it (cdt_frontend_smem_a): LayoutF's, or LayoutA's with its
    smallest ring."""
    plan = spectral_plan(cfg)
    if plan == PLAN_FFT:
        return _spectral_layout(cfg.n_fft, cfg.hop_length)[1]
    kpad = _support(cfg)[2]
    return _ring_bytes(_span_floats(cfg.hop_length, kpad) if plan == PLAN_GEMM_STAGED else 0)


def mel_groups(n_mels: int) -> tuple:
    """(mel_tiles, n_groups): launch A computes the mels in n_groups groups
    of 8 * mel_tiles (mel_tiles 4, 8 or 16, the fewest that hold
    ceil(n_mels / n_groups)), n_groups = ceil(n_mels / 128); each group
    takes its own blocks, which run the DFT again."""
    n_groups = -(-n_mels // (8 * _MEL_TILES[-1]))
    per = -(-n_mels // n_groups)
    return next(m for m in _MEL_TILES if 8 * m >= per), n_groups


def _layout_b_floats(t: int, m: int, c: int, delta_delta: bool, halo: int = 0, red: int = _RED_B) -> int:
    """csrc/frontend_kernel.cu's LayoutB: reduction slots (`red` floats),
    the DCT table padded to whole passes of its DCT (8, 16 or 32 MFCCs a
    pass), the power mel (m x cols, cols = t + 2 halo); the MFCC tile and,
    with delta-deltas, the delta tile take the mel tile's rows where
    c <= 32 and 2c <= m, and follow it otherwise."""
    kc = 8 if c <= 8 else 16 if c <= 16 else 32
    cols = t + 2 * halo
    floats = m * -(-c // kc) * kc + m * cols
    if not (c <= 32 and 2 * c <= m):
        floats += (2 if delta_delta else 1) * c * cols
    return red + floats


def _cluster_bytes(cfg: FeatureConfig, n: int) -> int:
    """Shared memory of a block of launch B's cluster route at n blocks a
    clip (cluster_bytes_b): ceil(T / n) frames and halo_b more on each
    side (5 with PCEN, else 1, or 2 with delta-deltas)."""
    dd = cfg.use_delta_delta
    halo = 5 if cfg.use_pcen else 1 + int(dd)
    return 4 * _layout_b_floats(-(-cfg.num_frames // n), cfg.n_mels, cfg.n_mfcc, dd, halo, _RED_BC)


def epilogue_plan(cfg: FeatureConfig) -> int:
    """Launch B's plan (plan_b, cdt_frontend_plan_b): 1, one block holds a
    clip; 2 to 16, the dB branch with at most 16 MFCCs on a cluster of
    that many blocks, ceil(T / n) frames each: for k = 3, 2, the fewest
    whose blocks fit k an SM; 0, the span route takes the clip
    (epilogue_spans): PCEN, more MFCCs, or no cluster of two an SM."""
    t, m, c, dd = cfg.num_frames, cfg.n_mels, cfg.n_mfcc, cfg.use_delta_delta
    if 4 * _layout_b_floats(t, m, c, dd) <= _MAX_SMEM:
        return 1
    if not cfg.use_pcen and c <= _MAX_CLUSTER_MFCC:
        for k in range(_BLOCKS_SM, _MIN_CLUSTER_SM - 1, -1):
            for n in range(2, _MAX_CLUSTER + 1):
                if _cluster_bytes(cfg, n) <= _SMEM_SM // k - 1024:
                    return n
    return 0


@functools.lru_cache(maxsize=64)
def _span_frames(m: int, c: int, pcen: bool, dd: bool) -> int:
    """span_frames_b: for k = 3, 2, 1 blocks an SM, the most frames (up to
    128) whose LayoutB, with its halo, fits k an SM, taken once they reach
    64 (at one an SM, whatever fits); 0 if not one frame fits."""
    halo = 5 if pcen else 1 + int(dd)
    f = 0
    for k in range(_BLOCKS_SM, 0, -1):
        f = next((f for f in range(_MAX_SPAN, 0, -1)
                  if 4 * _layout_b_floats(f, m, c, dd, halo, _RED_BC) <= _SMEM_SM // k - 1024), 0)
        if f >= _MIN_SPAN:
            return f
    return f


def epilogue_spans(cfg: FeatureConfig) -> int:
    """The span route's spans a clip (spans_b): the fewest of at most
    _span_frames frames, each then ceil(T / n) frames; 0 if none fits.
    Counted whatever the plan."""
    f = _span_frames(cfg.n_mels, cfg.n_mfcc, cfg.use_pcen, cfg.use_delta_delta)
    return -(-cfg.num_frames // f) if f else 0


def epilogue_blocks(cfg: FeatureConfig) -> int:
    """Launch B's blocks a clip (blocks_b, cdt_frontend_blocks_b): 1, the
    cluster's blocks, or the span route's spans."""
    return epilogue_plan(cfg) or epilogue_spans(cfg)


def epilogue_smem_bytes(cfg: FeatureConfig) -> int:
    """Launch B's shared memory a block under its plan, as
    csrc/frontend_kernel.cu counts it (cdt_frontend_smem_b): LayoutB at the
    clip's frames, or a cluster block's or a span's (LayoutB at ceil(T /
    n) frames with its halo)."""
    if epilogue_plan(cfg) == 1:
        return 4 * _layout_b_floats(cfg.num_frames, cfg.n_mels, cfg.n_mfcc, cfg.use_delta_delta)
    n = epilogue_blocks(cfg)
    return _cluster_bytes(cfg, n) if n else 0


def epilogue_threads(cfg: FeatureConfig) -> int:
    """Launch B's threads a block under its plan (threads_b): 128 for one
    block a clip, 256 for a cluster's blocks and the span route's."""
    return _THREADS_B if epilogue_plan(cfg) == 1 else _THREADS_BC


def epilogue_scratch_floats(cfg: FeatureConfig) -> int:
    """Floats of device memory a clip the span route takes beside its
    output: the raw MFCCs (n_mfcc x T), then _PARTS_B partials a span; 0 on
    the other routes."""
    if epilogue_plan(cfg):
        return 0
    return cfg.n_mfcc * cfg.num_frames + _PARTS_B * epilogue_spans(cfg)


def spectral_grid(batch: int, n_frames: int, n_groups: int = 1) -> int:
    """Launch A's blocks, all on grid x: `batch` clips of `n_frames`
    frames, each in ceil(n_frames / 128) row tiles, each tile in n_groups
    mel groups. The kernel folds the clip into grid x (block i is clip
    i // (tiles * n_groups)), so a batch is bounded by grid x's 2^31 - 1
    blocks, not by grid y's 65,535."""
    return batch * -(-n_frames // _ROWS_A) * n_groups


def spectral_block(block: int, n_frames: int, n_groups: int = 1) -> tuple:
    """(clip, first frame, mel group) of launch A's block `block`, as the
    kernel computes them from blockIdx.x."""
    tiles = -(-n_frames // _ROWS_A)
    per_clip = tiles * n_groups
    return block // per_clip, block % tiles * _ROWS_A, block % per_clip // tiles


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
    n_used: int        # DFT bins that feed any mel band
    j0: int            # window support [j0, j1) within the frame
    j1: int
    kpad: int          # j1 - j0 rounded up to two k-steps of 8 taps
    n_bins: int        # n_used rounded up to 8 (sets launch A's DFT passes)
    mel_tiles: int     # a mel group's width in n-tiles of 8 (mel_groups)
    n_groups: int      # launch A's mel groups
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


@functools.lru_cache(maxsize=48)  # chip_smoke.py's every-config checks, then timings, run 40 configs
def _constants(cfg: FeatureConfig, device: torch.device) -> _Constants:
    """Band-limited tables: bins past the filterbank's last nonzero row feed
    no mel band, so the DFT stops there (128 of 257 bins at f_max=4 kHz).
    Launch A's tables are split into hi/lo TF32 here, once per config, and
    laid out as the stream of 16 KB chunks its ring reads: per mel group
    (mel_groups) and pass of 256 DFT columns (128 bins), one chunk per
    k-step of the DFT over the window's support [j0, j0 + kpad), its cos
    and -sin columns interleaved bin by bin (zero past n_used), then the
    filterbank's rows for the pass's bins (zero past n_used), 16 k-steps of
    the group's 8 * mel_tiles mels (zero past n_mels), 256 / (8 *
    mel_tiles) k-steps a chunk. A group's blocks read its own stream, so
    the DFT's chunks repeat in each."""
    c, s = filters.dft_matrices(cfg.n_fft, cfg.win_length)
    fb = filters.mel_filterbank(
        cfg.n_fft // 2 + 1, cfg.n_mels, cfg.sample_rate, cfg.f_min, cfg.f_max
    )
    n_used = int(np.max(np.nonzero(np.any(fb != 0, axis=1))[0])) + 1
    j0, j1, kpad = _support(cfg)

    n_bins = -(-n_used // 8) * 8
    n_passes = -(-2 * n_bins // _PASS_COLS)
    table = np.zeros((kpad, n_passes * _PASS_COLS), np.float32)
    table[: j1 - j0, 0 : 2 * n_used : 2] = c[j0:j1, :n_used]
    table[: j1 - j0, 1 : 2 * n_used : 2] = s[j0:j1, :n_used]
    mel_tiles, n_groups = mel_groups(cfg.n_mels)
    width = 8 * mel_tiles
    fb_pad = np.zeros((n_passes * _PASS_COLS // 2, n_groups * width), np.float32)
    fb_pad[:n_used, : cfg.n_mels] = fb[:n_used]
    dft = [_tiles(table[:, p * _PASS_COLS : (p + 1) * _PASS_COLS]) for p in range(n_passes)]
    stream = []
    for g in range(n_groups):
        for p in range(n_passes):
            stream.append(dft[p])
            bins = slice(p * _PASS_COLS // 2, (p + 1) * _PASS_COLS // 2)
            stream.append(_tiles(fb_pad[bins, g * width : (g + 1) * width]).reshape(-1, _CHUNK))

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(device)

    return _Constants(
        dev(c[:, :n_used]), dev(s[:, :n_used]), dev(fb[:n_used]),
        n_used, j0, j1, kpad, n_bins, mel_tiles, n_groups,
        torch.cat(stream).reshape(-1).to(device),
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


# -- the FFT plans' constants and arithmetic -------------------------------------


@functools.lru_cache(maxsize=48)
def _twiddles(n_fft: int) -> np.ndarray:
    """(n_fft // 2 + 1, 2) float32: e^{-2 pi i k / n_fft} for k in [0, n_fft
    // 2] as (cos, -sin), computed in float64 and rounded once. The FFT
    plans read the conjugate of entry n_fft - k for k past n_fft / 2, for
    an odd n_fft as for an even one."""
    ang = 2.0 * np.pi * np.arange(n_fft // 2 + 1, dtype=np.float64) / n_fft
    return np.stack([np.cos(ang), -np.sin(ang)], axis=1).astype(np.float32)


@functools.lru_cache(maxsize=16)
def _bluestein_tables(p: int) -> np.ndarray:
    """(p + 2 m - 1, 2) float32, m = _bluestein_points(p), as (re, im):
    Bluestein's chirp c_s = e^{-pi i s^2 / p} for s in [0, p) (its angle
    from s^2 mod 2p in integers), B^ = FFT_m(b) / m of the wrapped
    conjugate chirp (b_t = conj c_t and b_{m-t} = conj c_t for t in [0,
    p), zeros between), each computed in float64 and rounded once; then
    `_bluestein_stage_twiddles(m)`."""
    m = _bluestein_points(p)
    s = np.arange(p, dtype=np.int64)
    chirp = np.exp(-1j * np.pi * ((s * s) % (2 * p)) / p)
    b = np.zeros(m, np.complex128)
    b[:p] = np.conj(chirp)
    b[m - s[1:]] = np.conj(chirp[1:])
    z = np.concatenate([chirp, np.fft.fft(b) / m])
    return np.concatenate([np.stack([z.real, z.imag], axis=1).astype(np.float32), _bluestein_stage_twiddles(m)])


def _bluestein_stage_twiddles(m: int) -> np.ndarray:
    """(m - 1, 2) float32: Bluestein's FFT_m stages' twiddles as the
    kernel reads them (blue_stage), stage by stage (`_blue_radices(m)`),
    for the stage of radix R at ns its w_{ns R}^{r k} at k (R - 1) + r - 1
    for k < ns and r in [1, R): the `_twiddles(m)` entry r k m / (ns R),
    past m / 2 the conjugate of entry m - that, the values `_stockham`
    reads."""
    half = _twiddles(m)
    out, ns = [], 1
    for r in _blue_radices(m):
        idx = (np.arange(ns)[:, None] * np.arange(1, r)[None, :] * (m // (ns * r))).reshape(-1)
        low = 2 * idx <= m
        t = half[np.where(low, idx, m - idx)]
        out.append(np.stack([t[:, 0], np.where(low, t[:, 1], -t[:, 1])], axis=1))
        ns *= r
    return np.concatenate(out).astype(np.float32)


def _fft_tables(n_fft: int) -> np.ndarray:
    """The FFT plans' tables (LayoutF's tables, the kernels' `twiddles`):
    `_twiddles`, then for a prime factor past _FFT_MAX_PRIME
    `_bluestein_tables` of it."""
    bp = _bluestein_prime(n_fft)
    return np.concatenate([_twiddles(n_fft), _bluestein_tables(bp)]) if bp else _twiddles(n_fft)


def _filter_ranges(fb: np.ndarray) -> tuple:
    """The filterbank's columns as launch A's FFT plan reads them:
    (weights, ranges), ranges (n_mels, 3) int32 per mel its first nonzero
    bin, the bins from there to its last nonzero one and their offset in
    weights, where they lie one mel after another (a mel with no nonzero
    bin has none)."""
    weights, ranges, off = [], [], 0
    for m in range(fb.shape[1]):
        nz = np.nonzero(fb[:, m])[0]
        lo, n = (int(nz[0]), int(nz[-1] - nz[0]) + 1) if nz.size else (0, 0)
        weights.append(fb[lo : lo + n, m])
        ranges.append((lo, n, off))
        off += n
    return np.concatenate(weights).astype(np.float32), np.array(ranges, np.int32).reshape(-1, 3)


class _FftConstants(NamedTuple):
    window: torch.Tensor     # (n_fft,) the padded win_length Hann
    twiddles: torch.Tensor   # (LayoutF's tables, 2), _fft_tables: (n_fft // 2 + 1, 2) without Bluestein
    fb_w: torch.Tensor       # the filters' nonzero weights, mel by mel
    fb_ranges: torch.Tensor  # (n_mels, 3) int32: first bin, bins, offset in fb_w
    n_used: int              # bins that feed any mel band


@functools.lru_cache(maxsize=16)
def _fft_constants(cfg: FeatureConfig, device: torch.device) -> _FftConstants:
    """Launch A's FFT plan's tables: the window, the twiddles (with
    Bluestein's tables, `_fft_tables`) and the filterbank over its n_used
    bins, packed by `_filter_ranges`."""
    fb = filters.mel_filterbank(cfg.n_fft // 2 + 1, cfg.n_mels, cfg.sample_rate, cfg.f_min, cfg.f_max)
    n_used = int(np.max(np.nonzero(np.any(fb != 0, axis=1))[0])) + 1
    weights, ranges = _filter_ranges(fb[:n_used])

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    return _FftConstants(
        dev(filters.padded_window(cfg.win_length, cfg.n_fft).astype(np.float32)),
        dev(_fft_tables(cfg.n_fft)), dev(weights), dev(ranges), n_used,
    )


def _fft_radices(points: int) -> list:
    """The FFT plans' Stockham stages for `points` (fft_rows): Bluestein's
    stage first for a prime factor past _FFT_MAX_PRIME (on rows packed
    per butterfly, `BlueOrder` in the kernel: only the layout, not the
    arithmetic, differs), then one of radix 2 when the count of 2s is odd,
    then radix 4, then the 3s, the 5s, the 7s and the 11s, then one stage
    of each larger prime factor up to _FFT_MAX_PRIME (fft_stage_prime),
    smallest first. Raises where the kernels have no stages: more than one
    prime factor past _FFT_MAX_PRIME, or Bluestein's m past
    _BLUESTEIN_POINTS."""
    factors = _prime_factors(points)
    past = [f for f in factors if f > _FFT_MAX_PRIME]
    if len(past) > 1 or (past and _bluestein_points(past[0]) > _BLUESTEIN_POINTS):
        raise ValueError(f"the FFT plans take at most one prime factor past {_FFT_MAX_PRIME}, whose Bluestein "
                         f"convolution fits {_BLUESTEIN_POINTS} points; got {points} = {factors}")
    twos = factors.count(2)
    return past + [2] * (twos % 2) + [4] * (twos // 2) + [f for f in factors if 2 < f <= _FFT_MAX_PRIME]


# The radix-3, radix-5, radix-7 and radix-11 butterflies' constants, as the
# kernel rounds them (float64 values to float32 once): sin(2 pi / 3); cos
# and sin of 2 pi / 5 and 4 pi / 5; of 2 pi / 7, 4 pi / 7 and 6 pi / 7; of
# 2 pi j / 11 for j in 1-5 (_COS11[j - 1], _SIN11[j - 1]).
_SIN3, _COS5A, _SIN5A, _COS5B, _SIN5B = (float(np.float32(v)) for v in (
    0.86602540378443865, 0.30901699437494742, 0.95105651629515357, -0.80901699437494742, 0.58778525229247314,
))
_COS7A, _SIN7A, _COS7B, _SIN7B, _COS7C, _SIN7C = (float(np.float32(v)) for v in (
    0.62348980185873359, 0.78183148246802980, -0.22252093395631434, 0.97492791218182362, -0.90096886790241903,
    0.43388373911755823,
))
_COS11 = tuple(float(np.float32(v)) for v in (
    0.84125353283118121, 0.41541501300188644, -0.142314838273285, -0.65486073394528499, -0.95949297361449737,
))
_SIN11 = tuple(float(np.float32(v)) for v in (
    0.54064081745559756, 0.90963199535451833, 0.9898214418809328, 0.75574957435425827, 0.28173255684142967,
))


def _cos_sin11(j: int) -> tuple:
    """cos and sin of 2 pi j / 11 for j in [1, 11), from _COS11 and _SIN11
    (the kernel's cos11 and sin11)."""
    if j <= 5:
        return _COS11[j - 1], _SIN11[j - 1]
    return _COS11[10 - j], -_SIN11[10 - j]


def _dft_prime(vr: list, vi: list, cos: torch.Tensor, sin: torch.Tensor) -> tuple:
    """fft_stage_prime's P-point DFT (P = len(vr), an odd prime past 11) of
    the twiddled points (vr[r], vi[r]), with its order of operations: a_r =
    v_r + v_{P-r}, b_r = v_r - v_{P-r} for r in [1, P / 2]; m_k = v_0 + sum_r
    cos_k,r a_r and n_k = sum_r sin_k,r b_r in r's order, for k in [0, P /
    2] at once ((P / 2 + 1, P / 2) tables cos and sin of 2 pi (k r mod P) /
    P, as the kernel reads them from the twiddle table); outputs k and P -
    k are m_k -+ i n_k."""
    r, h = len(vr), len(vr) // 2
    ar = [vr[j] + vr[r - j] for j in range(1, h + 1)]
    ai = [vi[j] + vi[r - j] for j in range(1, h + 1)]
    br = [vr[j] - vr[r - j] for j in range(1, h + 1)]
    bi = [vi[j] - vi[r - j] for j in range(1, h + 1)]
    mr = vr[0].unsqueeze(-2).expand(*vr[0].shape[:-1], h + 1, vr[0].shape[-1])
    mi = vi[0].unsqueeze(-2).expand_as(mr)
    nr, ni = torch.zeros_like(mr), torch.zeros_like(mr)
    for j in range(h):
        c, s = cos[:, j, None], sin[:, j, None]
        mr, mi = mr + c * ar[j].unsqueeze(-2), mi + c * ai[j].unsqueeze(-2)
        nr, ni = nr + s * br[j].unsqueeze(-2), ni + s * bi[j].unsqueeze(-2)
    lo_r, lo_i = (mr + ni).unbind(-2), (mi - nr).unbind(-2)  # m_k - i n_k
    hi_r, hi_i = (mr - ni).unbind(-2), (mi + nr).unbind(-2)  # m_k + i n_k
    return list(lo_r) + list(hi_r[1:][::-1]), list(lo_i) + list(hi_i[1:][::-1])


def _bluestein(vr: list, vi: list) -> tuple:
    """fft_stage_bluestein's P-point DFT (P = len(vr), a prime past
    _FFT_MAX_PRIME) of the twiddled points (vr[s], vi[s]), with its order of
    operations: a_s = v_s c_s, zero-padded to m points, its FFT by the
    radix stages (`_stockham` with the m-point table's values and the
    stages of `_blue_radices`), each point times B^ (1 / m in it) and
    conjugated, the FFT again, then output k is c_k times the conjugate of
    point k (`_bluestein_tables`)."""
    p = len(vr)
    t = torch.from_numpy(_bluestein_tables(p)).to(vr[0].device)
    m = _bluestein_points(p)
    cr, ci = t[:p, 0], t[:p, 1]
    br, bi = t[p : p + m, 0], t[p : p + m, 1]
    xr, xi = torch.stack(vr, dim=-1), torch.stack(vi, dim=-1)
    ar = F.pad(xr * cr - xi * ci, (0, m - p))
    ai = F.pad(xr * ci + xi * cr, (0, m - p))
    tw = torch.from_numpy(_twiddles(m)).to(vr[0].device)
    zr, zi = _stockham(ar, ai, tw, m, _blue_radices(m))
    zr, zi = zr * br - zi * bi, -(zr * bi + zi * br)
    zr, zi = _stockham(zr, zi, tw, m, _blue_radices(m))
    yr, yi = zr[..., :p], -zi[..., :p]
    return list((yr * cr - yi * ci).unbind(-1)), list((yr * ci + yi * cr).unbind(-1))


# e^{-2 pi i j / R} for Bluestein's composite radices 9 and 15 (the
# kernel's w_composite), float64 values rounded once: j -> (cos, -sin).
_W_COMPOSITE = {
    9: {1: (0.766044443118978, -0.6427876096865393), 2: (0.17364817766693041, -0.984807753012208),
        4: (-0.9396926207859083, -0.3420201433256689)},
    15: {1: (0.9135454576426009, -0.40673664307580015), 2: (0.6691306063588582, -0.7431448254773941),
         3: (0.30901699437494745, -0.9510565162951535), 4: (-0.10452846326765333, -0.9945218953682734),
         6: (-0.8090169943749473, -0.5877852522924732), 8: (-0.9781476007338057, 0.20791169081775907)},
}
_W_COMPOSITE = {r: {j: tuple(float(np.float32(v)) for v in w) for j, w in t.items()} for r, t in _W_COMPOSITE.items()}


def _blue_radices(m: int) -> list:
    """Bluestein's FFT_m stages (the kernel's blue_radix): of what is left
    of m, 15 where it divides it, else 9, else its least prime factor."""
    out = []
    while m > 1:
        r = next(f for f in (15, 9, 3, 5, 7, 11) if m % f == 0)
        out.append(r)
        m //= r
    return out


def _dft_points(vr: list, vi: list) -> tuple:
    """The kernel's R-point DFT (dft_points, R = len(vr): 2, 3, 4, 5, 7, 9,
    11 or 15) of the points (vr[r], vi[r]), with its order of operations."""
    r = len(vr)
    if r in (9, 15):  # point n = r2 n1 + n2: 3-point DFTs over n1, times w_r^{n2 k1}, r2-point DFTs over n2
        r2 = r // 3
        yr, yi = [[None] * r2 for _ in range(3)], [[None] * r2 for _ in range(3)]
        for n2 in range(r2):
            tr, ti = _dft_points([vr[n2], vr[r2 + n2], vr[2 * r2 + n2]], [vi[n2], vi[r2 + n2], vi[2 * r2 + n2]])
            for k1 in range(3):
                if n2 * k1:
                    c, ms = _W_COMPOSITE[r][n2 * k1]
                    tr[k1], ti[k1] = tr[k1] * c - ti[k1] * ms, tr[k1] * ms + ti[k1] * c
                yr[k1][n2], yi[k1][n2] = tr[k1], ti[k1]
        out_r, out_i = [None] * r, [None] * r
        for k1 in range(3):
            br, bi = _dft_points(yr[k1], yi[k1])
            for k2 in range(r2):
                out_r[k1 + 3 * k2], out_i[k1 + 3 * k2] = br[k2], bi[k2]
        return out_r, out_i
    if r == 11:  # pairs a = v_r + v_{11-r}, b = v_r - v_{11-r}; outputs k and 11 - k are m_k -+ i n_k
        ar = [vr[j] + vr[11 - j] for j in range(1, 6)]
        ai = [vi[j] + vi[11 - j] for j in range(1, 6)]
        br = [vr[j] - vr[11 - j] for j in range(1, 6)]
        bi = [vi[j] - vi[11 - j] for j in range(1, 6)]
        yr, yi = [None] * 11, [None] * 11
        for k in range(1, 6):
            mr, mi = vr[0], vi[0]
            s = _cos_sin11(k)[1]
            nr, ni = s * br[0], s * bi[0]
            for j in range(1, 6):
                c, s = _cos_sin11(j * k % 11)
                mr, mi = mr + c * ar[j - 1], mi + c * ai[j - 1]
                if j > 1:
                    nr, ni = nr + s * br[j - 1], ni + s * bi[j - 1]
            yr[k], yi[k] = mr + ni, mi - nr
            yr[11 - k], yi[11 - k] = mr - ni, mi + nr
        yr[0], yi[0] = vr[0] + ar[0] + ar[1] + ar[2] + ar[3] + ar[4], vi[0] + ai[0] + ai[1] + ai[2] + ai[3] + ai[4]
        return yr, yi
    if r == 2:
        return [vr[0] + vr[1], vr[0] - vr[1]], [vi[0] + vi[1], vi[0] - vi[1]]
    if r == 3:
        sr, si = vr[1] + vr[2], vi[1] + vi[2]
        dr, di = vr[1] - vr[2], vi[1] - vi[2]
        tr, ti = vr[0] - 0.5 * sr, vi[0] - 0.5 * si  # v0 + cos(2 pi / 3) s
        ur, ui = _SIN3 * di, -(_SIN3 * dr)  # -i sin(2 pi / 3) d
        return [vr[0] + sr, tr + ur, tr - ur], [vi[0] + si, ti + ui, ti - ui]
    if r == 4:
        a0r, a0i = vr[0] + vr[2], vi[0] + vi[2]
        a1r, a1i = vr[0] - vr[2], vi[0] - vi[2]
        a2r, a2i = vr[1] + vr[3], vi[1] + vi[3]
        a3r, a3i = vi[1] - vi[3], -(vr[1] - vr[3])  # -i (v1 - v3)
        return [a0r + a2r, a1r + a3r, a0r - a2r, a1r - a3r], [a0i + a2i, a1i + a3i, a0i - a2i, a1i - a3i]
    if r == 7:  # pairs a = v_r + v_{7-r}, b = v_r - v_{7-r}; outputs k and 7 - k are m_k -+ i n_k
        a1r, a1i, b1r, b1i = vr[1] + vr[6], vi[1] + vi[6], vr[1] - vr[6], vi[1] - vi[6]
        a2r, a2i, b2r, b2i = vr[2] + vr[5], vi[2] + vi[5], vr[2] - vr[5], vi[2] - vi[5]
        a3r, a3i, b3r, b3i = vr[3] + vr[4], vi[3] + vi[4], vr[3] - vr[4], vi[3] - vi[4]
        m1r = vr[0] + _COS7A * a1r + _COS7B * a2r + _COS7C * a3r
        m1i = vi[0] + _COS7A * a1i + _COS7B * a2i + _COS7C * a3i
        m2r = vr[0] + _COS7B * a1r + _COS7C * a2r + _COS7A * a3r
        m2i = vi[0] + _COS7B * a1i + _COS7C * a2i + _COS7A * a3i
        m3r = vr[0] + _COS7C * a1r + _COS7A * a2r + _COS7B * a3r
        m3i = vi[0] + _COS7C * a1i + _COS7A * a2i + _COS7B * a3i
        n1r, n1i = _SIN7A * b1r + _SIN7B * b2r + _SIN7C * b3r, _SIN7A * b1i + _SIN7B * b2i + _SIN7C * b3i
        n2r, n2i = _SIN7B * b1r - _SIN7C * b2r - _SIN7A * b3r, _SIN7B * b1i - _SIN7C * b2i - _SIN7A * b3i
        n3r, n3i = _SIN7C * b1r - _SIN7A * b2r + _SIN7B * b3r, _SIN7C * b1i - _SIN7A * b2i + _SIN7B * b3i
        return (
            [vr[0] + a1r + a2r + a3r, m1r + n1i, m2r + n2i, m3r + n3i, m3r - n3i, m2r - n2i, m1r - n1i],
            [vi[0] + a1i + a2i + a3i, m1i - n1r, m2i - n2r, m3i - n3r, m3i + n3r, m2i + n2r, m1i + n1r],
        )
    t1r, t1i, t2r, t2i = vr[1] + vr[4], vi[1] + vi[4], vr[1] - vr[4], vi[1] - vi[4]
    t3r, t3i, t4r, t4i = vr[2] + vr[3], vi[2] + vi[3], vr[2] - vr[3], vi[2] - vi[3]
    m1r, m1i = vr[0] + _COS5A * t1r + _COS5B * t3r, vi[0] + _COS5A * t1i + _COS5B * t3i
    m2r, m2i = vr[0] + _COS5B * t1r + _COS5A * t3r, vi[0] + _COS5B * t1i + _COS5A * t3i
    n1r, n1i = _SIN5A * t2r + _SIN5B * t4r, _SIN5A * t2i + _SIN5B * t4i
    n2r, n2i = _SIN5B * t2r - _SIN5A * t4r, _SIN5B * t2i - _SIN5A * t4i
    return (
        [vr[0] + t1r + t3r, m1r + n1i, m2r + n2i, m2r - n2i, m1r - n1i],  # m - i n, then m + i n
        [vi[0] + t1i + t3i, m1i - n1r, m2i - n2r, m2i + n2r, m1i + n1r],
    )


def _stockham(re: torch.Tensor, im: torch.Tensor, tw: torch.Tensor, n_fft: int, radices: list = None) -> tuple:
    """The FFT plans' FFT along the last axis in float32, as
    csrc/frontend_kernel.cu's fft_rows runs it: stage by stage
    (`_fft_radices`), butterfly j reads points j + r p / R, multiplies
    point r > 0 by the table's entry r (j mod ns) n_fft / (ns R) (k past
    n_fft / 2: the conjugate of entry n_fft - k), takes the R-point DFT
    (`_dft_points`, or `_dft_prime` past 11 with w_R from the table's
    entries k n_fft / R, or `_bluestein` past _FFT_MAX_PRIME) and writes
    output r to (j - j mod ns) R + j mod ns + r ns. `tw` holds the table's
    n_fft // 2 + 1 twiddles first (`_fft_tables` is such a table);
    `radices` replaces `_fft_radices` (Bluestein's FFT_m: `_blue_radices`)."""
    p = re.shape[-1]
    half = n_fft // 2

    def table(idx: torch.Tensor) -> tuple:
        low = idx <= half
        t = tw[torch.where(low, idx, n_fft - idx)]
        return t[..., 0], torch.where(low, t[..., 1], -t[..., 1])

    ns = 1
    for r in radices or _fft_radices(p):
        q = p // r
        j = torch.arange(q, device=re.device)
        k = j % ns
        vr = list(re.reshape(*re.shape[:-1], r, q).unbind(-2))
        vi = list(im.reshape(*im.shape[:-1], r, q).unbind(-2))
        for i in range(1, r if ns > 1 else 1):  # (the first stage's twiddles are 1: the kernels skip them)
            wr, wi = table(i * k * (n_fft // (ns * r)))
            vr[i], vi[i] = vr[i] * wr - vi[i] * wi, vr[i] * wi + vi[i] * wr
        if r > _FFT_MAX_PRIME:
            yr, yi = _bluestein(vr, vi)
        elif r > 11 and r != 15:  # (15: Bluestein's composite radix, in _dft_points)
            kr = torch.arange(r // 2 + 1, device=re.device)[:, None] * torch.arange(1, r // 2 + 1, device=re.device)
            cos, msin = table(kr % r * (n_fft // r))
            yr, yi = _dft_prime(vr, vi, cos, -msin)
        else:
            yr, yi = _dft_points(vr, vi)
        dst = (j - k) * r + k + ns * torch.arange(r, device=re.device)[:, None]  # (r, q)
        re, im = torch.empty_like(re), torch.empty_like(im)
        re[..., dst] = torch.stack(yr, dim=-2)
        im[..., dst] = torch.stack(yi, dim=-2)
        ns *= r
    return re, im


def power_mel_fft_reference(
    waves: torch.Tensor, cfg: FeatureConfig = FeatureConfig()
) -> torch.Tensor:
    """Launch A's FFT plan's arithmetic in plain torch ops: (B,
    segment_samples) → power mel (B, n_mels, num_frames). On an even n_fft
    each windowed frame's n_fft reals packed as n_fft / 2 complex points
    (even samples real, odd imaginary), the plan's Stockham stages and
    twiddle table (`_stockham`), the real FFT's post-twiddle for bins [0,
    n_used); on an odd n_fft frames 2j and 2j + 1 as the real and
    imaginary parts of one FFT of n_fft points (a lone last frame with
    zeros), split by conjugate symmetry. Then their power, and the mel from
    the packed filters. The kernel may fuse a multiply and an add where
    this model rounds both, and it adds each mel's products in bin order:
    differences far below the 1e-3 budget. For any config (the kernel takes
    it where spectral_plan says so); for tests and chip_smoke.py, nothing
    on the main path calls it."""
    _check_config(cfg, waves.shape[-1])
    k = _fft_constants(cfg, waves.device)
    x = _frames(waves, cfg) * k.window
    n_fft = cfg.n_fft
    bins = torch.arange(k.n_used, device=waves.device)
    if n_fft % 2:
        t = x.shape[1]
        x = F.pad(x, (0, 0, 0, t % 2))  # an odd count's last frame pairs with zeros
        re, im = _stockham(x[:, 0::2], x[:, 1::2], k.twiddles, n_fft)
        c = (n_fft - bins) % n_fft
        ar, ai, cr, ci = re[..., bins], im[..., bins], re[..., c], im[..., c]
        er, ei = 0.5 * (ar + cr), 0.5 * (ai - ci)  # (Z[k] + conj Z[n - k]) / 2
        odr, odi = 0.5 * (ai + ci), 0.5 * (ar - cr)  # (Z[k] - conj Z[n - k]) / 2i, up to the sign of its im
        power = torch.stack([er * er + ei * ei, odr * odr + odi * odi], dim=2)
        power = power.reshape(x.shape[0], -1, k.n_used)[:, :t]
    else:
        re, im = _stockham(x[..., 0::2], x[..., 1::2], k.twiddles, n_fft)
        m = n_fft // 2
        a, c = bins % m, (m - bins) % m
        er, ei = 0.5 * (re[..., a] + re[..., c]), 0.5 * (im[..., a] - im[..., c])
        dr, di = 0.5 * (re[..., a] - re[..., c]), 0.5 * (im[..., a] + im[..., c])
        wr, wi = k.twiddles[: k.n_used, 0], k.twiddles[: k.n_used, 1]
        xr = er + (wr * di - wi * -dr)  # w^k (-i d): -i d = (d_im, -d_re)
        xi = ei + (wr * -dr + wi * di)
        power = xr * xr + xi * xi
    fb = torch.zeros((k.n_used, cfg.n_mels), dtype=torch.float32, device=waves.device)
    for mel, (lo, n, off) in enumerate(k.fb_ranges.tolist()):
        fb[lo : lo + n, mel] = k.fb_w[off : off + n]
    return (power @ fb).transpose(1, 2)


@functools.lru_cache(maxsize=16)
def _dct(n_mfcc: int, n_mels: int, device: torch.device) -> torch.Tensor:
    """Launch B's DCT table (n_mels, n_mfcc), apart from launch A's tables."""
    return torch.from_numpy(filters.dct_matrix(n_mfcc, n_mels)).to(device)


def mel_epilogue_reference(
    mel: torch.Tensor, cfg: FeatureConfig = FeatureConfig()
) -> torch.Tensor:
    """Launch B's arithmetic in plain torch ops: power mel
    (B, n_mels, num_frames) → (B, num_features, num_frames)."""
    _check_mel(cfg, mel)
    return stack_features(mel.transpose(1, 2), cfg)


def _fold_spans(parts: torch.Tensor, op) -> torch.Tensor:
    """(B, n) partials → (B,): the span route's fold_spans, as every warp
    runs it: lane l folds spans l, l + 32, ... in order from the
    identity, then a butterfly over the 32 lanes."""
    ident = {torch.add: 0.0, torch.maximum: -math.inf, torch.minimum: math.inf}[op]
    lanes = torch.full((parts.shape[0], 32), ident, dtype=parts.dtype, device=parts.device)
    for k in range(parts.shape[1]):
        lanes[:, k % 32] = op(lanes[:, k % 32], parts[:, k])
    idx = torch.arange(32, device=parts.device)
    for off in (16, 8, 4, 2, 1):
        lanes = op(lanes, lanes[:, idx ^ off])
    return lanes[:, 0]


def mel_epilogue_span_reference(
    mel: torch.Tensor, cfg: FeatureConfig = FeatureConfig(), frames: int = 0
) -> torch.Tensor:
    """Launch B's span route in plain torch ops: power mel (B, n_mels,
    num_frames) → (B, num_features, num_frames). The clip in n spans of
    ceil(T / n) frames, n the fewest of at most `frames` (0: the route's
    own, _span_frames), each with its halo (PCEN's smoother 5 frames a
    side, zeros past the clip; the MFCCs 1 + delta_delta frames a side
    within the clip); a partial a span, folded as the kernels fold them
    (_fold_spans); the dB rows scaled by 1/80 as the kernels do. Any
    config, whatever its plan."""
    _check_mel(cfg, mel)
    b, m, t = mel.shape
    c, dd = cfg.n_mfcc, int(cfg.use_delta_delta)
    frames = frames or _span_frames(m, c, cfg.use_pcen, cfg.use_delta_delta)
    n = -(-t // frames)
    tb = -(-t // n)
    bounds = [(min(t, s * tb), min(t, s * tb + tb)) for s in range(n)]
    nc = c * t
    dct = _dct(c, m, mel.device)
    halo = 5 if cfg.use_pcen else 0
    padded = F.pad(mel, (halo, halo + tb))  # each span's tile, zeros past the clip

    def log_mel(x):
        return _DB_SCALE * torch.log(torch.clamp(x, min=_AMIN))

    def pcen_of(f0, f1):  # PCEN of frames [f0, f1) from the span's tile with its halo
        tile = padded[:, :, f0 : f1 + 2 * halo]
        s = tile[:, :, 0 : f1 - f0]
        for d in range(1, 10):
            s = s + tile[:, :, d : d + f1 - f0]
        s = s / 10.0
        return torch.sqrt(tile[:, :, 5 : 5 + f1 - f0] / torch.pow(1e-6 + s, 0.98) + 2.0) - math.sqrt(2.0)

    # (a): the raw MFCCs and a span's partials.
    lo, hi, sums, raw = [], [], [], []
    for f0, f1 in bounds:
        x = mel[:, :, f0:f1]
        if cfg.use_pcen:
            p = pcen_of(f0, f1)
            lo.append(p.amin(dim=(1, 2)) if f1 > f0 else torch.full((b,), math.inf))
            hi.append(p.amax(dim=(1, 2)) if f1 > f0 else torch.full((b,), -math.inf))
        else:
            hi.append(log_mel(x).amax(dim=(1, 2)) if f1 > f0 else torch.full((b,), -math.inf))
        r = (log_mel(x).transpose(1, 2) @ dct).transpose(1, 2)  # (B, C, frames)
        raw.append(r)
        sums.append(r.sum(dim=(1, 2)))
    raw = torch.cat(raw, dim=2)
    mean = _fold_spans(torch.stack(sums, 1), torch.add) / nc
    # (b): the squared deviations.
    sq = torch.stack([((raw[:, :, f0:f1] - mean[:, None, None]) ** 2).sum(dim=(1, 2)) for f0, f1 in bounds], 1)
    denom = torch.sqrt(_fold_spans(sq, torch.add) / (nc - 1)) + 1e-8
    # (c): the rows.
    hi = _fold_spans(torch.stack(hi, 1), torch.maximum)[:, None, None]
    if cfg.use_pcen:
        lo = _fold_spans(torch.stack(lo, 1), torch.minimum)[:, None, None]
    out = torch.empty((b, cfg.num_features, t), dtype=mel.dtype, device=mel.device)
    hd = 1 + dd
    for f0, f1 in bounds:
        if f1 == f0:
            continue
        if cfg.use_pcen:
            out[:, :m, f0:f1] = (pcen_of(f0, f1) - lo) / (hi - lo + 1e-8)
        else:
            db = torch.maximum(log_mel(mel[:, :, f0:f1]), hi - 80.0)
            out[:, :m, f0:f1] = torch.clamp((db + 80.0) * 0.0125, 0.0, 1.0)
        e0, e1 = max(f0 - hd, 0), min(f1 + hd, t)
        z = (raw[:, :, e0:e1] - mean[:, None, None]) / denom[:, None, None]
        out[:, m : m + c, f0:f1] = z[:, :, f0 - e0 : f1 - e0]
        # Deltas of frames [f0 - dd, f1 + dd) within the clip, then
        # delta-deltas of the span's own: neighbours clamped to the clip.
        tt = torch.arange(max(f0 - dd, 0), min(f1 + dd, t), device=mel.device)
        d1 = (z[:, :, (tt + 1).clamp(max=t - 1) - e0] - z[:, :, (tt - 1).clamp(min=0) - e0]) / 2.0
        own = slice(f0 - int(tt[0]), f0 - int(tt[0]) + f1 - f0)
        out[:, m + c : m + 2 * c, f0:f1] = d1[:, :, own]
        if dd:
            tt2 = torch.arange(f0, f1, device=mel.device)
            g = int(tt[0])
            out[:, m + 2 * c :, f0:f1] = (
                d1[:, :, (tt2 + 1).clamp(max=t - 1) - g] - d1[:, :, (tt2 - 1).clamp(min=0) - g]
            ) / 2.0
    return out


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
        p, i, i, i, i, i, i, i, p, i, i, i, i, i, f, p, p,
    ]
    lib.cdt_frontend_spectral.restype = i
    lib.cdt_frontend_epilogue.argtypes = [p, i, i, i, p, i, i, i, i, p, p, p]
    lib.cdt_frontend_epilogue.restype = i
    lib.cdt_frontend_contrast.argtypes = [
        p, i, i, i, i, i, i, i, i, i, p, i, i, p, f, p, i, p, p, p,
    ]
    lib.cdt_frontend_contrast.restype = i
    lib.cdt_frontend_spectral_fft.argtypes = [p, i, i, i, i, i, p, p, i, p, p, i, i, f, p, p]
    lib.cdt_frontend_spectral_fft.restype = i
    lib.cdt_frontend_contrast_fft.argtypes = [p, i, i, i, i, i, p, p, i, i, p, f, p, i, i, p, p]
    lib.cdt_frontend_contrast_fft.restype = i
    lib.cdt_frontend_blocks_b.argtypes = [i] * 5
    lib.cdt_frontend_blocks_b.restype = i
    for name, n_args in (("a", 4), ("b", 5), ("c", 6)):
        getattr(lib, f"cdt_frontend_smem_{name}").argtypes = [i] * n_args
        getattr(lib, f"cdt_frontend_smem_{name}").restype = ctypes.c_size_t
        getattr(lib, f"cdt_frontend_plan_{name}").argtypes = [i] * n_args
        getattr(lib, f"cdt_frontend_plan_{name}").restype = i
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
    global SPECTRAL_LAUNCHES, SPECTRAL_FFT_LAUNCHES
    _check_config(cfg, waves.shape[-1])
    if waves.device.type == "cpu":
        return power_mel_reference(waves, cfg)
    _check_cuda(waves, 2, "waves")
    b = waves.shape[0]
    t, n_mels = cfg.num_frames, cfg.n_mels
    fft = spectral_plan(cfg) == PLAN_FFT
    if fft:
        blocks = b * -(-t // spectral_fft_frames(cfg))
    else:
        blocks = spectral_grid(b, t, mel_groups(n_mels)[1])
    if blocks > _MAX_BLOCKS:
        raise ValueError(f"batch {b} needs more than the spectral kernel's {_MAX_BLOCKS} blocks")
    mel = torch.empty((b, n_mels, t), dtype=torch.float32, device=waves.device)
    if b == 0:
        return mel
    lib = build()
    stream = torch.cuda.current_stream(waves.device).cuda_stream
    pre, coef = int(cfg.use_pre_emphasis), float(cfg.pre_emphasis_coef)
    with torch.cuda.device(waves.device):
        if fft:
            f = _fft_constants(cfg, waves.device)
            err = lib.cdt_frontend_spectral_fft(
                waves.data_ptr(), b, waves.shape[1], t, cfg.n_fft, cfg.hop_length,
                f.window.data_ptr(), f.twiddles.data_ptr(), f.n_used, f.fb_w.data_ptr(),
                f.fb_ranges.data_ptr(), n_mels, pre, coef, mel.data_ptr(), stream,
            )
        else:
            k = _constants(cfg, waves.device)
            err = lib.cdt_frontend_spectral(
                waves.data_ptr(), b, waves.shape[1], t, cfg.n_fft,
                cfg.hop_length, k.j0, k.kpad, k.table.data_ptr(), k.n_bins,
                n_mels, k.mel_tiles, k.n_groups, pre, coef, mel.data_ptr(), stream,
            )
    _raise_on(err, lib, "spectral")
    SPECTRAL_LAUNCHES += 1
    SPECTRAL_FFT_LAUNCHES += fft
    return mel


def mel_epilogue_fused(
    mel: torch.Tensor, cfg: FeatureConfig = FeatureConfig()
) -> torch.Tensor:
    """Launch B: power mel (B, n_mels, num_frames) float32 →
    (B, num_features, num_frames). CUDA tensors launch the kernel on the
    current stream (no synchronise), on the span route its three kernels
    with their scratch (raw MFCCs and partials, epilogue_scratch_floats a
    clip) from the caching allocator; CPU tensors run
    mel_epilogue_reference."""
    global EPILOGUE_LAUNCHES, EPILOGUE_SPAN_LAUNCHES
    _check_mel(cfg, mel)
    if mel.device.type == "cpu":
        return mel_epilogue_reference(mel, cfg)
    _check_cuda(mel, 3, "mel")
    b, t = mel.shape[0], cfg.num_frames
    if b * epilogue_blocks(cfg) > _MAX_BLOCKS:
        raise ValueError(f"batch {b} needs more than the epilogue kernel's {_MAX_BLOCKS} blocks")
    out = torch.empty((b, cfg.num_features, t), dtype=torch.float32, device=mel.device)
    if b == 0:
        return out
    lib = build()
    dct = _dct(cfg.n_mfcc, cfg.n_mels, mel.device)
    span = epilogue_plan(cfg) == 0
    scratch = torch.empty(b * epilogue_scratch_floats(cfg), dtype=torch.float32, device=mel.device) if span else None
    with torch.cuda.device(mel.device):
        err = lib.cdt_frontend_epilogue(
            mel.data_ptr(), b, t, cfg.n_mels, dct.data_ptr(), cfg.n_mfcc,
            int(cfg.use_pcen), int(cfg.use_delta_delta), cfg.num_features,
            None if scratch is None else scratch.data_ptr(), out.data_ptr(),
            torch.cuda.current_stream().cuda_stream,
        )
    _raise_on(err, lib, "epilogue")
    EPILOGUE_LAUNCHES += 1
    EPILOGUE_SPAN_LAUNCHES += span
    return out


# -- the contrast launch ------------------------------------------------------------


class _ContrastGeometry(NamedTuple):
    j0: int          # [j0, j1): taps where either window is nonzero
    j1: int
    kpad: int        # j1 - j0 rounded up to two k-steps of 8 taps
    pow_lo: int      # the bands read power bins [pow_lo, pow_lo + n_pow)
    n_pow: int
    n_freqs: int     # magnitude bins, all of them, for the centroid
    pow_k0: int      # the power passes' first k-step of 8 taps from j0,
    pow_ks: int      # and their k-steps: the win_length window's support, an even count
    n_mag: int       # magnitude column pairs: one a bin, an even n_fft's Nyquist cosine in the DC bin's sine slot
    pow_passes: int  # DFT passes of 256 columns over the power pairs,
    n_passes: int    # and those and the magnitude's passes
    offsets: tuple   # per band: first bin, from pow_lo
    widths: tuple    # per band: bins
    tops: tuple      # per band: bins in the top tail
    bots: tuple      # per band: bins in the bottom tail


@functools.lru_cache(maxsize=32)
def _geometry(cfg: FeatureConfig) -> _ContrastGeometry:
    """The contrast launch's shapes, from the bands of
    ops/frontend.py::contrast_from_spectra and the supports of its two
    windows (the win_length Hann for the bands' power, the n_fft Hann for
    the centroid's magnitude). The GEMM plan's power passes run over the
    win_length window's k-steps alone, its magnitude passes over both
    windows' (kpad): csrc/frontend_kernel.cu's contrast_kernel."""
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
    power = np.nonzero(np.any(c4 != 0, axis=1))[0]
    support = np.nonzero(np.any(c4 != 0, axis=1) | np.any(c5 != 0, axis=1))[0]
    j0, j1 = int(support[0]), int(support[-1]) + 1
    kpad = -(-(j1 - j0) // 16) * 16
    pow_k0 = (int(power[0]) - j0) // 8
    pow_ks = -(-(int(power[-1]) + 1 - j0 - 8 * pow_k0) // 16) * 2
    pow_k0 = min(pow_k0, kpad // 8 - pow_ks)  # the k-steps stay inside [0, kpad)
    n_mag = n_freqs - (cfg.n_fft % 2 == 0)
    pow_passes = -(-2 * n_pow // _PASS_COLS)
    return _ContrastGeometry(
        j0, j1, kpad, pow_lo, n_pow, n_freqs, pow_k0, pow_ks, n_mag, pow_passes,
        pow_passes - (-2 * n_mag // _PASS_COLS), tuple(lo - pow_lo for lo in lows),
        tuple(widths), tuple(tops), tuple(bots),
    )


def _contrast_fft(n_fft: int, hop: int, n_pow: int) -> tuple:
    """(takes it, bytes): whether the contrast launch takes its FFT plan
    (plan_c's first branch: an n_fft `_fft_fits` takes, from 640 on, whose
    LayoutF fits) and LayoutF's bytes."""
    smem = _fft_layout(n_fft, n_fft, hop, n_pow, contrast=True)[1]
    return _fft_fits(n_fft, n_fft) and n_fft >= _FFT_MIN_NFFT and smem <= _MAX_SMEM, smem


def _contrast_plan(cfg: FeatureConfig) -> tuple:
    """(level, bytes): csrc/frontend_kernel.cu's plan_c. For an n_fft from
    640 on, odd or even, that the FFT plans take (`_fft_fits`),
    CONTRAST_FFT where LayoutF fits (`_contrast_fft`); else the GEMM's
    (`_contrast_gemm_plan`)."""
    fft, smem = _contrast_fft(cfg.n_fft, cfg.hop_length, _geometry(cfg).n_pow)
    return (CONTRAST_FFT, smem) if fft else _contrast_gemm_plan(cfg)


def _contrast_gemm_plan(cfg: FeatureConfig) -> tuple:
    """(level, bytes) of the GEMM plan, csrc/frontend_kernel.cu's LayoutC:
    its shared memory with the smallest ring is the ring's two slots, the
    tile's waveform span, the tile's power over the bands' bins (128 rows),
    the clip's contrast rows and the reduction slots; at the first level
    that fits, 0 all of them, 1 without the span (read from device memory),
    2 without the contrast rows too (in the output), 3 without the power
    rows too (in a scratch buffer)."""
    g = _geometry(cfg)
    rows = (_ROWS_A * g.n_pow + 3) // 4 * 4
    con = (cfg.num_frames * (cfg.n_contrast_bands + 1) + 3) // 4 * 4
    span = _span_floats(cfg.hop_length, g.kpad)
    for level in range(4):
        smem = _ring_bytes(
            (span if level == 0 else 0) + (rows if level < 3 else 0) + (con if level < 2 else 0) + _RED_C
        )
        if smem <= _MAX_SMEM or level == 3:
            return level, smem


def contrast_ring(cfg: FeatureConfig) -> tuple:
    """(chunks, slots) of the GEMM plan's ring, csrc/frontend_kernel.cu's
    chunks_c and slots_c: a row tile's chunks (its power passes of pow_ks,
    its magnitude passes of kpad / 8), and the slots, as many as shared
    memory holds at its LayoutC level, up to 4 (kMaxSlots) and the
    chunks, at least 2."""
    g = _geometry(cfg)
    chunks = g.pow_passes * g.pow_ks + (g.n_passes - g.pow_passes) * (g.kpad // 8)
    level, smem = _contrast_gemm_plan(cfg)
    slots = min(chunks, 4)
    while slots > 2 and smem + 4 * (slots - _SLOTS_A) * _CHUNK > _MAX_SMEM:
        slots -= 1
    return chunks, slots


def contrast_threads(cfg: FeatureConfig) -> int:
    """The contrast launch's threads a block: its FFT plan's 256, or its
    GEMM plan's 384 (two MMA warpgroups and a warpgroup of band warps;
    csrc/frontend_kernel.cu's kThreadsA and kThreadsC)."""
    return _WARPS_A * 32 if contrast_level(cfg) == CONTRAST_FFT else _THREADS_C


def contrast_level(cfg: FeatureConfig) -> int:
    """The contrast launch's plan (cdt_frontend_plan_c): CONTRAST_FFT for an
    n_fft from 640 on, odd or even, whose rows, Bluestein scratch and
    tables fit a block; else
    LayoutC's level, how much of the GEMM plan moves from shared memory to
    device memory (see _contrast_plan)."""
    return _contrast_plan(cfg)[0]


def contrast_smem_bytes(cfg: FeatureConfig) -> int:
    """The contrast launch's shared memory under its plan (with the GEMM's
    smallest ring; cdt_frontend_smem_c; see _contrast_plan)."""
    return _contrast_plan(cfg)[1]


class _ContrastConstants(NamedTuple):
    pow_cols: torch.Tensor  # (taps, 2 n_pow): the power passes' DFT columns over their taps
    mag_cols: torch.Tensor  # (j1 - j0, 2 n_mag): the magnitude passes' DFT columns
    table: torch.Tensor     # the chunk stream the contrast launch's ring reads
    freqs: torch.Tensor     # (n_freqs,): the centroid's bin frequencies
    bands: torch.Tensor     # (n_bands, 4) int32: offset, width, top, bottom a band


@functools.lru_cache(maxsize=16)
def _contrast_constants(cfg: FeatureConfig, device: torch.device) -> _ContrastConstants:
    """The contrast launch's DFT columns, split into hi/lo TF32 here, once
    per config, and laid out as launch A's tables are (`_tiles`): first
    the power passes, per pass of 256 columns one 16 KB chunk per k-step of
    8 taps over the win_length window's k-steps [pow_k0, pow_k0 + pow_ks)
    from j0, each power bin of the bands its cos and -sin columns
    interleaved; then the magnitude passes, one chunk per k-step over [j0,
    j0 + kpad), a bin's pair a bin of the n_fft window, but for an even
    n_fft the DC bin's pair: its cosine, then the Nyquist bin's cosine,
    the two sines being zero (the Nyquist one up to float64 rounding,
    1.2e-13 at n_fft 512). Zero past them and past the taps."""
    g = _geometry(cfg)
    c4, s4 = filters.dft_matrices(cfg.n_fft, cfg.win_length)
    c5, s5 = filters.dft_matrices(cfg.n_fft, cfg.n_fft)
    t0 = g.j0 + 8 * g.pow_k0
    taps, bins, p2 = slice(t0, min(t0 + 8 * g.pow_ks, g.j1)), slice(g.pow_lo, g.pow_lo + g.n_pow), 2 * g.n_pow
    power = np.zeros((8 * g.pow_ks, g.pow_passes * _PASS_COLS), np.float32)
    n = taps.stop - taps.start
    power[:n, 0:p2:2] = c4[taps, bins]
    power[:n, 1:p2:2] = s4[taps, bins]
    mag = np.zeros((g.kpad, (g.n_passes - g.pow_passes) * _PASS_COLS), np.float32)
    m, rows = g.j1 - g.j0, slice(g.j0, g.j1)
    if cfg.n_fft % 2 == 0:
        half = cfg.n_fft // 2
        mag[:m, 0], mag[:m, 1] = c5[rows, 0], c5[rows, half]
        mag[:m, 2 : 2 * g.n_mag : 2] = c5[rows, 1:half]
        mag[:m, 3 : 2 * g.n_mag : 2] = s5[rows, 1:half]
    else:
        mag[:m, 0 : 2 * g.n_mag : 2] = c5[rows]
        mag[:m, 1 : 2 * g.n_mag : 2] = s5[rows]
    stream = torch.cat(
        [_tiles(power[:, p * _PASS_COLS : (p + 1) * _PASS_COLS]) for p in range(g.pow_passes)]
        + [_tiles(mag[:, p * _PASS_COLS : (p + 1) * _PASS_COLS]) for p in range(g.n_passes - g.pow_passes)]
    )
    return _ContrastConstants(
        torch.from_numpy(np.ascontiguousarray(power[:n, :p2])).to(device),
        torch.from_numpy(np.ascontiguousarray(mag[:m, : 2 * g.n_mag])).to(device),
        stream.reshape(-1).to(device), *_centroid_and_bands(cfg, device),
    )


@functools.lru_cache(maxsize=16)
def _centroid_and_bands(cfg: FeatureConfig, device: torch.device) -> tuple:
    """(freqs, bands), both plans': the centroid's bin frequencies
    (n_freqs,) and the bands (n_bands, 4) int32, per band its first bin
    (from the first power bin), bins, top and bottom tail lengths."""
    g = _geometry(cfg)
    freqs = np.linspace(0, cfg.sample_rate // 2, g.n_freqs, dtype=np.float32)
    bands = np.array([g.offsets, g.widths, g.tops, g.bots], np.int32).T.reshape(-1, 4)
    return torch.from_numpy(freqs).to(device), torch.from_numpy(np.ascontiguousarray(bands)).to(device)


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
    segment_samples) → (B, n_contrast_bands + 1, num_frames). Its DFT with
    TF32 operands (passes=3: the kernel's 3xTF32, as
    `power_mel_split_reference` models launch A's; passes=1: one TF32
    product) as the GEMM plan lays it out (`_contrast_constants`): the
    power pairs over the win_length window's k-steps, the magnitude pairs
    over both windows' support, an even n_fft's DC and Nyquist cosines in
    one pair; its tails by stable rank as the kernel selects them. For
    tests and chip_smoke.py; nothing on the main path calls it."""
    _check_contrast(cfg, waves.shape[-1])
    if passes not in (1, 3):
        raise ValueError(f"passes must be 1 or 3, got {passes}")
    g = _geometry(cfg)
    k = _contrast_constants(cfg, waves.device)
    frames = frame_signal(waves, cfg.n_fft, cfg.hop_length)
    t0 = g.j0 + 8 * g.pow_k0
    pw = _split_matmul(frames[..., t0 : t0 + k.pow_cols.shape[0]], k.pow_cols, passes)
    spec = torch.zeros(pw.shape[:2] + (g.n_freqs,), dtype=pw.dtype, device=pw.device)
    spec[..., g.pow_lo : g.pow_lo + g.n_pow] = pw[..., 0::2] ** 2 + pw[..., 1::2] ** 2
    out = _split_matmul(frames[..., g.j0 : g.j1], k.mag_cols, passes)
    re, im = out[..., 0::2], out[..., 1::2]
    if cfg.n_fft % 2 == 0:  # DC's cosine and Nyquist's, then bins 1 to n_fft / 2 - 1
        mag = torch.sqrt(torch.cat([re[..., :1] ** 2, re[..., 1:] ** 2 + im[..., 1:] ** 2, im[..., :1] ** 2], -1))
    else:
        mag = torch.sqrt(re**2 + im**2)
    return contrast_from_spectra(spec, mag, cfg, tails="rank").transpose(1, 2)


@functools.lru_cache(maxsize=16)
def _contrast_fft_constants(cfg: FeatureConfig, device: torch.device) -> tuple:
    """(windows, twiddles): the contrast launch's FFT plan's windows, (2,
    n_fft) the padded win_length Hann (the bands' power) then the n_fft
    Hann (the centroid's magnitude), and its tables (`_fft_tables`)."""
    windows = np.stack([filters.padded_window(cfg.win_length, cfg.n_fft), filters.padded_window(cfg.n_fft, cfg.n_fft)])
    return (
        torch.from_numpy(windows.astype(np.float32)).to(device),
        torch.from_numpy(_fft_tables(cfg.n_fft)).to(device),
    )


def spectral_contrast_fft_reference(
    waves: torch.Tensor, cfg: FeatureConfig = FeatureConfig(use_spectral_contrast=True)
) -> torch.Tensor:
    """The contrast launch's FFT plan's arithmetic in plain torch ops: (B,
    segment_samples) → (B, n_contrast_bands + 1, num_frames). Both windows
    of each frame through one complex FFT of n_fft points, z = w_win x + i
    w_nfft x, by the plan's Stockham stages and twiddle table
    (`_stockham`); the two real spectra split by conjugate symmetry (for an
    odd n_fft as for an even one),
    (Z[k] + conj Z[n - k]) / 2 the power's and |Z[k] - conj Z[n - k]| / 2
    the magnitude; the tails by stable rank, an exact selection as the
    kernel's sort is (the sums' order differs). For tests and
    chip_smoke.py; nothing on the main path calls it."""
    _check_contrast(cfg, waves.shape[-1])
    windows, tw = _contrast_fft_constants(cfg, waves.device)
    frames = frame_signal(waves, cfg.n_fft, cfg.hop_length)
    re, im = _stockham(frames * windows[0], frames * windows[1], tw, cfg.n_fft)
    n = cfg.n_fft
    bins = torch.arange(n // 2 + 1, device=waves.device)
    c = (n - bins) % n
    ar, ai = 0.5 * (re[..., bins] + re[..., c]), 0.5 * (im[..., bins] - im[..., c])
    dr, di = 0.5 * (re[..., bins] - re[..., c]), 0.5 * (im[..., bins] + im[..., c])
    return contrast_from_spectra(ar * ar + ai * ai, torch.sqrt(dr * dr + di * di), cfg, tails="rank").transpose(1, 2)


def spectral_contrast_fused(
    waves: torch.Tensor, cfg: FeatureConfig = FeatureConfig(use_spectral_contrast=True)
) -> torch.Tensor:
    """The contrast launch: (B, segment_samples) float32, not pre-emphasized
    → contrast rows (B, n_contrast_bands + 1, num_frames). CUDA tensors
    launch the kernel on the current stream (no synchronise); CPU tensors
    run spectral_contrast_reference."""
    global CONTRAST_LAUNCHES, CONTRAST_FFT_LAUNCHES
    _check_contrast(cfg, waves.shape[-1])
    if waves.device.type == "cpu":
        return spectral_contrast_reference(waves, cfg)
    _check_cuda(waves, 2, "waves")
    b, t = waves.shape[0], cfg.num_frames
    if b > _MAX_BLOCKS:  # one block a clip, which loops over its row tiles
        raise ValueError(f"batch {b} needs more than the contrast kernel's {_MAX_BLOCKS} blocks")
    out = torch.empty((b, cfg.n_contrast_bands + 1, t), dtype=torch.float32, device=waves.device)
    if b == 0:
        return out
    g = _geometry(cfg)
    level = contrast_level(cfg)
    lib = build()
    stream = torch.cuda.current_stream(waves.device).cuda_stream
    half_sr = float(cfg.sample_rate / 2.0)
    with torch.cuda.device(waves.device):
        if level == CONTRAST_FFT:
            windows, tw = _contrast_fft_constants(cfg, waves.device)
            freqs, bands = _centroid_and_bands(cfg, waves.device)
            err = lib.cdt_frontend_contrast_fft(
                waves.data_ptr(), b, waves.shape[1], t, cfg.n_fft, cfg.hop_length,
                windows.data_ptr(), tw.data_ptr(), g.pow_lo, g.n_pow, freqs.data_ptr(), half_sr,
                bands.data_ptr(), cfg.n_contrast_bands, max(g.widths, default=0), out.data_ptr(), stream,
            )
        else:
            k = _contrast_constants(cfg, waves.device)
            scratch = None
            if level == 3:  # the power rows in device memory, 128 a clip
                scratch = torch.empty((b, _ROWS_A, g.n_pow), dtype=torch.float32, device=waves.device)
            err = lib.cdt_frontend_contrast(
                waves.data_ptr(), b, waves.shape[1], t, cfg.n_fft, cfg.hop_length,
                g.j0, g.kpad, g.pow_k0, g.pow_ks, k.table.data_ptr(), g.n_pow, g.n_freqs,
                k.freqs.data_ptr(), half_sr, k.bands.data_ptr(),
                cfg.n_contrast_bands, None if scratch is None else scratch.data_ptr(),
                out.data_ptr(), stream,
            )
    _raise_on(err, lib, "contrast")
    CONTRAST_LAUNCHES += 1
    CONTRAST_FFT_LAUNCHES += level == CONTRAST_FFT
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
