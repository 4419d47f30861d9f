"""Where the contrast launch's time goes, on one NVIDIA card.

    python3 tools/contrast_probe.py [--baseline PATH ...] [--gemm | --routes | --primes | --wide | --bluestein]

Times launch C of the front-end kernel (csrc/frontend_kernel.cu:
contrast_kernel, the launcher's spectral-contrast rows, its GEMM plan)
with CUDA events at B = 256, 1024 and 4096 on the shipped config with
contrast, as built and in variants (gemm_variants), each a string edit of
the source built with the same nvcc flags into build/kernels/ (all builds
run at once): the band stage left out, the centroid and z-norm left out,
and by design its passes cut or its ring's depth changed. Each --baseline
is another copy of the source timed in turns with this one through the C
interface and tables of its own design (an older GEMM plan's by
legacy_table: the LEGACY_* texts and legacy_table serve a source whose
contrast_kernel still takes n_passes, the design before the band warps,
which PERF.md's split and turns of the band warps' design were taken
against; they can go once no comparison with such a source is wanted).
`--gemm` runs that split alone, every build (the
baselines too) with its own design's variants, after printing each
build's contrast_kernel registers and stack (cuobjdump): each build, its
variants, the build again, then the builds once more in reverse.
Then launch C's FFT plan (contrast_fft_kernel) at B = 1024 on n_fft 2048,
4096, 2000, 3000, 1792, 2744, 1760 and 2662 with contrast (hop n_fft / 4,
6 bands; the frames of 64 clips repeated; 2000 runs radix-4 and radix-5
stages, 1792 and 2744 radix-7 ones, 1760 and 2662 radix-11 ones) and at
44.1 kHz on n_fft 1764, 1323 and 2205 (40, 30 and 50 ms windows, a 10 ms
hop; the last two odd), as built, with every n_fft through the kernel's
instance of radix 11, with the twiddle rule before an odd n_fft on an
even one (past n_fft / 2 the negated entry of k - n_fft / 2, not the
conjugate of entry n_fft - k), and, on 2048, 4096 and 2000, in variants
that split its time:
  - ranked tails: the bands' tails by stable rank (band_ranked, the GEMM
    plan's past 128 bins) instead of the sort in registers;
  - no band tails: each (frame, band)'s row takes one power value;
  - no FFT stages; no staging (the span left as it was);
  - DivBy for a power of two: the power-of-two stages index their
    butterflies by DivBy's multiplies, as the mixed stages do, instead
    of shifts.
A baseline that refuses an n_fft is left out there.
Then where the FFT plan's threshold (kFftMinNfft) lies: both plans on
n_fft 640, 672, 675, 693, 704, 768, 784, 1000 and 1024 with contrast, hop
n_fft / 4, at
B = 1024 and 4096, through their C functions, in turns (GEMM, FFT, FFT,
GEMM). Then the routes of ROUTES, configs users set whose plan is timed
once beside its library call: the launch as its plan takes it
(contrast_level), through its C function, and the fft rows
(`spectral_contrast(method="fft")`: cuFFT and torch.topk), in turns, at B
= 1024. `--routes` builds the source as built alone and runs that section
only. `--primes` builds the source as built and the baselines and runs:
the FFT plan on n_fft 2048, 2000, 1792, 2662 and 44.1 kHz at the odd 1323
in turns with the baselines; where the generic prime stage gives way to
Bluestein's (kFftMaxPrime): at B = 1024 on the 16 kHz window of p ms for
p in PRIMES (n_fft 16 p, hop n_fft / 4, contrast), the GEMM plan, the FFT
plan, the other prime stage and Bluestein's stage called (a __noinline__
wrapper; spectral_probe.py's cap_variants) and the fft rows in turns, the largest
p at which the generic stage's plan beats the GEMM and the fft rows, the
p at which Bluestein's beats the generic one, and the primes at which
the plan as built loses to either from kFftMinNfft on (under it the GEMM
keeps the config whatever the cap); both plans near
kFftMinNfft on n_fft with a factor of 13 (650, 676 and the odd 715); and
the routes section. In that mode the FFT plan is also timed with
fft_stage_prime inlined, not called (prime_variants), in turns with the
baselines, on those n_fft and on 1760, 1664, 2704 and 650. `--bounds` prints
launches A's and C's bounds at B = 1024 on the windows of PRIMES and WIDE
(arithmetic on the shapes; no card, no build). `--wide` builds
the source as built, its wide variants (wide_variants) and the baselines,
prints every build's launch C instances' registers and stack (cuobjdump),
and runs the wide-band section: the FFT plan on the windows of WIDE, whose
widest band is 459 to 868 bins (n_fft 4112, 5296, 6144, 6544 and 5872
with 6 bands and 4608 with 8, hop n_fft / 4 at 16 kHz; 8192 at 44.1 kHz,
hop 2048), and on launch C's older FFT plans (WIDE_KEEP: 2048, 4096, 2192,
2704, 1664), at B = 1024 in turns (the baselines, as built, the variants,
as built, the baselines), then the fft rows, beside the bound (an FFT of
each window at the FP32 peak, the tails as selections: chip_smoke.py's).
`--bluestein` builds the source as built,
spectral_probe.py's Bluestein variants (Bluestein's stage left out; its
gather and scatter only; the radix stages left out) and the baselines,
prints their cuobjdump lines, and splits launch C's Bluestein plans
(BLUESTEIN: n_fft 2096, 2192, 4112, 5296, 5872 and 6544 with 6 bands, hop
n_fft / 4) and its plans with no Bluestein prime (2048, 4096, 2704 and
1664) at B = 1024 the same way, beside the fft rows and the bound.
Prints the card's name and power limit first, and each build's
max-relative deviation from the plain version (the variants' rows are
wrong by design). Needs a CUDA card and nvcc; imports no JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import dataclasses
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from cough_detector_tpu_torch.config import FeatureConfig  # noqa: E402
from cough_detector_tpu_torch.ops import frontend, frontend_kernel  # noqa: E402
from cough_detector_tpu_torch.utils import kernel_build  # noqa: E402

ITERS = {1024: 20, 4096: 10}
GEMM_ITERS = {256: 40, 1024: 20, 4096: 10}

GEMM_TAILS = "        const float v = band_value(pw + r * n_pow, __ldg(bands + i), lane);\n"
FFT_TAILS = "      const float v = band_value_sorted(pw + f * n_pow, bd, lane);\n"
WIDE_TAILS = ("    if constexpr (kWide)\n      wide_bands(pw, n_pow, bands, n_bands, frames, con + t0, n_frames, "
              "reinterpret_cast<unsigned*>(buf));\n")
WIDE_RADIX7 = "lp <= 7 ? (const void*)contrast_fft_kernel<7, false, 0, true>"
WIDE_CALL = "__device__ __noinline__ void wide_bands("
BOUNDS_C = "__launch_bounds__(kThreadsA, 2) contrast_fft_kernel("
WIDE_BAND = "constexpr int kWideBand = 512;"
WIDE_FROM = (256, 128)  # kWideBand's variants: the width past which block_tails takes a band
PRIMES = (13, 17, 23, 31, 43, 61, 89, 101, 113, 127, 131, 137, 149, 173, 211, 257, 331, 409)  # the cap's probe: a window of p ms at 16 kHz, n_fft 16 p
FFT_CONFIGS = {
    n_fft: FeatureConfig(n_fft=n_fft, win_length=n_fft, hop_length=n_fft // 4, n_mels=128, f_max=8000.0,
                         use_spectral_contrast=True)
    for n_fft in (2048, 4096, 2000, 3000, 1792, 2744, 1760, 2662, 640, 650, 672, 675, 676, 693, 704, 715, 768, 784,
                  1000, 1024, *(16 * p for p in PRIMES))
}
ONE_INSTANCE = "FFT plan, the radix-11 instance for every n_fft"
# The twiddle lookup as built (past n_fft / 2, the conjugate of entry n_fft
# - idx) and as the variant TWIDDLE_NEGATED reads it on an even n_fft (the
# negated entry of idx - n_fft / 2, the rule before odd n_fft).
TWIDDLE = """\
  const bool lo = 2 * idx <= n_fft;
  const float2 t = tw[lo ? idx : n_fft - idx];
  return make_float2(t.x, lo ? t.y : -t.y);
"""
TWIDDLE_NEGATED_RULE = """\
  if (n_fft % 2 == 0) {  // the negated entry of idx - n_fft / 2
    const int half = n_fft / 2;
    const bool lo = idx <= half;
    const float2 t = tw[lo ? idx : idx - half];
    return lo ? t : make_float2(-t.x, -t.y);
  }
""" + TWIDDLE
TWIDDLE_NEGATED = "FFT plan, the negated twiddle rule for an even n_fft"


def _sr44k(n_fft: int) -> FeatureConfig:
    """44.1 kHz as users set it: a 10 ms hop, 128 mels to 22.05 kHz."""
    return FeatureConfig(sample_rate=44100, n_fft=n_fft, win_length=n_fft, hop_length=441, n_mels=128,
                         f_max=22050.0, use_spectral_contrast=True)


for _n in (1764, 1323, 2205):
    FFT_CONFIGS[f"44.1 kHz, {_n}"] = _sr44k(_n)

# Configs users set whose plan is timed once beside its library call: 30
# and 50 ms windows at 44.1 kHz (odd), n_fft with a prime factor of 13 (the
# FFT plan's generic prime stage), and one past the cap (Bluestein's
# stage; its GEMM until it).
ROUTES = {
    "44.1 kHz, 1323 (30 ms, odd)": _sr44k(1323),
    "44.1 kHz, 2205 (50 ms, odd)": _sr44k(2205),
    "n_fft 1664 (2^7 13)": FeatureConfig(n_fft=1664, win_length=1664, hop_length=416, n_mels=128, f_max=8000.0,
                                         use_spectral_contrast=True),
    "n_fft 2704 (2^4 13^2)": FeatureConfig(n_fft=2704, win_length=2704, hop_length=676, n_mels=128, f_max=8000.0,
                                           use_spectral_contrast=True),
    "n_fft 2192 (2^4 137)": FeatureConfig(n_fft=2192, win_length=2192, hop_length=548, n_mels=128, f_max=8000.0,
                                          use_spectral_contrast=True),
}


def _wide(n_fft: int, bands: int = 6) -> FeatureConfig:
    """A 16 kHz contrast window of n_fft at hop n_fft / 4, 128 mels."""
    return FeatureConfig(n_fft=n_fft, win_length=n_fft, hop_length=n_fft // 4, n_mels=128, f_max=8000.0,
                         use_spectral_contrast=True, n_contrast_bands=bands)


# The wide-band windows: the widest band past 512 bins but at 4112 (459).
WIDE = {
    "n_fft 4112 (2^4 257)": _wide(4112),
    "n_fft 5296 (2^4 331)": _wide(5296),
    "n_fft 6144 (2^11 3)": _wide(6144),
    "n_fft 6544 (2^4 409)": _wide(6544),
    "n_fft 5872 (2^4 367)": _wide(5872),
    "n_fft 4608, 8 bands": _wide(4608, 8),
    "44.1 kHz, n_fft 8192": FeatureConfig(sample_rate=44100, n_fft=8192, win_length=8192, hop_length=2048,
                                          n_mels=128, f_max=22050.0, use_spectral_contrast=True),
}
WIDE_KEEP = (2048, 4096, 2192, 2704, 1664)
# Launch C's Bluestein plans (--bluestein): a prime past the cap (131, 137,
# 257, 331, 367 and 409 ms at 16 kHz).
BLUESTEIN = {f"n_fft {n}": _wide(n) for n in (2096, 2192, 4112, 5296, 5872, 6544)}
# and launch C's plans with no Bluestein prime, timed beside them.
BLUESTEIN_KEEP = {f"n_fft {n} (no Bluestein prime)": _wide(n) for n in (2048, 4096, 2704, 1664)}  # launch C's older FFT plans, timed against the baselines
from spectral_probe import BLUESTEIN_LAYOUTS, HALF_TWIDDLES, PEAK_FP32_FLOPS, PEAK_HBM_BYTES, legacy_tables  # noqa: E402


ROUTES_BY_NFFT = {1664: ROUTES["n_fft 1664 (2^7 13)"], 2704: ROUTES["n_fft 2704 (2^4 13^2)"]}


# Launch C's FFT stages, the call the variants without them leave out.
FFT_ROWS_C = "    fft_rows<kRadix, kPrime ? kPrimeC : 0, kBluestein>(buf, F, n_fft, n_fft, twr, &bl);\n"


def edit(src: str, old: str, new: str) -> str:
    if old not in src:
        raise SystemExit(f"the source no longer holds the text this variant edits: {old[:60]!r}")
    return src.replace(old, new, 1)


def variants(src: str) -> dict:
    return {
        "as built": src,
        **gemm_variants(src),
        "FFT plan, ranked tails": edit(src, FFT_TAILS, "      float v1[1];\n      band_ranked<1>(pw + f * n_pow + bd.x, 0, bd.y, bd.z,"
                                                       " bd.w, lane, v1);\n      const float v = bd.y > 1 ? v1[0] : 0.0f;\n"),
        "FFT plan, no band tails": edit(src, FFT_TAILS, "      const float v = pw[f * n_pow + lane];\n"),
        "FFT plan, no FFT stages": edit(src, FFT_ROWS_C, ""),
        "FFT plan, no staging": edit(src, "    stage_flat(span, src, (F - 1) * hop + n_fft);\n", ""),
        "FFT plan, DivBy for a power of two": edit(
            edit(src, "fft_stage<2, true>(", "fft_stage<2, false>("), "fft_stage<4, true>(", "fft_stage<4, false>("
        ),
        ONE_INSTANCE: edit(edit(src, "lp <= 7            ? (const void*)contrast_fft_kernel<7, false, 0, false>",
                                "false              ? (const void*)contrast_fft_kernel<7, false, 0, false>"),
                           "lp == 11           ?", "lp <= 11           ?"),
        TWIDDLE_NEGATED: edit(src, TWIDDLE, TWIDDLE_NEGATED_RULE),
    }


# The GEMM plan before its power and magnitude passes were split (one
# ring of n_passes passes of kpad / 8 chunks, the power pairs first, the
# band stage after the last pass on all 8 warps): a source whose
# contrast_kernel takes n_passes (LEGACY_GEMM) takes that design's C
# interface, tables and variants.
LEGACY_GEMM = "int kpad, const float* __restrict__ table, int n_passes, int n_pow, int n_freqs,"
LEGACY_RING = "  ring.n = n_passes * n_ksteps;\n"
LEGACY_CENTROID = """            const float m = sqrtf(sq);
            msum[h] += m;
            fsum[h] += __ldg(freqs + bin - n_pow) * m;
"""
LEGACY_ZNORM = """  znorm_rows(con, n, red, out + (size_t)blockIdx.x * n);
}

// -- The FFT plans"""
LEGACY_KSTEPS = "  const int n_ksteps = kpad / 8;\n  Ring ring;\n"
LEGACY_SLOTS = "  int n_slots = kMaxSlots;\n  while (n_slots > 2 && (lay.bytes(n_slots) > kMaxSmem || chunks % n_slots)) --n_slots;\n"

# The GEMM plan's texts its variants edit (its band warps' call, the
# magnitude's sums, the z-norm, the passes' loops and a tile's chunks).
BAND_WARPS = "    band_values<kBandFrames>(pw + f0 * n_pow, n_pow, __ldg(bands + i), lane, v);\n"
MMA_ITEMS = "    band_items(counters + t0 / kRows % 2, pw, n_pow, bands, n_bands, frames, con + t0, n_frames, lane);\n"
BAND_FRAMES = "constexpr int kBandFrames = 4;"
CENTROID = """            const bool two = i == 0 && n_mag < n_freqs;  // the DC and Nyquist cosines
            const float m = sqrtf(two ? re * re : re * re + im * im);
            msum[h] += m;
            fsum[h] += __ldg(freqs + i) * m;
            if (two) {
              const float mn = sqrtf(im * im);
              msum[h] += mn;
              fsum[h] += __ldg(freqs + n_freqs - 1) * mn;
            }
"""
ZNORM = "  znorm_rows<kBarMma>(con, n, red, out + (size_t)blockIdx.x * n);\n}\n"
MAG_PASSES = "    for (int p = 0; p < mag_passes; ++p) {\n      dft.run(q, slot, parity, mag_ks);\n"
POW_PASSES = "    for (int p = 0; p < pow_passes; ++p) {\n      dft.run_from(q, slot, parity, pow_k0, pow_ks);\n"
TILE_CHUNKS = "  ring.per = ring.n = pow_passes * pow_ks + mag_passes * mag_ks;\n"
MAX_SLOTS = "constexpr int kMaxSlots = 4;"
REGISTERS = ("constexpr int kRegMma = 208;", "constexpr int kRegBand = 88;")
RANK_UNROLL = "#pragma unroll 1\n  for (int b = 0; b < w; ++b) {"
SORTED_BAND = "constexpr int kSortedBand = 128;"


def power_ksteps(cfg: FeatureConfig) -> int:
    """k-steps of 8 taps over the win_length window's nonzero taps (the
    power columns' support), rounded up to an even count."""
    from cough_detector_tpu_torch.ops import filters

    c4, _ = filters.dft_matrices(cfg.n_fft, cfg.win_length)
    support = np.nonzero(np.any(c4 != 0, axis=1))[0]
    return -(-(int(support[-1]) + 1 - int(support[0])) // 16) * 2


def gemm_variants(src: str) -> dict:
    """The GEMM plan (contrast_kernel) with a part of it left out or
    changed, by the design `src` holds; the rows are wrong by design but
    for the ring's depth. Both designs: no band tails (each (frame,
    band)'s row takes one power value); no centroid or z-norm (the
    magnitude's sums take the squares, no sqrt or frequency loads, and the
    rows are copied out unnormalized). The design before the split passes
    (LEGACY_GEMM): one DFT pass (the tile stops after its first pass of
    256 columns); every pass over the power window's support (50 k-steps
    of 8 taps on the shipped config, where each runs 64); the ring at two
    and three slots (four as built). The design with band warps: the
    band items on the band warps alone (the MMA warps draw none after
    their magnitude passes); one or two frames of a band an item (four as
    built); no
    magnitude passes, or no power passes (the ring reads the others'
    chunks alone: the shipped config's clips are one row tile); the ring
    at two and three slots (four as built); setmaxnreg's 216 / 72 and
    200 / 104 registers (208 / 88 as built); every band ranked, 4 bins a lane (those
    to 128 bins sorted as built); the rank loop unrolled by 4 (not as built)."""
    if LEGACY_GEMM in src:
        one_pass = edit(src, LEGACY_RING, "  ring.n = n_ksteps;\n")
        copy = ("  for (int i = tid; i < n; i += kThreadsA) out[(size_t)blockIdx.x * n + i] = con[i];\n}\n\n"
                "// -- The FFT plans")
        return {
            "no band tails": edit(src, GEMM_TAILS, "        const float v = pw[r * n_pow + lane];\n"),
            "no centroid or z-norm": edit(edit(src, LEGACY_CENTROID, "            msum[h] += sq;\n"),
                                          LEGACY_ZNORM, copy),
            "one DFT pass": edit(one_pass, "for (int p = 0; p < n_passes; ++p) {", "for (int p = 0; p < 1; ++p) {"),
            "passes over the power window's support": edit(
                src, LEGACY_KSTEPS, LEGACY_KSTEPS.replace("kpad / 8", str(power_ksteps(FeatureConfig())))),
            **{f"{k} ring slots": edit(src, LEGACY_SLOTS, LEGACY_SLOTS.replace("kMaxSlots;", f"{k};"))
               for k in (2, 3)},
        }
    copy = "  for (int i = tid; i < n; i += kThreadsA) out[(size_t)blockIdx.x * n + i] = con[i];\n}\n"
    return {
        "no band tails": edit(src, BAND_WARPS, "    for (int f = 0; f < kBandFrames; ++f) v[f] = pw[(f0 + f) * n_pow + lane];\n"),
        "the band warps alone": edit(src, MMA_ITEMS, ""),
        **{f"{k} frame{'s' * (k > 1)} a band item": edit(src, BAND_FRAMES, f"constexpr int kBandFrames = {k};")
           for k in (1, 2)},
        "no centroid or z-norm": edit(edit(src, CENTROID, "            msum[h] += re * re + im * im;\n"),
                                      ZNORM, copy),
        "no magnitude passes": edit(edit(src, MAG_PASSES, MAG_PASSES.replace("p < mag_passes", "p < 0")),
                                    TILE_CHUNKS, "  ring.per = ring.n = pow_passes * pow_ks;\n"),
        "no power passes": edit(edit(src, POW_PASSES, POW_PASSES.replace("p < pow_passes", "p < 0")),
                                TILE_CHUNKS, "  ring.per = ring.n = mag_passes * mag_ks;\n"),
        **{f"{k} ring slots": edit(src, MAX_SLOTS, f"constexpr int kMaxSlots = {k};") for k in (2, 3)},
        **{f"registers {m} / {b}": edit(edit(src, REGISTERS[0], f"constexpr int kRegMma = {m};"),
                                        REGISTERS[1], f"constexpr int kRegBand = {b};") for m, b in ((216, 72), (200, 104))},
        "the bands ranked, none sorted": edit(src, SORTED_BAND, "constexpr int kSortedBand = 1;"),
        "the rank loop unrolled by 4": edit(src, RANK_UNROLL, RANK_UNROLL.replace("#pragma unroll 1", "#pragma unroll 4")),
    }


PRIME_STAGE = "constexpr int kPrimeC = 2;"


def prime_variants(src: str) -> dict:
    """Launch C's instance for a prime factor past 11 with fft_stage_prime
    inlined, not called; for the cap's probe, spectral_probe's cap_variants
    (the generic stage for every prime, Bluestein's past LOW_CAP, and
    Bluestein's stage called)."""
    from spectral_probe import cap_variants

    return {"FFT plan, the prime stage inlined": edit(src, PRIME_STAGE, "constexpr int kPrimeC = 1;"),
            **cap_variants(src)}


def wide_variants(src: str) -> dict:
    """The FFT plan with its band stage left out (each (frame, band)'s row
    takes one power value, no band by the block) and with its FFT stages
    left out: the wide-band section's split; with block_tails taking every
    band past each of WIDE_FROM bins (kWideBand), where band_value_sorted gives
    way; with the wide bands' n_fft of radix 7 in the general wide instance
    (of radix 11, the prime and Bluestein's stages); with wide_bands
    inlined; and with the wide instances' launch bounds at one block an SM
    (255 registers a thread, where two blocks cap them at 128)."""
    return {"FFT plan, no band tails": edit(edit(src, FFT_TAILS, "      const float v = pw[f * n_pow + lane];\n"),
                                            WIDE_TAILS, ""),
            "FFT plan, no FFT stages": edit(src, FFT_ROWS_C, ""),
            **{f"FFT plan, block_tails past {n} bins": edit(src, WIDE_BAND, f"constexpr int kWideBand = {n};")
               for n in WIDE_FROM},
            "FFT plan, wide bands in one instance": edit(
                src, WIDE_RADIX7, WIDE_RADIX7.replace("<7, false, 0, true>", "<11, true, kBluesteinC, true>")),
            "FFT plan, wide_bands inlined": edit(src, WIDE_CALL, "__device__ __forceinline__ void wide_bands("),
            "FFT plan, the wide instances bounded for one block an SM": edit(
                src, BOUNDS_C, "__launch_bounds__(kThreadsA, kWide ? 1 : 2) contrast_fft_kernel(")}


def contrast_bound(cfg: FeatureConfig, b: int) -> tuple:
    """The contrast launch's least time for b clips, ms, and what bounds it
    (chip_smoke.py's contrast_work): an FFT of each window at the FP32 peak
    after the window's multiplies, 3 operations an element for the bands'
    power, 6 for the magnitude and centroid, each tail as a selection, 5 a
    value for the z-norm; the waveform read and the rows written once."""
    geo = frontend_kernel._geometry(cfg)
    rows = cfg.n_contrast_bands + 1
    fft = 2 * (2.5 * cfg.n_fft * np.log2(cfg.n_fft) + cfg.n_fft)
    tails = sum(2 * n + top + bot for n, top, bot in zip(geo.widths, geo.tops, geo.bots))
    flops = b * cfg.num_frames * (fft + 3 * geo.n_pow + 6 * geo.n_freqs + tails + 5 * rows)
    nbytes = 4 * b * (cfg.segment_samples + rows * cfg.num_frames)
    t_ops, t_bytes = flops / PEAK_FP32_FLOPS, nbytes / PEAK_HBM_BYTES
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes"


def bounds() -> None:
    """Launch A's and launch C's bounds at B = 1024 on the cap's windows
    (PRIMES, 128 mels, hop n_fft / 4) and on WIDE: arithmetic over the
    config's shapes, on any host."""
    from spectral_probe import spectral_bound

    windows = {f"{p} ms (n_fft {16 * p})": FFT_CONFIGS[16 * p] for p in PRIMES}
    for label, cfg in {**windows, **WIDE}.items():
        base = dataclasses.replace(cfg, use_spectral_contrast=False)
        (a, a_by), (c, c_by) = spectral_bound(base, 1024), contrast_bound(cfg, 1024)
        print(f"bound at B=1024, {label}: launch A {a:.4f} ms by {a_by}, launch C {c:.4f} ms by {c_by}", flush=True)


def build_all(sources: dict) -> dict:
    kernel_build.BUILD_DIR.mkdir(parents=True, exist_ok=True)

    def one(item):
        n, (name, text) = item
        path = kernel_build.BUILD_DIR / f"contrast_probe_{n}.cu"
        path.write_text(text)
        lib = path.with_suffix(".so")
        cmd = [kernel_build._nvcc(), *kernel_build.NVCC_FLAGS, "-o", str(lib), str(path)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode:
            raise SystemExit(f"nvcc failed on {name}:\n{proc.stdout}{proc.stderr}")
        return name, typed(ctypes.CDLL(str(lib)), text)

    with ThreadPoolExecutor(len(sources)) as pool:
        return dict(pool.map(one, enumerate(sources.items())))


def typed(handle: ctypes.CDLL, text: str) -> ctypes.CDLL:
    """The contrast launch's C entry points of a build of `text`, typed."""
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    handle.legacy_gemm = LEGACY_GEMM in text
    handle.cdt_frontend_contrast.argtypes = (
        [p, i, i, i, i, i, i, i, p, i, i, i, p, f, p, i, p, p, p] if handle.legacy_gemm
        else [p, i, i, i, i, i, i, i, i, i, p, i, i, p, f, p, i, p, p, p]
    )
    # A source before the wide bands' instances takes no widest band.
    handle.widest = "int n_bands, int widest," in text
    handle.half_twiddles = HALF_TWIDDLES in text
    handle.cdt_frontend_contrast_fft.argtypes = [p, i, i, i, i, i, p, p, i, i, p, f, p, i,
                                                 *([i] if handle.widest else []), p, p]
    return handle


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument(
        "--baseline", type=Path, action="append", default=[],
        help="another frontend_kernel.cu to time beside this one (repeatable)",
    )
    parser.add_argument("--routes", action="store_true", help="the routes section alone (ROUTES)")
    parser.add_argument("--primes", action="store_true", help="the prime stage's sections alone (see above)")
    parser.add_argument("--wide", action="store_true", help="the wide-band section alone (see above)")
    parser.add_argument("--bluestein", action="store_true", help="the Bluestein split alone (see above)")
    parser.add_argument("--gemm", action="store_true",
                        help="the GEMM plan's split alone, every build with its variants (see above)")
    parser.add_argument("--bounds", action="store_true",
                        help="print the bounds of launches A and C on PRIMES' and WIDE's windows (no card)")
    args = parser.parse_args()
    if args.bounds:
        bounds()
        return
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0], flush=True)

    src = (kernel_build._CSRC / "frontend_kernel.cu").read_text()
    if args.routes:
        routes_section(build_all({"as built": src})["as built"], np.random.default_rng(0), torch.device("cuda"))
        return
    if args.primes:
        baselines = {f"baseline {path}": path.read_text() for path in args.baseline}
        sources = {"as built": src, **prime_variants(src), **baselines}
        libs = build_all(sources)
        from spectral_probe import resource_usage

        for n, name in enumerate(sources):
            resource_usage(f"contrast_probe_{n}", name)
        primes_section(libs, list(baselines), np.random.default_rng(0), torch.device("cuda"))
        return
    if args.gemm:
        baselines = {f"baseline {path}": path.read_text() for path in args.baseline}
        sources, owners = {}, {}
        for owner, text in {**baselines, "as built": src}.items():
            sources[owner] = text
            owners[owner] = [f"{owner}, {v}" for v in gemm_variants(text)]
            sources.update({f"{owner}, {v}": t for v, t in gemm_variants(text).items()})
        libs = build_all(sources)
        for n, name in enumerate(sources):
            gemm_resources(f"contrast_probe_{n}", name)
        gemm_section(libs, owners, np.random.default_rng(0), torch.device("cuda"))
        return
    if args.wide or args.bluestein:
        from spectral_probe import bluestein_variants

        baselines = {f"baseline {path}": path.read_text() for path in args.baseline}
        sources = {"as built": src, **(bluestein_variants(src) if args.bluestein else wide_variants(src)), **baselines}
        libs = build_all(sources)
        from spectral_probe import resource_usage

        for n, name in enumerate(sources):
            resource_usage(f"contrast_probe_{n}", name)
        wide_section(libs, list(baselines), np.random.default_rng(0), torch.device("cuda"),
                     {**BLUESTEIN, **BLUESTEIN_KEEP} if args.bluestein else None)
        return
    sources = variants(src)
    baselines = [f"baseline {path}" for path in args.baseline]
    for name, path in zip(baselines, args.baseline):
        sources[name] = path.read_text()
    libs = build_all(sources)
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    gemm_section(libs, {**{b: [] for b in baselines}, "as built": list(gemm_variants(src))}, rng, dev)
    fft_section(libs, baselines, rng, dev)
    threshold_section(libs["as built"], rng, dev)
    routes_section(libs["as built"], rng, dev)


def fft_launch(lib: ctypes.CDLL, w: torch.Tensor, cfg: FeatureConfig, out: torch.Tensor, tables=None):
    """The contrast launch's FFT plan through the C function of `lib`,
    reading `tables` (numpy) in place of the plan's own where given (a
    source with HALF_TWIDDLES: legacy_tables)."""
    g = frontend_kernel._geometry(cfg)
    windows, tw = frontend_kernel._contrast_fft_constants(cfg, w.device)
    if tables is None and getattr(lib, "half_twiddles", False):
        tables = legacy_tables(cfg.n_fft)
    if tables is not None:
        tw = torch.from_numpy(tables).to(w.device)
    freqs, bands = frontend_kernel._centroid_and_bands(cfg, w.device)
    widest = [max(g.widths, default=0)] if lib.widest else []

    def launch() -> None:
        err = lib.cdt_frontend_contrast_fft(
            w.data_ptr(), w.shape[0], cfg.segment_samples, cfg.num_frames, cfg.n_fft, cfg.hop_length,
            windows.data_ptr(), tw.data_ptr(), g.pow_lo, g.n_pow, freqs.data_ptr(),
            float(cfg.sample_rate / 2.0), bands.data_ptr(), cfg.n_contrast_bands, *widest, out.data_ptr(),
            torch.cuda.current_stream().cuda_stream,
        )
        if err:
            raise RuntimeError(f"launch failed: cudaError {err}")

    return launch


def legacy_table(cfg: FeatureConfig, dev: torch.device) -> tuple:
    """(table, n_passes): the chunk stream of the GEMM plan before its
    power and magnitude passes were split (LEGACY_GEMM): per pass of 256
    columns over [j0, j0 + kpad), kpad / 8 chunks, the bands' power pairs
    then every bin's magnitude pair."""
    from cough_detector_tpu_torch.ops import filters

    g = frontend_kernel._geometry(cfg)
    c4, s4 = filters.dft_matrices(cfg.n_fft, cfg.win_length)
    c5, s5 = filters.dft_matrices(cfg.n_fft, cfg.n_fft)
    n_passes = -(-2 * (g.n_pow + g.n_freqs) // 256)
    taps, bins, p2 = slice(g.j0, g.j1), slice(g.pow_lo, g.pow_lo + g.n_pow), 2 * g.n_pow
    table = np.zeros((g.kpad, n_passes * 256), np.float32)
    table[: g.j1 - g.j0, 0:p2:2] = c4[taps, bins]
    table[: g.j1 - g.j0, 1:p2:2] = s4[taps, bins]
    table[: g.j1 - g.j0, p2 : p2 + 2 * g.n_freqs : 2] = c5[taps]
    table[: g.j1 - g.j0, p2 + 1 : p2 + 2 * g.n_freqs : 2] = s5[taps]
    stream = torch.cat([frontend_kernel._tiles(table[:, q * 256 : (q + 1) * 256]) for q in range(n_passes)])
    return stream.reshape(-1).to(dev), n_passes


def gemm_launch(lib: ctypes.CDLL, w: torch.Tensor, cfg: FeatureConfig, out: torch.Tensor):
    """The GEMM plan through its C function, at LayoutC's level (a scratch
    buffer for the power rows at level 3), with the tables and interface
    of the design the library was built from (typed)."""
    g = frontend_kernel._geometry(cfg)
    k = frontend_kernel._contrast_constants(cfg, w.device)
    level = frontend_kernel._contrast_gemm_plan(cfg)[0]
    scratch = torch.empty((w.shape[0], 128, g.n_pow), device=w.device) if level == 3 else None
    head = (w.data_ptr(), w.shape[0], cfg.segment_samples, cfg.num_frames, cfg.n_fft, cfg.hop_length, g.j0, g.kpad)
    if getattr(lib, "legacy_gemm", False):
        table, n_passes = legacy_table(cfg, w.device)
        geometry = (table.data_ptr(), n_passes, g.n_pow, g.n_freqs)
    else:
        table = k.table
        geometry = (g.pow_k0, g.pow_ks, table.data_ptr(), g.n_pow, g.n_freqs)
    tail = (k.freqs.data_ptr(), float(cfg.sample_rate / 2.0), k.bands.data_ptr(), cfg.n_contrast_bands,
            None if scratch is None else scratch.data_ptr(), out.data_ptr())
    keep = (table, scratch)

    def launch() -> None:
        assert keep  # the closure holds the buffers its pointers read
        err = lib.cdt_frontend_contrast(*head, *geometry, *tail, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"launch failed: cudaError {err}")

    return launch


def gemm_resources(build_name: str, label: str) -> None:
    """contrast_kernel's instances' registers and stack frame (where
    spills go) in build `build_name`, from cuobjdump."""
    cuobjdump = Path(kernel_build._nvcc()).with_name("cuobjdump")
    out = subprocess.run([str(cuobjdump), "--dump-resource-usage", str(kernel_build.BUILD_DIR / f"{build_name}.so")],
                         check=True, capture_output=True, text=True).stdout.splitlines()
    for i, line in enumerate(out):
        if "Function" in line and "contrast_kernel" in line:
            symbol = line.split("Function", 1)[1].strip(" :")
            print(f"contrast_kernel ({symbol}) {label}: {' '.join(out[i + 1].split()[:3])} (cuobjdump "
                  f"--dump-resource-usage)", flush=True)


def gemm_section(libs: dict, owners: dict, rng: np.random.Generator, dev: torch.device) -> None:
    """The GEMM plan on the shipped config with contrast at each B of
    GEMM_ITERS: the builds of `owners` (name -> its variants' names), in
    turns (each owner, its variants, the owner again), then each owner
    once more in reverse. Each owner's rows (not the variants') held to the
    plain version (1e-3). Prints each run, then each owner's time range and
    each variant's saving (the owner's slower run less the variant's)."""
    cfg = FeatureConfig(use_spectral_contrast=True)
    for b, iters in GEMM_ITERS.items():
        w = torch.from_numpy((rng.standard_normal((b, cfg.segment_samples)) * 0.3).astype(np.float32)).to(dev)
        want = frontend_kernel.spectral_contrast_reference(w, cfg)
        out = torch.empty(want.shape, device=dev)  # contiguous: the kernel's layout
        order = [n for owner, vs in owners.items() for n in (owner, *vs, owner)] + list(owners)[::-1]
        times = {}
        for name in order:
            launch = gemm_launch(libs[name], w, cfg, out)
            t = cuda_ms(launch, iters)
            err = ((out - want).abs().max() / want.abs().max()).item()
            if name in owners and err > 1e-3:
                raise SystemExit(f"the contrast launch's {name} disagrees with plain at B={b}: {err:.2e}")
            times.setdefault(name, []).append(t)
            print(f"contrast launch B={b}, shipped + contrast, {name}: {t:.4f} ms, max-relative vs plain {err:.2e}",
                  flush=True)
        for owner, vs in owners.items():
            own = times[owner]
            print(f"contrast launch B={b}, shipped + contrast: {owner} {min(own):.4f}-{max(own):.4f} ms; savings "
                  "(ms, its slower run less the variant's): "
                  + ", ".join(f"{v.removeprefix(owner + ', ')} {max(own) - max(times[v]):.4f}" for v in vs),
                  flush=True)


def threshold_section(lib: ctypes.CDLL, rng: np.random.Generator, dev: torch.device,
                      sizes: tuple = (640, 672, 675, 693, 704, 768, 784, 1000, 1024)) -> None:
    """Both plans around the FFT plan's threshold, in turns, each checked
    against the plain version."""
    for n_fft in sizes:
        cfg = FFT_CONFIGS[n_fft]
        for b, iters in ITERS.items():
            w = torch.from_numpy((rng.standard_normal((64, cfg.segment_samples)) * 0.3).astype(np.float32)).to(dev)
            w = w.repeat(b // 64, 1)
            out = torch.empty((b, cfg.n_contrast_bands + 1, cfg.num_frames), device=dev)
            want = frontend_kernel.spectral_contrast_reference(w, cfg)
            plans = {"GEMM plan": gemm_launch(lib, w, cfg, out), "FFT plan": fft_launch(lib, w, cfg, out)}
            times = {"GEMM plan": [], "FFT plan": []}
            for name in ("GEMM plan", "FFT plan", "FFT plan", "GEMM plan"):
                plans[name]()
                torch.cuda.synchronize()
                err = ((out - want).abs().max() / want.abs().max()).item()
                if err > 1e-3:
                    raise SystemExit(f"the contrast launch's {name} disagrees with plain at n_fft {n_fft}: {err:.2e}")
                start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                start.record()
                for _ in range(iters):
                    plans[name]()
                end.record()
                torch.cuda.synchronize()
                times[name].append(start.elapsed_time(end) / iters)
            print(
                f"contrast launch B={b}, n_fft {n_fft} + contrast (plan {frontend_kernel.contrast_level(cfg)}, GEMM "
                f"level {frontend_kernel._contrast_gemm_plan(cfg)[0]}), through each plan's C function in turns: "
                + ", ".join(f"{n} {[round(t, 4) for t in v]} ms" for n, v in times.items()),
                flush=True,
            )


def cuda_ms(fn, iters: int) -> float:
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def routes_section(lib: ctypes.CDLL, rng: np.random.Generator, dev: torch.device) -> None:
    """Each ROUTES config's launch as its plan takes it, checked against the
    plain version, and the fft rows, in turns (launch, fft rows, fft rows,
    launch), at B = 1024."""
    for label, cfg in ROUTES.items():
        w = torch.from_numpy((rng.standard_normal((64, cfg.segment_samples)) * 0.3).astype(np.float32)).to(dev)
        w = w.repeat(16, 1)
        out = torch.empty((1024, cfg.n_contrast_bands + 1, cfg.num_frames), device=dev)
        level = frontend_kernel.contrast_level(cfg)
        fft = level == frontend_kernel.CONTRAST_FFT
        launch = (fft_launch if fft else gemm_launch)(lib, w, cfg, out)
        launch()
        torch.cuda.synchronize()
        want = frontend_kernel.spectral_contrast_reference(w, cfg)
        err = ((out - want).abs().max() / want.abs().max()).item()
        if err > 1e-3:
            raise SystemExit(f"the contrast launch disagrees with its plain version on {label}: {err:.2e}")
        runs = {"launch": launch, "fft rows": lambda: frontend.spectral_contrast(w, cfg, method="fft")}
        times = {"launch": [], "fft rows": []}
        for name in ("launch", "fft rows", "fft rows", "launch"):
            times[name].append(cuda_ms(runs[name], 5))
        plan = f"FFT, stages {frontend_kernel._fft_radices(cfg.n_fft)}" if fft else f"GEMM level {level}"
        print(
            f"contrast launch B=1024, {label} + contrast ({cfg.num_frames} frames; plan {plan}), in turns: "
            + ", ".join(f"{n} {[round(t, 4) for t in v]} ms" for n, v in times.items())
            + f"; max-relative vs plain {err:.2e}",
            flush=True,
        )


def fft_section(libs: dict, baselines: list, rng: np.random.Generator, dev: torch.device) -> None:
    """The FFT plan as built and its variants, in turns, at B = 1024,
    between the baselines' (through the same C function; only where a
    baseline takes the n_fft)."""
    parts = [v for v in libs if v.startswith("FFT plan") and v not in (ONE_INSTANCE, TWIDDLE_NEGATED)]
    for n_fft in (2048, 4096, 2000, 3000, 1792, 2744, 1760, 2662, "44.1 kHz, 1764", "44.1 kHz, 1323", "44.1 kHz, 2205"):
        cfg = FFT_CONFIGS[n_fft]
        variants = (parts if n_fft in (2048, 4096, 2000) else []) + [ONE_INSTANCE, TWIDDLE_NEGATED]
        g = frontend_kernel._geometry(cfg)
        w = torch.from_numpy((rng.standard_normal((64, cfg.segment_samples)) * 0.3).astype(np.float32)).to(dev)
        w = w.repeat(16, 1)
        out = torch.empty((1024, cfg.n_contrast_bands + 1, cfg.num_frames), device=dev)
        want = frontend_kernel.spectral_contrast_reference(w, cfg)
        for name in baselines + ["as built"] + variants + ["as built"] + baselines:
            launch = fft_launch(libs[name], w, cfg, out)
            try:
                launch()
            except RuntimeError:
                if name in baselines:  # a source before this n_fft's stages
                    continue
                raise
            for _ in range(2):
                launch()
            torch.cuda.synchronize()
            err = ((out - want).abs().max() / want.abs().max()).item()
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(10):
                launch()
            end.record()
            torch.cuda.synchronize()
            print(
                f"contrast launch B=1024, n_fft {n_fft} + contrast (stages {frontend_kernel._fft_radices(cfg.n_fft)}, "
                f"widest band {max(g.widths)} bins), "
                f"{'FFT plan as built' if name == 'as built' else name}: {start.elapsed_time(end) / 10:.4f} ms, "
                f"max-relative vs plain {err:.2e}",
                flush=True,
            )


def wide_section(libs: dict, baselines: list, rng: np.random.Generator, dev: torch.device,
                 configs: dict | None = None) -> None:
    """The FFT plan on `configs` (by default WIDE and WIDE_KEEP) as built,
    its variants and the baselines in turns, then the fft rows, beside the
    bound, at B = 1024. Each build's rows but the variants' are held to the
    plain version (1e-3): those that move kWideBand too."""
    variants = [v for v in libs if v != "as built" and v not in baselines]

    def one(label: str, cfg: FeatureConfig, names: list) -> dict:
        geo = frontend_kernel._geometry(cfg)
        w = torch.from_numpy((rng.standard_normal((64, cfg.segment_samples)) * 0.3).astype(np.float32)).to(dev)
        w = w.repeat(16, 1)
        out = torch.empty((1024, cfg.n_contrast_bands + 1, cfg.num_frames), device=dev)
        want = frontend_kernel.spectral_contrast_reference(w, cfg)
        group = frontend_kernel._fft_layout(cfg.n_fft, cfg.n_fft, cfg.hop_length, geo.n_pow, contrast=True)[0]
        times = {}
        for name in names:
            launch = fft_launch(libs[name], w, cfg, out)
            try:
                launch()
            except RuntimeError:
                if name in baselines:  # a source before this n_fft's stages
                    continue
                raise
            t = cuda_ms(launch, 10)
            err = ((out - want).abs().max() / want.abs().max()).item()
            if err > 1e-3 and ("block_tails" in name or name in BLUESTEIN_LAYOUTS or name not in variants):
                raise SystemExit(f"the contrast launch's {name} disagrees with plain on {label}: {err:.2e}")
            times.setdefault(name, []).append(t)
            print(f"contrast launch B=1024, {label} + contrast ({cfg.n_contrast_bands} bands, widest "
                  f"{max(geo.widths)} bins, {cfg.num_frames} frames, {group} a group), "
                  f"{'FFT plan as built' if name == 'as built' else name}: {t:.4f} ms, max-relative vs plain {err:.2e}",
                  flush=True)
        return times

    if configs is None:
        keep = {f"n_fft {n} (an older plan)": FFT_CONFIGS[n] if n in FFT_CONFIGS else ROUTES_BY_NFFT[n]
                for n in WIDE_KEEP}
        configs = {**WIDE, **keep}
    for label, cfg in configs.items():
        assert frontend_kernel.contrast_level(cfg) == frontend_kernel.CONTRAST_FFT, label
        times = one(label, cfg, baselines + ["as built"] + variants + ["as built"] + baselines)
        w = torch.from_numpy((rng.standard_normal((64, cfg.segment_samples)) * 0.3).astype(np.float32)).to(dev)
        w = w.repeat(16, 1)
        rows = [cuda_ms(lambda: frontend.spectral_contrast(w, cfg, method="fft"), 5) for _ in range(2)]
        bound, by = contrast_bound(cfg, 1024)
        built = times["as built"]
        split = ", ".join(f"{v.removeprefix('FFT plan, ')} {max(built) - max(times[v]):.4f}"
                          for v in variants if v in times)
        print(f"contrast launch B=1024, {label}: FFT plan as built {min(built):.4f}-{max(built):.4f} ms, "
              + "".join(f"{b} {min(times[b]):.4f}-{max(times[b]):.4f} ms, " for b in baselines if b in times)
              + f"fft rows {min(rows):.4f}-{max(rows):.4f} ms, bound {bound:.4f} ms by {by}; the variants' "
              f"savings (ms, the slower as built less the slower variant): {split}", flush=True)


def primes_section(libs: dict, baselines: list, rng: np.random.Generator, dev: torch.device) -> None:
    """n_fft 2048, 2000, 1792, 2662 and 44.1 kHz at 1323 as built between
    the baselines; the cap's probe on PRIMES; both plans near kFftMinNfft
    on a factor of 13; the routes."""
    lib = libs["as built"]
    variants = ["FFT plan, the prime stage inlined"]
    for n_fft in (2048, 2000, 1792, 2662, "44.1 kHz, 1323", 1760, 1664, 2704, 650):
        cfg = FFT_CONFIGS[n_fft] if n_fft in FFT_CONFIGS else ROUTES_BY_NFFT[n_fft]
        w = torch.from_numpy((rng.standard_normal((64, cfg.segment_samples)) * 0.3).astype(np.float32)).to(dev)
        w = w.repeat(16, 1)
        out = torch.empty((1024, cfg.n_contrast_bands + 1, cfg.num_frames), device=dev)
        want = frontend_kernel.spectral_contrast_reference(w, cfg)
        for name in baselines + ["as built"] + variants + ["as built"] + baselines:
            launch = fft_launch(libs[name], w, cfg, out)
            try:
                launch()
            except RuntimeError:
                if name in baselines:  # a source before this n_fft's stages
                    continue
                raise
            t = cuda_ms(launch, 10)
            err = ((out - want).abs().max() / want.abs().max()).item()
            print(f"contrast launch B=1024, n_fft {n_fft} + contrast (stages {frontend_kernel._fft_radices(cfg.n_fft)}), "
                  f"{'FFT plan as built' if name == 'as built' else name}: {t:.4f} ms, max-relative vs plain {err:.2e}",
                  flush=True)

    from spectral_probe import BLUESTEIN_CALLED, GENERIC, LOW, cap_times, variant_tables

    wins = []
    for p in PRIMES:
        cfg = FFT_CONFIGS[16 * p]
        w = torch.from_numpy((rng.standard_normal((64, cfg.segment_samples)) * 0.3).astype(np.float32)).to(dev)
        w = w.repeat(16, 1)
        out = torch.empty((1024, cfg.n_contrast_bands + 1, cfg.num_frames), device=dev)
        want = frontend_kernel.spectral_contrast_reference(w, cfg)
        runs = {"GEMM plan": gemm_launch(lib, w, cfg, out), "FFT plan": fft_launch(lib, w, cfg, out),
                "fft rows": lambda: frontend.spectral_contrast(w, cfg, method="fft")}
        variants = {n: fft_launch(libs[n], w, cfg, out, variant_tables(cfg.n_fft, n))
                    for n in (GENERIC, LOW, BLUESTEIN_CALLED)}
        for name, run in {**runs, **variants}.items():
            if name == "fft rows":
                continue
            run()
            torch.cuda.synchronize()
            err = ((out - want).abs().max() / want.abs().max()).item()
            if err > 1e-3:
                raise SystemExit(f"the contrast launch's {name} disagrees with plain at n_fft {cfg.n_fft}: {err:.2e}")

        def order_in_turns(r):
            times = {name: [] for name in r}
            for name in tuple(r) + tuple(r)[::-1]:
                times[name].append(cuda_ms(r[name], 5))
            return times

        times, generic, bluestein = cap_times(runs, variants, p, order_in_turns)
        fft = max(times["FFT plan"])
        beats = (fft < min(times["GEMM plan"]), fft < min(times["fft rows"]),
                 generic < min(times["GEMM plan"]) and generic < min(times["fft rows"]),
                 bluestein is not None and bluestein < generic)
        wins.append(beats)
        stage = "Bluestein's stage" if p > frontend_kernel._FFT_MAX_PRIME else "the generic prime stage"
        print(f"contrast launch B=1024, a window of {p} ms at 16 kHz: n_fft {cfg.n_fft} + contrast, hop "
              f"{cfg.hop_length} (GEMM level {frontend_kernel._contrast_gemm_plan(cfg)[0]}; prime factors "
              f"{frontend_kernel._prime_factors(cfg.n_fft)}; the FFT plan as built runs {stage}), in turns: "
              + ", ".join(f"{n} {[round(t, 4) for t in v]} ms" for n, v in times.items())
              + f"; the FFT plan beats the GEMM: {beats[0]}, the fft rows: {beats[1]}"
              + (f"; Bluestein's stage beats the generic one: {beats[3]}" if bluestein is not None else ""), flush=True)
    generic = [p for p, b in zip(PRIMES, wins) if b[2]]
    bluestein = [p for p, b in zip(PRIMES, wins) if b[3]]
    lost = [(p, "GEMM" if not gemm else "fft rows") for p, (gemm, library, _, _) in zip(PRIMES, wins)
            if (16 * p >= frontend_kernel._FFT_MIN_NFFT and not gemm) or not library]
    print(f"launch C's cap: the largest probed prime at which the generic prime stage's FFT plan beats the GEMM and "
          f"the fft rows: {max(generic, default=None)}; the probed primes at which Bluestein's stage beats it: "
          f"{bluestein}; from n_fft {frontend_kernel._FFT_MIN_NFFT} the FFT plan as built loses to (prime, call): "
          f"{lost}", flush=True)
    threshold_section(lib, rng, dev, (650, 676, 715))
    routes_section(lib, rng, dev)


if __name__ == "__main__":
    main()
