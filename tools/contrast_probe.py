"""Where the contrast launch's time goes, on one NVIDIA card.

    python3 tools/contrast_probe.py [--baseline PATH ...] [--routes | --primes | --wide | --bluestein]

Times launch C of the front-end kernel (csrc/frontend_kernel.cu:
contrast_kernel, the launcher's spectral-contrast rows) with CUDA events
at B = 1024 and 4096 on the shipped config with contrast, as built and in
variants, each a string edit of the source built with the same nvcc flags
into build/kernels/ (all builds run at once):
  - 4 bins a lane: every band ranked with four bins a lane, as the
    launch's first design did (the same rows);
  - no band tails: the band stage left out (its inputs still taken by an
    empty asm), so the rows are wrong and the time is what the rest costs;
  - one DFT pass: the tile's DFT stops after its first pass of 256
    columns (the shipped config's clips are one row tile, so the ring is
    never restarted), which measures a pass's share.
Each --baseline is another copy of the source (the same C interface for
launch C and its FFT plan) timed in turns with this one: the baselines,
as built, the variants, as built, the baselines.

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
  - ranked tails: the bands' tails by stable rank (band_value, the GEMM
    plan's) instead of the sort in registers;
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

BANDS = (
    "  if (w > 96) return band_contrast<4>(pb, w, nt, nb, lane);\n"
    "  if (w > 64) return band_contrast<3>(pb, w, nt, nb, lane);\n"
    "  if (w > 32) return band_contrast<2>(pb, w, nt, nb, lane);\n"
    "  if (w > 1) return band_contrast<1>(pb, w, nt, nb, lane);\n"
)
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
    one_pass = edit(src, "ring.n = n_passes * n_ksteps;", "ring.n = n_ksteps;")
    return {
        "as built": src,
        "4 bins a lane": edit(src, BANDS, "  if (w > 1) return band_contrast<4>(pb, w, nt, nb, lane);\n"),
        "no band tails": edit(src, GEMM_TAILS, "        const float v = pw[r * n_pow + lane];\n"),
        "one DFT pass": edit(one_pass, "for (int p = 0; p < n_passes; ++p) {", "for (int p = 0; p < 1; ++p) {"),
        "FFT plan, ranked tails": edit(src, FFT_TAILS, FFT_TAILS.replace("band_value_sorted", "band_value")),
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
    band past each of WIDE_FROM bins (kWideBand), where band_sorted gives
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
    handle.cdt_frontend_contrast.argtypes = [
        p, i, i, i, i, i, i, i, p, i, i, i, p, f, p, i, p, p, p,
    ]
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
    cfg = FeatureConfig(use_spectral_contrast=True)
    g = frontend_kernel._geometry(cfg)
    k = frontend_kernel._contrast_constants(cfg, dev)
    n = cfg.n_contrast_bands
    rng = np.random.default_rng(0)
    gemm = [v for v in libs if v not in baselines and v != "as built" and not v.startswith("FFT plan")]
    order = baselines + ["as built"] + gemm + ["as built"] + baselines
    for b, iters in ITERS.items():
        w = torch.from_numpy((rng.standard_normal((b, cfg.segment_samples)) * 0.3).astype(np.float32)).to(dev)
        out = torch.empty((b, n + 1, cfg.num_frames), device=dev)
        want = frontend_kernel.spectral_contrast_reference(w, cfg)
        for name in order:
            lib = libs[name]

            def launch() -> None:
                err = lib.cdt_frontend_contrast(
                    w.data_ptr(), b, cfg.segment_samples, cfg.num_frames, cfg.n_fft, cfg.hop_length,
                    g.j0, g.kpad, k.table.data_ptr(), g.n_passes, g.n_pow, g.n_freqs, k.freqs.data_ptr(),
                    float(cfg.sample_rate / 2.0), k.bands.data_ptr(), n, None, out.data_ptr(),
                    torch.cuda.current_stream().cuda_stream,
                )
                if err:
                    raise RuntimeError(f"launch failed: cudaError {err}")

            for _ in range(3):
                launch()
            torch.cuda.synchronize()
            err = ((out - want).abs().max() / want.abs().max()).item()
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(iters):
                launch()
            end.record()
            torch.cuda.synchronize()
            print(
                f"contrast launch B={b}, shipped + contrast, {name}: {start.elapsed_time(end) / iters:.4f} ms, "
                f"max-relative vs plain {err:.2e}",
                flush=True,
            )
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


def gemm_launch(lib: ctypes.CDLL, w: torch.Tensor, cfg: FeatureConfig, out: torch.Tensor):
    """The GEMM plan through its C function, at LayoutC's level (a scratch
    buffer for the power rows at level 3)."""
    g = frontend_kernel._geometry(cfg)
    k = frontend_kernel._contrast_constants(cfg, w.device)
    level = frontend_kernel._contrast_gemm_plan(cfg)[0]
    scratch = torch.empty((w.shape[0], 128, g.n_pow), device=w.device) if level == 3 else None

    def launch() -> None:
        err = lib.cdt_frontend_contrast(
            w.data_ptr(), w.shape[0], cfg.segment_samples, cfg.num_frames, cfg.n_fft, cfg.hop_length,
            g.j0, g.kpad, k.table.data_ptr(), g.n_passes, g.n_pow, g.n_freqs, k.freqs.data_ptr(),
            float(cfg.sample_rate / 2.0), k.bands.data_ptr(), cfg.n_contrast_bands,
            None if scratch is None else scratch.data_ptr(), out.data_ptr(), torch.cuda.current_stream().cuda_stream,
        )
        if err:
            raise RuntimeError(f"launch failed: cudaError {err}")

    return launch


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
