"""Where the spectral launch's time goes, on one NVIDIA card.

    python3 tools/spectral_probe.py [--baseline PATH ...] [--routes | --primes | --bluestein | --turns]

Times launch A of the front-end kernel (csrc/frontend_kernel.cu) with CUDA
events at B = 4096 on the shipped config, as built and in variants, each a
string edit of the source built with the same nvcc flags into
build/kernels/. The variants compute wrong numbers and are timed only:
  - one wgmma term (hi * hi) instead of three: what the DFT's tensor-core
    work costs;
  - no table copies (the ring's slots keep stale data): what streaming the
    DFT table from L2 costs;
  - no waveform staging;
  - the DFT cut to one pair of k-steps (kpad = 16): staging, mel and fixed
    costs;
  - no mel MMAs (the power is still formed and split, so that the DFT's
    products stay in use: a variant whose accumulators nobody reads lets
    the compiler drop the wgmma that writes them).
Then microbenchmarks of the two MMA instructions alone, one block of 8
warps on each SM, operands from registers and shared memory that never
change, the three-term pattern: wgmma m64n256k8 .tf32 (the DFT's, two
warpgroups, one group in flight) and mma.sync m16n8k8 .tf32 (the mel's,
each warp a 4 x 8 tile). Their rates are the ceilings of the kernel's
MMAs.

The FFT plans' kernels' registers and stack frame, each instance, as
built and in each baseline (cuobjdump). Then launch A's FFT plan
(spectral_fft_kernel) at B = 1024 on n_fft 2048 and 2000 (hop n_fft / 4,
128 mels, f_max 8 kHz; the frames of 64 clips repeated; 2048 runs radix-2
and radix-4 stages, 2000 radix 2, 4 and 5), as built and in variants that
split its time: no waveform staging, no FFT stages, no power and mel (the
post-twiddle, the power and the mel left out; a frame's first point
written instead); and, there and on n_fft 3000, 768 at 256 mels, 896 at
256 mels, 1792, 2744 and 44.1 kHz at 1764 and 882 (a 10 ms hop; radix-7
stages), 880 at 256 mels (radix 11), 44.1 kHz at the odd 1323 and the odd
1125 (two frames a row of n_fft points), as built and with the twiddle
rule before an odd n_fft on an even one (past n_fft / 2 the negated entry
of k - n_fft / 2, not the conjugate of entry n_fft - k). Each --baseline
is another copy of the
source (the same C interface for the FFT plan) timed in turns with this
one on those configs: the baselines, as built, the variants, as built,
the baselines (a baseline that refuses an n_fft is left out there). Then
where the FFT plan's threshold (kFftMinNfft) lies: both plans at 128
mels, hop n_fft / 4, on n_fft 640, 672, 675 (odd), 693 (odd, a factor of
11), 704 (a factor of 11), 768, 784, 1000 and 1024, at B = 1024 and 4096.
And
the FFT plan on the shipped config at B = 4096 beside its GEMM plan: for
the record, since the shipped config keeps the GEMM (spectral_plan). Both
plans are called through their C functions directly, in turns. Then the
routes of ROUTES, configs users set whose plan is timed once beside its
library call: the launch as its plan takes it (spectral_plan), through its
C function, and `torch.stft` + a mel matmul, in turns, at B = 1024.
`--routes` builds the source as built alone and runs that section only.
`--primes` builds the source as built, with fft_stage_prime called
(PRIME_CALLED), and the baselines, and runs, after their cuobjdump lines:
launch A's FFT plan on PRIME_KEEP (n_fft 2048, 2000, 1792, 2662, the odd
1323, 832 at 256 mels and the odd 1365 at 44.1 kHz) in turns with the
baselines; where the generic prime stage gives way to Bluestein's
(kFftMaxPrime): at B = 1024 on the 16 kHz window of p ms for p in PRIMES
(n_fft 16 p, hop n_fft / 4, 128 mels, 13 to 409), the GEMM plan, the FFT
plan, the other prime stage (past the cap the generic one, from LOW_CAP
to it Bluestein's: variants of kFftMaxPrime, each with its tables),
Bluestein's stage called (a __noinline__ wrapper) past the cap, and `torch.stft` +
mel, in turns; the largest p at which the generic stage's plan beats the
GEMM and the library, the p at which Bluestein's beats the generic one,
and the primes at which the plan as built loses to either from
kFftMinNfft on (under it the GEMM keeps 128 mels whatever the cap); both
plans near kFftMinNfft on n_fft
with a factor of 13 (650, 676 and the odd 715) at B = 1024 and 4096; and
the routes section. `--bluestein` builds the source as built, its
Bluestein variants (bluestein_variants: Bluestein's stage left out, its
warp FFTs left out so that only its gather and scatter run, the radix
stages before it left out) and the baselines, prints their cuobjdump
lines, and splits launch A's Bluestein plans (BLUESTEIN_CONFIGS: n_fft
2192 to 6544 at 128 mels, 2192 and 1048 at 256 mels, the odd 1965 at 44.1
kHz) at B = 1024 in turns (the baselines, as built, the variants, as
built, the baselines), then `torch.stft` + mel and the bound beside them.
`--turns` builds the source as built and the baselines and prints, for
every kernel of the library, whether its SASS (cuobjdump -sass, addresses,
constants and the build's names masked) equals each baseline's and the
instruction counts; then at B = 1024, in turns with the baselines (the
baselines, as built, as built, the baselines, twice), launch A on the plans
with no Bluestein prime (BLUESTEIN_KEEP and the shipped config's GEMM
plan) and on TURNS_A, and launch C on contrast_probe.py's BLUESTEIN_KEEP
and on TURNS_C, each beside its library call (`torch.stft` + mel; the fft
rows) and its bound, each build's output held to the plain version.
All builds run at once. Prints the card's name and power limit first.
Needs a CUDA card and nvcc; imports no JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import difflib
import re
import subprocess
import sys
import time
from collections import Counter
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from cough_detector_tpu_torch.config import FeatureConfig  # noqa: E402
from cough_detector_tpu_torch.ops import frontend_kernel  # noqa: E402
from cough_detector_tpu_torch.utils import kernel_build  # noqa: E402

BATCH = 4096
ITERS = 10

MMA_BENCH = r"""
#include <cuda_runtime.h>
#include <stdint.h>
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ uint32_t val(uint32_t x) {  // a TF32 value in [0.5, 1) with random mantissa
  x ^= x << 13; x ^= x >> 17; x ^= x << 5;
  return (x & 0x007FE000u) | 0x3F000000u;
}
__global__ void __launch_bounds__(256, 1) bench(float* out, int iters) {
  float acc[4][8][4] = {};
  uint32_t a[4][4], b[8][2];
  for (int i = 0; i < 4; ++i)
    for (int x = 0; x < 4; ++x) a[i][x] = val(threadIdx.x * 17 + i * 4 + x + 1);
  for (int j = 0; j < 8; ++j)
    for (int x = 0; x < 2; ++x) b[j][x] = val(threadIdx.x * 29 + j * 2 + x + 7);
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int term = 0; term < 3; ++term)
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) mma(acc[i][j], a[i], b[j][term & 1], b[j][(term + 1) & 1]);
    a[it & 3][it & 3] ^= 0x2000u;
  }
  float s = 0;
  for (int i = 0; i < 4; ++i)
    for (int j = 0; j < 8; ++j) s += acc[i][j][0] + acc[i][j][1] + acc[i][j][2] + acc[i][j][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
__global__ void __launch_bounds__(256, 1) bench_wgmma(float* out, int iters) {
  __shared__ __align__(128) float bs[2 * 2048];
  for (int i = threadIdx.x; i < 4096; i += 256) bs[i] = __uint_as_float(val(i + 3));
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
  const uint64_t base = (uint32_t)__cvta_generic_to_shared(bs);
  const uint64_t d_hi = ((base & 0x3FFFF) >> 4) | (8ull << 16) | (16ull << 32);
  const uint64_t d_lo = d_hi + (8192 >> 4);
  float d[128] = {};
  uint32_t hi[4], lo[4];
  for (int x = 0; x < 4; ++x) { hi[x] = val(threadIdx.x * 5 + x); lo[x] = val(threadIdx.x * 7 + x); }
  for (int it = 0; it < iters; ++it) {
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
    WGMMA(lo, d_hi) WGMMA(hi, d_lo) WGMMA(hi, d_hi)
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
  }
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
  float s = 0;
  for (int i = 0; i < 128; ++i) s += d[i];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
extern "C" int run_wgmma(int blocks, int iters, float* ms) {
  float* out;
  cudaMalloc(&out, blocks * 256 * sizeof(float));
  cudaEvent_t s, e;
  cudaEventCreate(&s);
  cudaEventCreate(&e);
  bench_wgmma<<<blocks, 256>>>(out, iters);
  cudaEventRecord(s);
  bench_wgmma<<<blocks, 256>>>(out, iters);
  cudaEventRecord(e);
  cudaEventSynchronize(e);
  cudaEventElapsedTime(ms, s, e);
  cudaFree(out);
  return (int)cudaGetLastError();
}
extern "C" int run(int blocks, int iters, float* ms) {
  float* out;
  cudaMalloc(&out, blocks * 256 * sizeof(float));
  cudaEvent_t s, e;
  cudaEventCreate(&s);
  cudaEventCreate(&e);
  bench<<<blocks, 256>>>(out, iters);
  cudaEventRecord(s);
  bench<<<blocks, 256>>>(out, iters);
  cudaEventRecord(e);
  cudaEventSynchronize(e);
  cudaEventElapsedTime(ms, s, e);
  cudaFree(out);
  return (int)cudaGetLastError();
}
"""


def wgmma_macro() -> str:
    """WGMMA(a, desc): d (128 floats) += a (4 TF32 registers) * the tile at desc."""
    outs = ", ".join(f'"+f"(d[{i}])' for i in range(128))
    regs = ", ".join(f"%{i}" for i in range(128))
    return (
        "#define WGMMA(a, desc) asm volatile(\"wgmma.mma_async.sync.aligned.m64n256k8.f32.tf32.tf32 "
        f"{{{regs}}}, {{%128, %129, %130, %131}}, %132, 1, 1, 1;\\n\" : {outs} : "
        '"r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc) : "memory");\n'
    )


# A source whose Bluestein tables end in the m-point half table (before
# the FFT_m stages' own twiddles): it reads the tables of legacy_tables.
HALF_TWIDDLES = "bp + bm + bm / 2 + 1"


def legacy_tables(n_fft: int) -> np.ndarray:
    """The FFT plans' tables as a source with HALF_TWIDDLES reads them: the
    n_fft twiddles, the chirp, B^ and the m-point twiddles for k in [0, m /
    2]."""
    p = frontend_kernel._bluestein_prime(n_fft)
    if not p:
        return frontend_kernel._fft_tables(n_fft)
    m = frontend_kernel._bluestein_points(p)
    return np.concatenate([frontend_kernel._twiddles(n_fft), frontend_kernel._bluestein_tables(p)[: p + m],
                           frontend_kernel._twiddles(m)])


def build(name: str, source: str) -> ctypes.CDLL:
    path = kernel_build.BUILD_DIR / f"{name}.cu"
    kernel_build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    path.write_text(source)
    lib = path.with_suffix(".so")
    cmd = [kernel_build._nvcc(), *kernel_build.NVCC_FLAGS, "-o", str(lib), str(path)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode:
        raise SystemExit(f"nvcc failed on {name}:\n{proc.stdout}{proc.stderr}")
    handle = ctypes.CDLL(str(lib))
    handle.half_twiddles = HALF_TWIDDLES in source
    return handle


PEAK_FP32_FLOPS = 67e12  # chip_smoke.py's peaks: FP32 on the CUDA cores, HBM
PEAK_HBM_BYTES = 3.35e12


def spectral_bound(cfg: FeatureConfig, b: int) -> tuple:
    """Launch A's least time for b clips, ms, and what bounds it
    (chip_smoke.py's spectral_work): a real FFT of n_fft points a frame (2.5
    n log2 n at the FP32 peak), the window's multiplies over its nonzero
    taps, the power of the bins a mel band reads (3 a bin) and the mel over
    the filterbank's nonzero entries (a multiply-add each); the waveform
    read and the power mel written once."""
    from cough_detector_tpu_torch.ops import filters

    k = frontend_kernel._constants(cfg, torch.device("cpu"))
    nnz = int(torch.count_nonzero(k.fb))
    taps = int(np.count_nonzero(filters.padded_window(cfg.win_length, cfg.n_fft)))
    frame = 2.5 * cfg.n_fft * np.log2(cfg.n_fft) + taps + 3 * k.n_used + 2 * nnz
    t_ops = b * cfg.num_frames * frame / PEAK_FP32_FLOPS
    t_bytes = 4 * b * (cfg.segment_samples + cfg.n_mels * cfg.num_frames) / PEAK_HBM_BYTES
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes"


def resource_usage(name: str, label: str) -> None:
    """Print the FFT plans' kernels' registers and stack frame (where
    spills go), each instance, in build `name`, from cuobjdump beside
    nvcc."""
    cuobjdump = Path(kernel_build._nvcc()).with_name("cuobjdump")
    out = subprocess.run([str(cuobjdump), "--dump-resource-usage", str(kernel_build.BUILD_DIR / f"{name}.so")],
                         check=True, capture_output=True, text=True).stdout.splitlines()
    for i, line in enumerate(out):
        for kernel in ("spectral_fft_kernel", "contrast_fft_kernel"):
            if "Function" in line and kernel in line:
                symbol = line.split("Function", 1)[1].strip(" :")
                print(f"{kernel} ({symbol}) {label}: {' '.join(out[i + 1].split()[:3])} (cuobjdump "
                      f"--dump-resource-usage; __launch_bounds__(256, 2) caps a thread at 128 registers)", flush=True)


def edit(src: str, old: str, new: str) -> str:
    if old not in src:
        raise SystemExit(f"the source no longer holds the text this variant edits: {old[:60]!r}")
    return src.replace(old, new)


def fft_variants(src: str) -> dict:
    """Launch A's FFT plan as built and with a part of it left out."""
    start = src.index("  // 4. The real FFT's bins [0, n_used)")
    end_text = "    mel_out[((size_t)b * n_mels + mel) * n_frames + t0 + f] = acc;\n  }\n"
    stop = src.index(end_text, start) + len(end_text)
    return {
        "FFT plan as built": src,
        "FFT plan, no staging": edit(src, "stage_flat(span, src, (F - 1) * hop + n_fft);", ""),
        "FFT plan, no FFT stages": edit(src, FFT_ROWS_A, ""),
        "FFT plan, no power and mel": src[:start] + (
            "  if (tid < frames) mel_out[(size_t)b * n_mels * n_frames + t0 + tid] = buf[tid * m].x;\n"
        ) + src[stop:],
        TWIDDLE_NEGATED: edit(src, TWIDDLE, TWIDDLE_NEGATED_RULE),
    }


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument(
        "--baseline", type=Path, action="append", default=[],
        help="another frontend_kernel.cu to time beside this one (repeatable)",
    )
    parser.add_argument("--routes", action="store_true", help="the routes section alone (ROUTES)")
    parser.add_argument("--primes", action="store_true", help="the prime stage's sections alone (see above)")
    parser.add_argument("--bluestein", action="store_true", help="the Bluestein split alone (see above)")
    parser.add_argument("--turns", action="store_true",
                        help="the SASS of every kernel beside the baselines', then plans in turns (see above)")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0], flush=True)

    src = (kernel_build._CSRC / "frontend_kernel.cu").read_text()
    if args.routes:
        routes_section(build("spectral_probe_routes", src), np.random.default_rng(0), torch.device("cuda"))
        return
    if args.turns:
        baselines = {f"baseline {path}": path.read_text() for path in args.baseline}
        sources = {"FFT plan as built": src, **baselines}
        libs = build_parallel(sources)
        for n, name in enumerate(sources):
            resource_usage(f"spectral_probe_{n}", name)
        sass_section({name: f"spectral_probe_{n}" for n, name in enumerate(sources)}, list(baselines))
        turns_section(libs, sources, list(baselines), np.random.default_rng(0), torch.device("cuda"))
        return
    if args.bluestein:
        baselines = {f"baseline {path}": path.read_text() for path in args.baseline}
        sources = {"FFT plan as built": src, **bluestein_variants(src), **baselines}
        libs = build_parallel(sources)
        for n, name in enumerate(sources):
            resource_usage(f"spectral_probe_{n}", name)
        bluestein_section(libs, list(baselines), np.random.default_rng(0), torch.device("cuda"))
        return
    if args.primes:
        sources = {"FFT plan as built": src, PRIME_CALLED: edit(src, FFT_ROWS_A, FFT_ROWS_A.replace("<11, 1,", "<11, 2,")),
                   **cap_variants(src)}
        sources.update({f"baseline {path}": path.read_text() for path in args.baseline})
        libs = build_parallel(sources)
        for n, name in enumerate(libs):
            resource_usage(f"spectral_probe_{n}", name)
        primes_section(libs, [name for name in libs if name.startswith("baseline")], np.random.default_rng(0),
                       torch.device("cuda"))
        return
    fill_start = src.index('    asm volatile("mbarrier.arrive.expect_tx')
    fill_copy = src[fill_start : src.index("  }\n", fill_start)]
    no_copies = edit(
        src, fill_copy,
        '    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\\n" ::"r"(bar) : "memory");\n',
    )
    no_copies = edit(
        no_copies, '" @go mbarrier.arrive.expect_tx.shared::cta.b64 _, [%2], %5;\\n"',
        '" @go mbarrier.arrive.shared::cta.b64 _, [%2];\\n"',
    )
    no_copies = edit(
        no_copies,
        '" @go cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"\n'
        '        " [%3], [%4], %5, [%2];\\n"\n',
        "",
    )
    variants = {
        "as built": src,
        "one wgmma term": edit(
            src,
            "    wgmma_tf32<kStart>(acc, a_lo[kBuf], b_desc(b));                  // lo * hi\n"
            "    wgmma_tf32<false>(acc, a_hi[kBuf], b_desc(b + kSlotFloats / 2));  // hi * lo\n"
            "    wgmma_tf32<false>(acc, a_hi[kBuf], b_desc(b));                    // hi * hi\n",
            "    wgmma_tf32<kStart>(acc, a_hi[kBuf], b_desc(b));\n",
        ),
        "no table copies": no_copies,
        "no staging": edit(
            src, "if (i0 + u * kThreadsA < len) span[seg * lay.rs + off] = v[u];", "(void)v[u];"
        ),
        "no mel MMAs": edit(
            src,
            "      if (kFirst && s == 0)\n"
            "        wgmma_tf32<true>(macc, p_lo[s], b_desc(hi));\n"
            "      else\n"
            "        wgmma_tf32<false>(macc, p_lo[s], b_desc(hi));\n"
            "      wgmma_tf32<false>(macc, p_hi[s], b_desc(hi + 8 * kN));\n"
            "      wgmma_tf32<false>(macc, p_hi[s], b_desc(hi));\n",
            # Keep the power, and so the DFT's products, in use: an unused
            # accumulator lets the compiler drop the wgmma that writes it.
            "      macc[0] += __uint_as_float(p_hi[s][0] ^ p_lo[s][3]) + hi[0];\n",
        ),
    }

    variants.update(fft_variants(src))
    baselines = [f"baseline {path}" for path in args.baseline]
    variants.update({name: path.read_text() for name, path in zip(baselines, args.baseline)})
    with ThreadPoolExecutor(len(variants) + 1) as pool:
        built = {name: pool.submit(build, f"spectral_probe_{n}", text) for n, (name, text) in enumerate(variants.items())}
        mma = pool.submit(build, "mma_tf32_probe", wgmma_macro() + MMA_BENCH)
        libs = {name: f.result() for name, f in built.items()}
        mma_lib = mma.result()
    for n, name in enumerate(variants):
        if name == "as built" or name in baselines:
            resource_usage(f"spectral_probe_{n}", name)

    cfg = FeatureConfig()
    dev = torch.device("cuda")
    k = frontend_kernel._constants(cfg, dev)
    rng = np.random.default_rng(0)
    w = torch.from_numpy((rng.standard_normal((BATCH, cfg.segment_samples)) * 0.3).astype(np.float32)).to(dev)
    mel = torch.empty((BATCH, cfg.n_mels, cfg.num_frames), device=dev)
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float

    def time_variant(lib: ctypes.CDLL, kpad: int) -> float:
        def launch() -> None:
            err = lib.cdt_frontend_spectral(
                w.data_ptr(), BATCH, cfg.segment_samples, cfg.num_frames, cfg.n_fft,
                cfg.hop_length, k.j0, kpad, k.table.data_ptr(), k.n_bins,
                cfg.n_mels, k.mel_tiles, k.n_groups, 0, 0.0, mel.data_ptr(),
                torch.cuda.current_stream().cuda_stream,
            )
            if err:
                raise RuntimeError(f"launch failed: cudaError {err}")

        for _ in range(3):
            launch()
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(ITERS):
            launch()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / ITERS

    for name, lib in libs.items():
        lib.cdt_frontend_spectral.argtypes = [p, i, i, i, i, i, i, i, p, i, i, i, i, i, f, p, p]
        lib.cdt_frontend_spectral_fft.argtypes = [p, i, i, i, i, i, p, p, i, p, p, i, i, f, p, p]
        if name.startswith("FFT plan") or name in baselines:
            continue
        for kpad in ([k.kpad, 16] if name == "as built" else [k.kpad]):
            print(f"spectral launch B={BATCH}, {name}, kpad={kpad}: {time_variant(lib, kpad):.4f} ms", flush=True)

    lib = mma_lib
    ms, iters = ctypes.c_float(), 3000
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    if lib.run_wgmma(sms, iters, ctypes.byref(ms)):
        raise RuntimeError("wgmma microbenchmark failed")
    flops = 2.0 * 64 * 256 * 8 * 3 * iters * 2 * sms
    print(
        f"wgmma m64n256k8 tf32 alone (2 warpgroups x {sms} SMs, three terms a group): "
        f"{ms.value:.3f} ms, {flops / ms.value / 1e9:.1f} TFLOP/s",
        flush=True,
    )
    if lib.run(sms, iters, ctypes.byref(ms)):
        raise RuntimeError("mma.sync microbenchmark failed")
    flops = 2.0 * 16 * 8 * 8 * 3 * 32 * iters * 8 * sms
    print(
        f"mma.sync m16n8k8 tf32 alone (8 warps x {sms} SMs, 4x8 tile, three terms): "
        f"{ms.value:.3f} ms, {flops / ms.value / 1e9:.1f} TFLOP/s",
        flush=True,
    )
    fft_section(libs, baselines, rng, dev)
    routes_section(libs["as built"], rng, dev)


def cuda_ms(fn, iters: int) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def fft_launch(lib: ctypes.CDLL, w: torch.Tensor, cfg: FeatureConfig, mel: torch.Tensor, tables=None):
    """Launch A's FFT plan through the C function of `lib`, reading
    `tables` (numpy) in place of the plan's own where given (a source with
    HALF_TWIDDLES: legacy_tables)."""
    k = frontend_kernel._fft_constants(cfg, w.device)
    if tables is None and getattr(lib, "half_twiddles", False):
        tables = legacy_tables(cfg.n_fft)
    if tables is not None:
        k = k._replace(twiddles=torch.from_numpy(tables).to(w.device))

    def launch() -> None:
        err = lib.cdt_frontend_spectral_fft(
            w.data_ptr(), w.shape[0], w.shape[1], cfg.num_frames, cfg.n_fft, cfg.hop_length,
            k.window.data_ptr(), k.twiddles.data_ptr(), k.n_used, k.fb_w.data_ptr(), k.fb_ranges.data_ptr(),
            cfg.n_mels, 0, 0.0, mel.data_ptr(), torch.cuda.current_stream().cuda_stream,
        )
        if err:
            raise RuntimeError(f"launch failed: cudaError {err}")

    return launch


def gemm_launch(lib: ctypes.CDLL, w: torch.Tensor, cfg: FeatureConfig, mel: torch.Tensor):
    k = frontend_kernel._constants(cfg, w.device)

    def launch() -> None:
        err = lib.cdt_frontend_spectral(
            w.data_ptr(), w.shape[0], w.shape[1], cfg.num_frames, cfg.n_fft, cfg.hop_length,
            k.j0, k.kpad, k.table.data_ptr(), k.n_bins, cfg.n_mels, k.mel_tiles, k.n_groups, 0, 0.0,
            mel.data_ptr(), torch.cuda.current_stream().cuda_stream,
        )
        if err:
            raise RuntimeError(f"launch failed: cudaError {err}")

    return launch


def n_fft_config(n_fft: int) -> FeatureConfig:
    return FeatureConfig(n_fft=n_fft, win_length=n_fft, hop_length=n_fft // 4, n_mels=128, f_max=8000.0)


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
# The FFT section's configs: hop n_fft / 4 and 128 mels but for 256 mels
# at n_fft 768, 896 and 880, and 44.1 kHz at a 10 ms hop (40, 20 and 30 ms
# windows).
FFT_CONFIGS = {
    "n_fft 2048": n_fft_config(2048),
    "n_fft 2000": n_fft_config(2000),
    "n_fft 3000": n_fft_config(3000),
    "n_fft 768, 256 mels": FeatureConfig(n_fft=768, win_length=768, hop_length=192, n_mels=256, f_max=8000.0),
    "n_fft 896, 256 mels": FeatureConfig(n_fft=896, win_length=896, hop_length=224, n_mels=256, f_max=8000.0),
    "n_fft 1792": n_fft_config(1792),
    "n_fft 2744": n_fft_config(2744),
    "44.1 kHz, n_fft 1764": FeatureConfig(sample_rate=44100, n_fft=1764, win_length=1764, hop_length=441, n_mels=128,
                                          f_max=22050.0),
    "44.1 kHz, n_fft 882": FeatureConfig(sample_rate=44100, n_fft=882, win_length=882, hop_length=441, n_mels=128,
                                         f_max=22050.0),
    "n_fft 880, 256 mels": FeatureConfig(n_fft=880, win_length=880, hop_length=220, n_mels=256, f_max=8000.0),
    "44.1 kHz, n_fft 1323": FeatureConfig(sample_rate=44100, n_fft=1323, win_length=1323, hop_length=441, n_mels=128,
                                          f_max=22050.0),
    "n_fft 1125": FeatureConfig(n_fft=1125, win_length=1125, hop_length=281, n_mels=128, f_max=8000.0),
}


# Configs users set whose plan is timed once beside its library call:
# n_fft with a prime factor of 13, 52 ms at 16 kHz on 256 mels and an odd
# 31 ms at 44.1 kHz (the FFT plan's generic prime stage), and a prime past
# the cap, 137 ms at 16 kHz on 256 mels (Bluestein's stage; the GEMM until
# it).
ROUTES = {
    "n_fft 832 (2^6 13), 256 mels": FeatureConfig(n_fft=832, win_length=832, hop_length=208, n_mels=256,
                                                  f_max=8000.0),
    "44.1 kHz, n_fft 1365 (3 5 7 13, odd)": FeatureConfig(sample_rate=44100, n_fft=1365, win_length=1365,
                                                          hop_length=441, n_mels=128, f_max=22050.0),
    "n_fft 2192 (2^4 137), 256 mels": FeatureConfig(n_fft=2192, win_length=2192, hop_length=548, n_mels=256,
                                                    f_max=8000.0),
}
# Launch A's FFT stages as built (fft_stage_prime inlined) and, as the
# variant PRIME_CALLED, with the prime stage called.
FFT_ROWS_A = "  fft_rows<11, 1, kBluestein>(buf, rows, points, n_fft, tw, &bl);\n"
PRIME_CALLED = "FFT plan, the prime stage called"
# The cap's probe's variants: fft_stage_prime for every prime (kFftMaxPrime
# past any row's), Bluestein's stage from the least cap a row allows
# (LOW_CAP: kFftMaxPrime^2 must pass kFftPoints), and Bluestein's stage
# called, not inlined (a __noinline__ wrapper the variant adds, BLUESTEIN_CALL
# taking it in both launches' instances).
CAP = "constexpr int kFftMaxPrime = "
LOW_CAP = 97
GENERIC = "FFT plan, the generic prime stage past the cap"
LOW = f"FFT plan, Bluestein's stage past {LOW_CAP}"
BLUESTEIN_CALLED = "FFT plan, Bluestein's stage called"
BLUESTEIN_DECL = "__device__ __forceinline__ void fft_stage_bluestein(float2* buf, int total, int p, const Bluestein& bl);\n"
BLUESTEIN_CALL = "      fft_stage_bluestein(buf, total, p, *bl);\n"
BLUESTEIN_AFTER = "// One frame's contrast in one band of w <= 32 kK bins at pb, by a warp:"
CALLED_SIGNATURE = "__device__ __noinline__ void fft_stage_bluestein_call(float2* buf, int total, int p, const Bluestein& bl)"


def cap_variants(src: str) -> dict:
    """The source with the generic prime stage for every prime, with
    Bluestein's stage past LOW_CAP, and with it called through a
    __noinline__ wrapper."""
    line = src[src.index(CAP) : src.index(";", src.index(CAP)) + 1]
    called = edit(src, BLUESTEIN_DECL, BLUESTEIN_DECL + CALLED_SIGNATURE + ";\n")
    called = edit(called, BLUESTEIN_CALL, BLUESTEIN_CALL.replace("bluestein(", "bluestein_call("))
    called = edit(called, BLUESTEIN_AFTER, CALLED_SIGNATURE + " {\n  fft_stage_bluestein(buf, total, p, bl);\n}\n\n"
                  + BLUESTEIN_AFTER)
    return {GENERIC: edit(src, line, CAP + "8191;"), LOW: edit(src, line, f"{CAP}{LOW_CAP};"),
            BLUESTEIN_CALLED: called}


def variant_tables(n_fft: int, name: str) -> np.ndarray:
    """The tables the variant `name` reads: for LOW, Bluestein's past
    LOW_CAP; else the source's own (_fft_tables)."""
    p = frontend_kernel._largest_prime(n_fft)
    if name == LOW and LOW_CAP < p <= frontend_kernel._FFT_MAX_PRIME:
        return np.concatenate([frontend_kernel._twiddles(n_fft), frontend_kernel._bluestein_tables(p)])
    return frontend_kernel._fft_tables(n_fft)


def cap_times(runs: dict, variant_runs: dict, p: int, order_in_turns) -> tuple:
    """The cap's probe at prime p: runs holds the GEMM plan, the FFT plan as
    built and the library call; variant_runs the variants that time the
    other stage at p (GENERIC past the cap, LOW from LOW_CAP to it) and
    Bluestein's stage called past the cap. Times all in turns; returns
    (times, the generic stage's time, Bluestein's or None)."""
    past = p > frontend_kernel._FFT_MAX_PRIME
    other = GENERIC if past else LOW if p > LOW_CAP else None
    names = [other] + ([BLUESTEIN_CALLED] if past else []) if other else []
    allruns = {**runs, **{n: variant_runs[n] for n in names}}
    times = order_in_turns(allruns)
    fft = max(times["FFT plan"])
    generic = max(times[GENERIC]) if past else fft
    bluestein = fft if past else max(times[LOW]) if other else None
    return times, generic, bluestein
# The primes of the cap's probe (a window of p ms at 16 kHz: n_fft 16 p),
# and the FFT plans an earlier source ran, timed against it (--baseline) in turns.
PRIMES = (13, 17, 23, 31, 43, 61, 89, 101, 113, 127, 131, 137, 149, 173, 211, 257, 331, 409)
PRIME_KEEP = {
    "n_fft 2048": n_fft_config(2048),
    "n_fft 2000": n_fft_config(2000),
    "n_fft 1792": n_fft_config(1792),
    "n_fft 2662": n_fft_config(2662),
    "44.1 kHz, n_fft 1323": FFT_CONFIGS["44.1 kHz, n_fft 1323"],
    **{label: ROUTES[label] for label in ("n_fft 832 (2^6 13), 256 mels", "44.1 kHz, n_fft 1365 (3 5 7 13, odd)")},
}


# Launch A's Bluestein plans, split (--bluestein): 16 kHz windows of a prime
# p ms past the cap at hop n_fft / 4 and 128 mels (n_fft 16 p), 137 and 131
# ms on 256 mels, and 44.1 kHz at the odd 1965 (3 5 131) on 256 mels.
BLUESTEIN_CONFIGS = {
    **{f"n_fft {n}": n_fft_config(n) for n in (2192, 2384, 2768, 3376, 4112, 5296, 5872, 6544)},
    "n_fft 2192, 256 mels": ROUTES["n_fft 2192 (2^4 137), 256 mels"],
    "n_fft 1048, 256 mels": FeatureConfig(n_fft=1048, win_length=1048, hop_length=262, n_mels=256, f_max=8000.0),
    "44.1 kHz, n_fft 1965, 256 mels": FeatureConfig(sample_rate=44100, n_fft=1965, win_length=1965, hop_length=441,
                                                    n_mels=256, f_max=22050.0),
}
# Plans with no Bluestein prime, timed as built and beside the baselines
# alone (the shipped n_fft 512 through its GEMM plan).
BLUESTEIN_KEEP = {f"n_fft {n}": n_fft_config(n) for n in (2048, 4096, 2704, 1664)}
NO_BLUESTEIN = "FFT plan, no Bluestein stage"
NO_WARP_FFTS = "FFT plan, Bluestein's gather and scatter only"
NO_RADIX = "FFT plan, no radix stages"
# Bluestein's FFT_m of prime radices alone (no 15 or 9): wrong numbers (its
# stages' twiddles are laid out for the composite ones), the same work.
PRIME_RADICES = "FFT plan, Bluestein's radices 3, 5, 7 and 11 alone"
COMPOSITE = "r % 15 == 0 ? 15 : r % 9 == 0 ? 9 : "
# Bluestein's warp FFTs: the first design's (a block gather into scratch
# rows, two out-of-place warp FFTs a row, a block scatter), and the rows of
# a warp group's since (the first stage gathers, the last scatters: the
# stages between them skipped at BLUESTEIN_MIDDLE, the loop's call).
BLUESTEIN_WARP_FFTS = """\
        float2* a = warp_fft(row, tmp, m, bl.tw(), nullptr, P, m, lane);
        warp_fft(a, a == row ? tmp : row, m, bl.tw(), bl.bhat(), m, P, lane);
"""
BLUESTEIN_MIDDLE = "      blue_stage_at(a, b, ns, mode, bl, tw, x, lane, bar);\n"
# LayoutF's choices for Bluestein's rows, each variant's edit: the tables
# always staged; a warp a group where a block fits (no wider groups for two
# blocks an SM); and one row a block (a frame, or two on an odd n_fft, for
# launch A), for smaller groups where rows fill the block.
BLUESTEIN_LAYOUTS = {
    "FFT plan, LayoutF: one row a block": (
        "    if (contrast)\n      while (rows & (rows - 1)) rows &= rows - 1;\n",
        "    if (contrast)\n      while (rows & (rows - 1)) rows &= rows - 1;\n    if (bp) rows = 1;\n"),
    "FFT plan, LayoutF: the tables staged": ("for (int l = 0; l < 2 && !gw; ++l)", "for (int l = 0; l < 1 && !gw; ++l)"),
    "FFT plan, LayoutF: a warp a group": ("for (int g = 1; g <= kWarpsA && !gw; g *= 2)",
                                          "for (int g = 1; g <= (i ? kWarpsA : 1) && !gw; g *= 2)"),
}


def body_start(src: str, signature: str) -> int:
    """Where the body of the function defined with `signature` starts (past
    its opening brace): its definition, not a declaration."""
    i = src.index(signature)
    while src[src.index(")", i) : src.index(")", i) + 3] != ") {":
        i = src.index(signature, i + 1)
    return src.index("{", i) + 1


def bluestein_variants(src: str) -> dict:
    """The source with Bluestein's stage left out; with its warp FFTs left
    out, so that only its gather and scatter run (the first design: the
    block gathers and scatters, no warp FFT; since: the first stage gathers
    and the last scatters, the stages between left out); and with the
    radix stages (fft_stage) left out. They compute wrong numbers and are
    timed only. On a source with LayoutF's choices for Bluestein's rows,
    also BLUESTEIN_LAYOUTS (right numbers, other layouts), and with its
    composite radices, PRIME_RADICES (their work without them)."""
    def returns(text: str, signature: str) -> str:
        i = body_start(text, signature)
        return text[:i] + "\n  return;" + text[i:]

    warp = (edit(src, BLUESTEIN_WARP_FFTS, "") if BLUESTEIN_WARP_FFTS in src
            else edit(src, BLUESTEIN_MIDDLE, "      if (mode == kGather || mode == kScatter)\n  " + BLUESTEIN_MIDDLE))
    layouts = {name: edit(src, old, new) for name, (old, new) in BLUESTEIN_LAYOUTS.items()
               if BLUESTEIN_MIDDLE in src}
    if COMPOSITE in src:
        layouts[PRIME_RADICES] = edit(src, COMPOSITE, "")
    return {NO_BLUESTEIN: returns(src, "void fft_stage_bluestein("), NO_WARP_FFTS: warp,
            NO_RADIX: returns(src, "void fft_stage("), **layouts}


def build_parallel(sources: dict) -> dict:
    """Each source built as spectral_probe_<n> at once, its C entry points
    typed; prints each build's seconds (nvcc's, the builds side by side)."""
    def timed(n: int, name: str, text: str) -> ctypes.CDLL:
        t0 = time.perf_counter()
        lib = build(f"spectral_probe_{n}", text)
        print(f"built {name}: {time.perf_counter() - t0:.1f} s", flush=True)
        return lib

    with ThreadPoolExecutor(len(sources)) as pool:
        built = {name: pool.submit(timed, n, name, text) for n, (name, text) in enumerate(sources.items())}
        libs = {name: f.result() for name, f in built.items()}
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    for lib in libs.values():
        lib.cdt_frontend_spectral.argtypes = [p, i, i, i, i, i, i, i, p, i, i, i, i, i, f, p, p]
        lib.cdt_frontend_spectral_fft.argtypes = [p, i, i, i, i, i, p, p, i, p, p, i, i, f, p, p]
    return libs


def bluestein_section(libs: dict, baselines: list, rng: np.random.Generator, dev: torch.device) -> None:
    """Launch A's FFT plan on BLUESTEIN_CONFIGS as built, its Bluestein
    variants and the baselines in turns at B = 1024, each build's mel but
    the variants' held to the plain version (1e-3); then `torch.stft` + mel
    twice and the bound; and the variants' savings (the slower as built
    less the slower variant). Then BLUESTEIN_KEEP and the shipped config
    (its GEMM plan), as built and the baselines alone, in turns."""
    variants = [n for n in libs if n != "FFT plan as built" and n not in baselines]
    for label, cfg in BLUESTEIN_CONFIGS.items():
        w = torch.from_numpy((rng.standard_normal((64, cfg.segment_samples)) * 0.3).astype(np.float32)).to(dev)
        w = w.repeat(16, 1)
        mel = torch.empty((1024, cfg.n_mels, cfg.num_frames), device=dev)
        want = frontend_kernel.power_mel_reference(w, cfg)
        frames, nbytes = frontend_kernel._spectral_layout(cfg.n_fft, cfg.hop_length)
        p = frontend_kernel._bluestein_prime(cfg.n_fft)
        times = {}
        for name in baselines + ["FFT plan as built"] + variants + ["FFT plan as built"] + baselines:
            launch = fft_launch(libs[name], w, cfg, mel)
            launch()
            torch.cuda.synchronize()
            err = ((mel - want).abs().max() / want.abs().max()).item()
            if err > 1e-3 and (name not in variants or name in BLUESTEIN_LAYOUTS):
                raise SystemExit(f"launch A's {name} disagrees with plain on {label}: {err:.2e}")
            t = cuda_ms(launch, 20)
            times.setdefault(name, []).append(t)
            print(f"spectral launch B=1024, {label} (P {p}, m {frontend_kernel._bluestein_points(p)}, {frames} frames "
                  f"a block, {nbytes} B), {name}: {t:.4f} ms, max-relative vs plain {err:.2e}", flush=True)
        library = library_mel_fn(cfg, dev)
        lib_ms = [cuda_ms(lambda: library(w), 20) for _ in range(2)]
        bound, by = spectral_bound(cfg, 1024)
        built = times["FFT plan as built"]
        split = ", ".join(f"{v.removeprefix('FFT plan, ')} {max(built) - max(times[v]):.4f}" for v in variants)
        print(f"spectral launch B=1024, {label}: FFT plan as built {min(built):.4f}-{max(built):.4f} ms, "
              + "".join(f"{b} {min(times[b]):.4f}-{max(times[b]):.4f} ms, " for b in baselines)
              + f"torch.stft + mel {min(lib_ms):.4f}-{max(lib_ms):.4f} ms, bound {bound:.4f} ms by {by}; the "
              f"variants' savings (ms, the slower as built less the slower variant): {split}", flush=True)
    order = baselines + ["FFT plan as built", "FFT plan as built"] + baselines
    for label, cfg in {**BLUESTEIN_KEEP, "shipped (GEMM plan)": FeatureConfig()}.items():
        w = torch.from_numpy((rng.standard_normal((64, cfg.segment_samples)) * 0.3).astype(np.float32)).to(dev)
        w = w.repeat(16, 1)
        mel = torch.empty((1024, cfg.n_mels, cfg.num_frames), device=dev)
        make = fft_launch if frontend_kernel.spectral_plan(cfg) == frontend_kernel.PLAN_FFT else gemm_launch
        times = in_turns({name: make(libs[name], w, cfg, mel) for name in set(order)}, order, 20)
        print(f"spectral launch B=1024, {label} (no Bluestein prime), in turns: "
              + ", ".join(f"{n} {min(v):.4f}-{max(v):.4f} ms" for n, v in times.items()), flush=True)


# Launch A's and launch C's Bluestein plans timed in turns (--turns).
TURNS_A = (5296, 6544)
TURNS_C = (5296, 5872, 6544)


def sass_of(build_name: str) -> dict:
    """kernel -> its instructions in build `build_name` (cuobjdump -sass),
    with addresses, constants and the build's own names masked."""
    cuobjdump = Path(kernel_build._nvcc()).with_name("cuobjdump")
    text = subprocess.run([str(cuobjdump), "-sass", str(kernel_build.BUILD_DIR / f"{build_name}.so")],
                          check=True, capture_output=True, text=True).stdout
    funcs, cur = {}, None
    for line in text.splitlines():
        m = re.match(r"\s+Function : (\S+)", line)
        if m:
            cur = re.sub(r"\d+_GLOBAL__N__[0-9a-f]+_\d+_\w+?_cu_[0-9a-f]{8}", "NS", m.group(1))
            funcs[cur] = []
        elif cur and "/*" in line:
            ins = re.sub(r"/\*[0-9a-f]{4,}\*/", "", line).split(";")[0].strip()
            funcs[cur].append(re.sub(r"0x[0-9a-f]+", "X", ins))
    return funcs


def sass_section(builds: dict, baselines: list) -> None:
    """For every kernel of the library as built: its instruction count and,
    beside each baseline's, whether the two are the same instructions; where
    it differs from the first baseline's, the opcodes whose counts differ
    (as built less the baseline) and the first lines that differ."""
    built = sass_of(builds["FFT plan as built"])
    others = {b: sass_of(builds[b]) for b in baselines}
    for kernel, code in sorted(built.items()):
        print(f"SASS {kernel}: as built {len(code)} instructions; "
              + "; ".join(f"{b} {len(o[kernel])}, identical {o[kernel] == code}" if kernel in o else f"not in {b}"
                          for b, o in others.items()), flush=True)
        first = others[baselines[0]].get(kernel) if baselines else None
        if first is None or first == code:
            continue

        def ops(lines: list) -> Counter:
            return Counter(line.split()[1] if line.startswith("@") else line.split()[0] for line in lines if line)

        a, b = ops(code), ops(first)
        moved = {op: a[op] - b[op] for op in a.keys() | b.keys() if a[op] != b[op]}
        changed = [line for line in difflib.unified_diff(first, code, n=0, lineterm="")
                   if line[:1] in "+-" and not line.startswith(("+++", "---"))]
        print(f"  opcodes as built less {baselines[0]}: "
              + ", ".join(f"{op} {n:+d}" for op, n in sorted(moved.items(), key=lambda kv: -abs(kv[1])))
              + f"; {len(changed)} lines differ, the first: " + " | ".join(changed[:6]), flush=True)


def turns_section(libs: dict, sources: dict, baselines: list, rng: np.random.Generator, dev: torch.device) -> None:
    """Launch A and launch C as built and in the baselines, in turns (the
    baselines, as built, as built, the baselines, twice), on the plans with
    no Bluestein prime and on TURNS_A / TURNS_C, at B = 1024; each build's
    output held to the plain version (1e-3); then the library call twice
    and the bound."""
    import contrast_probe as cp
    from cough_detector_tpu_torch.ops import frontend

    order = (baselines + ["FFT plan as built"] * 2 + baselines) * 2
    launch_a = {**BLUESTEIN_KEEP, "shipped (GEMM plan)": FeatureConfig(),
                **{f"n_fft {n} (Bluestein)": n_fft_config(n) for n in TURNS_A}}
    for label, cfg in launch_a.items():
        w = torch.from_numpy((rng.standard_normal((64, cfg.segment_samples)) * 0.3).astype(np.float32)).to(dev)
        w = w.repeat(16, 1)
        want = frontend_kernel.power_mel_reference(w, cfg)
        make = fft_launch if frontend_kernel.spectral_plan(cfg) == frontend_kernel.PLAN_FFT else gemm_launch
        runs, outs = {}, {}
        for name in libs:
            outs[name] = torch.empty((1024, cfg.n_mels, cfg.num_frames), device=dev)
            runs[name] = make(libs[name], w, cfg, outs[name])
            runs[name]()
        torch.cuda.synchronize()
        for name, out in outs.items():
            err = ((out - want).abs().max() / want.abs().max()).item()
            if err > 1e-3:
                raise SystemExit(f"launch A's {name} disagrees with plain on {label}: {err:.2e}")
        times = in_turns(runs, order, 20)
        library = library_mel_fn(cfg, dev)
        lib_ms = [cuda_ms(lambda: library(w), 20) for _ in range(2)]
        bound, by = spectral_bound(cfg, 1024)
        print(f"spectral launch B=1024, {label}, in turns: "
              + ", ".join(f"{n} {min(v):.4f}-{max(v):.4f} ms" for n, v in times.items())
              + f"; torch.stft + mel {min(lib_ms):.4f}-{max(lib_ms):.4f} ms, bound {bound:.4f} ms by {by}", flush=True)
    clibs = {name: cp.typed(lib, sources[name]) for name, lib in libs.items()}
    launch_c = {**cp.BLUESTEIN_KEEP, **{f"n_fft {n} (Bluestein)": cp._wide(n) for n in TURNS_C}}
    for label, cfg in launch_c.items():
        w = torch.from_numpy((rng.standard_normal((64, cfg.segment_samples)) * 0.3).astype(np.float32)).to(dev)
        w = w.repeat(16, 1)
        want = frontend_kernel.spectral_contrast_reference(w, cfg)
        runs, outs = {}, {}
        for name in clibs:
            outs[name] = torch.empty((1024, cfg.n_contrast_bands + 1, cfg.num_frames), device=dev)
            runs[name] = cp.fft_launch(clibs[name], w, cfg, outs[name])
            runs[name]()
        torch.cuda.synchronize()
        for name, out in outs.items():
            err = ((out - want).abs().max() / want.abs().max()).item()
            if err > 1e-3:
                raise SystemExit(f"launch C's {name} disagrees with plain on {label}: {err:.2e}")
        times = in_turns(runs, order, 10)
        rows = [cuda_ms(lambda: frontend.spectral_contrast(w, cfg, method="fft"), 5) for _ in range(2)]
        bound, by = cp.contrast_bound(cfg, 1024)
        print(f"contrast launch B=1024, {label}, in turns: "
              + ", ".join(f"{n} {min(v):.4f}-{max(v):.4f} ms" for n, v in times.items())
              + f"; fft rows {min(rows):.4f}-{max(rows):.4f} ms, bound {bound:.4f} ms by {by}", flush=True)


def library_mel_fn(cfg: FeatureConfig, dev: torch.device):
    """`torch.stft` (cuFFT) power and a mel matmul: launch A's library call."""
    from cough_detector_tpu_torch.ops import filters

    fb = torch.from_numpy(
        filters.mel_filterbank(cfg.n_fft // 2 + 1, cfg.n_mels, cfg.sample_rate, cfg.f_min, cfg.f_max)
    ).to(dev)
    window = torch.hann_window(cfg.win_length, device=dev)

    def library_mel(w: torch.Tensor) -> torch.Tensor:
        spec = torch.stft(w, cfg.n_fft, cfg.hop_length, cfg.win_length, window, center=True, pad_mode="reflect",
                          return_complex=True)
        return (spec.real**2 + spec.imag**2).transpose(1, 2) @ fb

    return library_mel


def routes_section(lib: ctypes.CDLL, rng: np.random.Generator, dev: torch.device) -> None:
    """Each ROUTES config's launch as its plan takes it, checked against the
    plain version, and its library call, in turns (launch, library,
    library, launch), at B = 1024."""
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.cdt_frontend_spectral.argtypes = [p, i, i, i, i, i, i, i, p, i, i, i, i, i, f, p, p]
    lib.cdt_frontend_spectral_fft.argtypes = [p, i, i, i, i, i, p, p, i, p, p, i, i, f, p, p]
    for label, cfg in ROUTES.items():
        w = torch.from_numpy((rng.standard_normal((64, cfg.segment_samples)) * 0.3).astype(np.float32)).to(dev)
        w = w.repeat(16, 1)
        mel = torch.empty((1024, cfg.n_mels, cfg.num_frames), device=dev)
        plan = frontend_kernel.spectral_plan(cfg)
        fft = plan == frontend_kernel.PLAN_FFT
        launch = (fft_launch if fft else gemm_launch)(lib, w, cfg, mel)
        launch()
        torch.cuda.synchronize()
        want = frontend_kernel.power_mel_reference(w, cfg)
        err = ((mel - want).abs().max() / want.abs().max()).item()
        if err > 1e-3:
            raise SystemExit(f"launch A disagrees with its plain version on {label}: {err:.2e}")
        library = library_mel_fn(cfg, dev)
        runs = {"launch": launch, "torch.stft + mel": lambda: library(w)}
        times = {name: [] for name in runs}
        for name in ("launch", "torch.stft + mel", "torch.stft + mel", "launch"):
            times[name].append(cuda_ms(runs[name], 5))
        route = (f"FFT, stages {frontend_kernel._fft_radices(frontend_kernel._spectral_points(cfg.n_fft))}" if fft
                 else f"GEMM {'staged' if plan else 'span from device memory'}, "
                      f"{frontend_kernel.mel_groups(cfg.n_mels)[1]} mel groups")
        print(
            f"spectral launch B=1024, {label} ({cfg.num_frames} frames; plan {route}), in turns: "
            + ", ".join(f"{n} {[round(t, 4) for t in v]} ms" for n, v in times.items())
            + f"; max-relative vs plain {err:.2e}",
            flush=True,
        )


def both_plans(lib: ctypes.CDLL, w: torch.Tensor, cfg: FeatureConfig, iters: int) -> str:
    """Both plans through their C functions, in turns (GEMM, FFT, FFT,
    GEMM), each checked against the plain version."""
    mel = torch.empty((w.shape[0], cfg.n_mels, cfg.num_frames), device=w.device)
    want = frontend_kernel.power_mel_reference(w, cfg)
    plans = {"GEMM plan": gemm_launch(lib, w, cfg, mel), "FFT plan": fft_launch(lib, w, cfg, mel)}
    times = {"GEMM plan": [], "FFT plan": []}
    for name in ("GEMM plan", "FFT plan", "FFT plan", "GEMM plan"):
        plans[name]()
        torch.cuda.synchronize()
        err = ((mel - want).abs().max() / want.abs().max()).item()
        if err > 1e-3:
            raise SystemExit(f"the {name} disagrees with the plain version at n_fft {cfg.n_fft}: {err:.2e}")
        times[name].append(cuda_ms(plans[name], iters))
    return ", ".join(f"{n} {[round(t, 4) for t in v]} ms" for n, v in times.items())


def fft_section(libs: dict, baselines: list, rng: np.random.Generator, dev: torch.device) -> None:
    """The FFT plan's parts at B = 1024 on n_fft 2048 and 2000, and the
    FFT plan on FFT_CONFIGS as built and with the negated twiddle rule on
    an even n_fft, between the baselines'; both plans around the FFT plan's threshold,
    then the FFT plan on the shipped config beside its GEMM plan at B =
    4096, in turns."""
    parts = [n for n in libs if n.startswith("FFT plan") and n not in ("FFT plan as built", TWIDDLE_NEGATED)]
    for label, cfg in FFT_CONFIGS.items():
        w = torch.from_numpy((rng.standard_normal((64, cfg.segment_samples)) * 0.3).astype(np.float32)).to(dev)
        w = w.repeat(16, 1)
        mel = torch.empty((1024, cfg.n_mels, cfg.num_frames), device=dev)
        want = frontend_kernel.power_mel_reference(w, cfg)
        split = parts if label in ("n_fft 2048", "n_fft 2000") else []
        for name in baselines + ["FFT plan as built"] + split + [TWIDDLE_NEGATED, "FFT plan as built"] + baselines:
            launch = fft_launch(libs[name], w, cfg, mel)
            try:
                launch()
            except RuntimeError:
                if name in baselines:  # a source before this n_fft's stages
                    continue
                raise
            t = cuda_ms(launch, 20)
            err = ((mel - want).abs().max() / want.abs().max()).item()
            stages = frontend_kernel._fft_radices(frontend_kernel._spectral_points(cfg.n_fft))
            print(f"spectral launch B=1024, {label} (stages {stages}), {name}: "
                  f"{t:.4f} ms, max-relative vs plain {err:.2e}", flush=True)

    lib = libs["as built"]
    for n_fft in (640, 672, 675, 693, 704, 768, 784, 1000, 1024):
        cfg = n_fft_config(n_fft)
        for b, iters in ((1024, 20), (BATCH, ITERS)):
            w = torch.from_numpy((rng.standard_normal((64, cfg.segment_samples)) * 0.3).astype(np.float32)).to(dev)
            w = w.repeat(b // 64, 1)
            print(
                f"spectral launch B={b}, n_fft {n_fft}, hop {cfg.hop_length}, 128 mels (plan "
                f"{frontend_kernel.spectral_plan(cfg)}), through each plan's C function in turns: "
                + both_plans(lib, w, cfg, iters),
                flush=True,
            )

    shipped = FeatureConfig()
    w = torch.from_numpy((rng.standard_normal((BATCH, shipped.segment_samples)) * 0.3).astype(np.float32)).to(dev)
    print(
        f"spectral launch B={BATCH}, shipped config (plan {frontend_kernel.spectral_plan(shipped)}: the GEMM staged), "
        f"through each plan's C function in turns: " + both_plans(lib, w, shipped, ITERS),
        flush=True,
    )


def in_turns(runs: dict, order: tuple, iters: int) -> dict:
    times = {name: [] for name in runs}
    for name in order:
        times[name].append(cuda_ms(runs[name], iters))
    return times


def primes_section(libs: dict, baselines: list, rng: np.random.Generator, dev: torch.device) -> None:
    """PRIME_KEEP as built between the baselines; the cap's probe on
    PRIMES; both plans near kFftMinNfft on a factor of 13; the routes."""
    lib = libs["FFT plan as built"]
    for label, cfg in PRIME_KEEP.items():
        w = torch.from_numpy((rng.standard_normal((64, cfg.segment_samples)) * 0.3).astype(np.float32)).to(dev)
        w = w.repeat(16, 1)
        mel = torch.empty((1024, cfg.n_mels, cfg.num_frames), device=dev)
        want = frontend_kernel.power_mel_reference(w, cfg)
        stages = frontend_kernel._fft_radices(frontend_kernel._spectral_points(cfg.n_fft))
        for name in baselines + ["FFT plan as built", PRIME_CALLED, "FFT plan as built"] + baselines:
            launch = fft_launch(libs[name], w, cfg, mel)
            try:
                launch()
            except RuntimeError:
                if name in baselines:  # a source before this n_fft's stages
                    continue
                raise
            t = cuda_ms(launch, 20)
            err = ((mel - want).abs().max() / want.abs().max()).item()
            print(f"spectral launch B=1024, {label} (stages {stages}), {name}: {t:.4f} ms, max-relative vs plain "
                  f"{err:.2e}", flush=True)

    wins = []
    for p in PRIMES:
        cfg = n_fft_config(16 * p)
        w = torch.from_numpy((rng.standard_normal((64, cfg.segment_samples)) * 0.3).astype(np.float32)).to(dev)
        w = w.repeat(16, 1)
        mel = torch.empty((1024, cfg.n_mels, cfg.num_frames), device=dev)
        want = frontend_kernel.power_mel_reference(w, cfg)
        library = library_mel_fn(cfg, dev)
        runs = {"GEMM plan": gemm_launch(lib, w, cfg, mel), "FFT plan": fft_launch(lib, w, cfg, mel),
                "torch.stft + mel": lambda: library(w)}
        variants = {n: fft_launch(libs[n], w, cfg, mel, variant_tables(cfg.n_fft, n))
                    for n in (GENERIC, LOW, BLUESTEIN_CALLED)}
        for name, run in {**runs, **variants}.items():
            if name == "torch.stft + mel":
                continue
            run()
            torch.cuda.synchronize()
            err = ((mel - want).abs().max() / want.abs().max()).item()
            if err > 1e-3:
                raise SystemExit(f"the {name} disagrees with the plain version at n_fft {cfg.n_fft}: {err:.2e}")
        times, generic, bluestein = cap_times(runs, variants, p, lambda r: in_turns(r, tuple(r) + tuple(r)[::-1], 10))
        fft = max(times["FFT plan"])
        beats = (fft < min(times["GEMM plan"]), fft < min(times["torch.stft + mel"]),
                 generic < min(times["GEMM plan"]) and generic < min(times["torch.stft + mel"]),
                 bluestein is not None and bluestein < generic)
        wins.append(beats)
        stage = "Bluestein's stage" if p > frontend_kernel._FFT_MAX_PRIME else "the generic prime stage"
        print(f"spectral launch B=1024, a window of {p} ms at 16 kHz: n_fft {cfg.n_fft}, hop {cfg.hop_length}, 128 mels "
              f"(points' prime factors {frontend_kernel._prime_factors(frontend_kernel._spectral_points(cfg.n_fft))}; "
              f"the FFT plan as built runs {stage}), in turns: "
              + ", ".join(f"{n} {[round(t, 4) for t in v]} ms" for n, v in times.items())
              + f"; the FFT plan beats the GEMM: {beats[0]}, the library: {beats[1]}"
              + (f"; Bluestein's stage beats the generic one: {beats[3]}" if bluestein is not None else ""), flush=True)
    generic = [p for p, b in zip(PRIMES, wins) if b[2]]
    bluestein = [p for p, b in zip(PRIMES, wins) if b[3]]
    lost = [(p, "GEMM" if not gemm else "torch.stft + mel") for p, (gemm, library, _, _) in zip(PRIMES, wins)
            if (16 * p >= frontend_kernel._FFT_MIN_NFFT and not gemm) or not library]
    print(f"launch A's cap: the largest probed prime at which the generic prime stage's FFT plan beats the GEMM and "
          f"the torch.stft + mel: {max(generic, default=None)}; the probed primes at which Bluestein's stage beats "
          f"it: {bluestein}; from n_fft {frontend_kernel._FFT_MIN_NFFT} the FFT plan as built loses to (prime, "
          f"call): {lost}", flush=True)

    for n_fft in (650, 676, 715):
        cfg = n_fft_config(n_fft)
        for b, iters in ((1024, 20), (BATCH, ITERS)):
            w = torch.from_numpy((rng.standard_normal((64, cfg.segment_samples)) * 0.3).astype(np.float32)).to(dev)
            w = w.repeat(b // 64, 1)
            print(
                f"spectral launch B={b}, n_fft {n_fft}, hop {cfg.hop_length}, 128 mels (plan "
                f"{frontend_kernel.spectral_plan(cfg)}), through each plan's C function in turns: "
                + both_plans(lib, w, cfg, iters),
                flush=True,
            )
    routes_section(lib, rng, dev)


if __name__ == "__main__":
    main()
