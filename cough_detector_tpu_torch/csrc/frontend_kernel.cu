// Fused front end for Hopper (sm_90a): raw waveform batch → stacked
// feature image (B, num_features, num_frames), in two launches; for a
// config with spectral contrast a third (contrast_kernel, launch C, its
// note above it) computes the contrast rows the launcher appends.
//
// Replaces cough_detector_tpu/ops/pallas/frontend_kernel.py::_kernel and
// its launcher _run (the repo's only Pallas kernel). Launch A
// (spectral_kernel, or spectral_fft_kernel: its FFT plan) does _kernel's
// steps 1-2 and _run's pre-emphasis and reflect pad: framing, windowed
// band-limited rDFT, power, mel projection.
// Launch B (epilogue_kernel) does the rest: log-mel, then the dB branch
// (clamp to per-clip max - 80, (db+80)/80 in [0, 1]) or the PCEN branch
// (10-tap zero-padded smoother, compressive formula, per-clip min-max), the
// DCT-II, the per-clip unbiased z-norm, deltas and optional delta-deltas.
//
// Launch A: the DFT and the mel on the tensor cores (wgmma), in 3xTF32.
//  * Bound: bytes. Per clip of the shipped config (16000 samples, 101
//    frames, n_fft 512 with a 400-tap window, 128 of 257 bins used, 64
//    mels) the function moves 90 KB (64 KB of waveform in, 26 KB of power
//    mel out), 27 ns at 3.35 TB/s, and needs 1.3 MFLOP done as an FFT a
//    frame (2.5 n log2 n, the window, the power, the filterbank's nonzero
//    entries), 19 ns at the FP32 CUDA-core peak (67 TFLOP/s).
//  * This design's own ceiling is higher: its DFT as a GEMM over the
//    window's 399 nonzero taps is 22.3 MFLOP a clip (the DFT 20.6 M, the
//    power and the mel 1.65 M), 45 ns at the TF32 tensor-core peak (495
//    TFLOP/s); it issues every product three times (below) and pads 101
//    frames to 128 rows, so it reaches at most a quarter of that ceiling.
//  * The DFT as a GEMM. M: the frames of one clip, padded to 128 rows, one
//    block per (128-frame tile, clip), two warpgroups of 64 rows: the
//    clip's waveform is staged once and read from device memory once. K:
//    the window's support, in k-steps of 8 taps (padded to an even count).
//    N: the used bins' cos and -sin columns, interleaved (column 2k =
//    cos k, 2k+1 = -sin k), in passes of 256 columns, one wgmma.m64n256k8
//    a term and k-step: one pass at the shipped config, three at f_max =
//    8 kHz (257 bins). In the accumulator fragment a thread holds re and
//    im of one bin side by side, so the power forms in registers.
//  * A operand, from registers. Frames overlap (hop 160 < 400 taps), so A
//    is no plain matrix: each thread gathers its four values from the
//    tile's waveform span in shared memory at row*hop + tap and splits each
//    into hi = rna(x) and lo = rna(x - hi), rna being cvt.rna.tf32.f32's
//    rounding done in two integer instructions (raw f32 bits fed to a .tf32
//    MMA would be truncated, and hi + lo would not rebuild x). The span is
//    stored with `skew` pad floats after every hop samples, so that the 8
//    rows of a fragment fall in distinct banks (hop 160 is a multiple of
//    32).
//  * B operand, from shared memory. The tables (windowed DFT, filterbank)
//    are split into hi/lo TF32 on the host once per config, laid out as
//    K-major tiles without swizzle and streamed, as the 16 KB chunks they
//    are consumed in, through a ring of 2-4 slots (as shared memory
//    allows). Each chunk lands by one bulk asynchronous copy (TMA, no tensor
//    map: a chunk is contiguous) on an mbarrier; the last warp to release
//    a slot refills it, so a warp waits for data, never for the other
//    warps. The DFT table is 800 KB at the shipped config: too large for
//    shared memory, small enough that every block finds it in L2.
//  * 3xTF32: per k-step, acc += a_lo*b_hi, acc += a_hi*b_lo, then
//    acc += a_hi*b_hi, into one FP32 accumulator; lo*lo is dropped. One
//    TF32 pass keeps 11 significant bits of each operand, and the DFT
//    cancels (its terms sum to far more than its result), so one pass
//    breaks the 1e-3 feature budget of docs/PARITY.md on every config the
//    tests hold; three hold it (PERF.md; the CPU model of this arithmetic
//    is ops/frontend_kernel.py::power_mel_split_reference). Three TF32
//    passes cost the tensor-core time of the TPU kernel's six bf16 ones
//    and need one split per operand.
//  * The mel never leaves registers. For mel k-step s (bins 8s to 8s + 7)
//    a thread's wgmma A fragment is the power of bins 8s + t and 8s + t + 4
//    of its rows g and g + 8: the DFT n-tiles 2s and 2s + 1 that the same
//    thread holds. So the power is formed, split and fed to wgmma.m64nNk8
//    (N = 32, 64 or 128 mels) pass by pass, the filterbank's tiles
//    streaming through the ring after each pass's DFT chunks. Output
//    (B, n_mels, n_frames), frames fastest, the layout launch B reads.
//  * Issue. One wgmma group (the three terms of a k-step) stays in flight
//    while the next k-step's A is gathered. Nothing else may write the
//    accumulators meanwhile, or the compiler serializes the MMAs: the first
//    product of a sum starts it (scale-d 0, outputs only) instead of a
//    zeroing loop; the mbarrier wait loop and the lane-0 refill are inside
//    asm, with predicates, so no C++ branch surrounds an in-flight group.
//
//  * Every config. An n_fft that the FFT plans fit (fft_fits, LayoutF: a
//    prime factor up to 1997), odd or even, from 640 on, or past 128 mels,
//    takes the FFT plan (spectral_fft_kernel, plan_a; its note with the
//    FFT plans below): at n_fft 2048 this GEMM ran 13.75 ms at B = 1024
//    where cuFFT and a mel matmul take 1.06, and on 256 mels its two mel
//    groups 1.34 ms against the FFT plan's 0.67. Any other n_fft (a prime
//    factor past 1997, past 16384) stays here:
//    more than 128 mels take mel groups of at most 128, each its own
//    blocks on grid x, the DFT run again for each (the registers hold one
//    group's mel accumulators beside the DFT's); a tile whose waveform
//    span passes shared memory (as 1,792 at hop 448) gathers its A
//    fragments from device memory instead of the span (DftPass<false>,
//    staged_a). A hop under 8 takes no bank skew.
//
// What a later PR does next on launch A: stage the next clip's waveform
// while this one computes (a persistent block), the largest fixed cost
// left (tools/spectral_probe.py); rows packed across clips instead of
// padding 101 frames to 128; then the power mel's round trip through
// device memory between the launches, about 52 KB a clip. The FFT plan
// runs the shipped config in 1.73 ms at B = 4096 against this design's
// 1.00, so the shipped config keeps it. On the FFT plans: fewer stages
// (radix 8 and 16 in registers: fewer barriers and passes over shared
// memory) and stores that meet no bank conflicts. Until the FFT plans'
// radix-3 and radix-5 stages, the GEMM plans lost to cuFFT on n_fft 2000
// (launch A 12.49 ms at B = 1024 against 1.24, launch C 20.32 against
// 4.50) and on n_fft 768 with two mel groups (3.13 against 1.35); until
// their radix-11 stages and odd frames, on n_fft 2662 with contrast (22.9
// against 4.5) and the odd 1323 at 44.1 kHz (10.9-11.5 against 2.9);
// until their generic prime stage, on a factor of 13 (2704 with contrast
// 22.9 against 4.4); until their Bluestein stage, on a prime factor past
// 127 (2192 at 256 mels: 29.4 ms against 1.8). An n_fft the FFT plans do
// not fit (a prime factor past 1997) still takes them.
//
// Launch B: one block per clip, because the per-clip reductions (dB max,
// PCEN min/max, MFCC mean/variance) span all frames; FP32 on the CUDA
// cores, bound by bytes (0.17 MFLOP of DCT on 62 KB a clip). The clip sits
// in one shared tile; the DCT runs frames across threads into registers.
// It writes (B, F, T), the reference layout (the note above
// epilogue_kernel). A clip whose tile passes one block (past 4.3 s at
// 128 mels, 8.9 s at 64) runs on a thread-block cluster
// (epilogue_cluster_kernel, its note): the fewest blocks of 256 threads
// (up to 16) whose share of the frames, with a few frames more on each
// side loaded from device memory, fits three blocks an SM (else two, else
// one), so that only the reductions cross the blocks, in distributed
// shared memory, 2-3 cluster barriers a clip. On an H100, 10 s clips read
// 43% of their bytes bound at B = 1024 (0.43 ms; the first cluster design
// 1.72; tools/epilogue_probe.py). Past a cluster of 16, one block a clip
// works in device memory (plan_b), at 0.6% of its bound on 120 s clips.
//
// Interface: plain C, loaded with ctypes, one function per launch, and one
// per launch for its shared memory and its plan (the Python mirrors' check).
// The caller allocates every buffer; each function launches its kernel on
// `stream`, does not synchronise, and returns cudaGetLastError() (or the
// error of a refused attribute call).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarpsA = 8;                          // two warpgroups
constexpr int kThreadsA = 32 * kWarpsA;             // 256
constexpr int kRows = 128;                          // frames a block owns: two wgmma tiles of 64
constexpr int kPassCols = 256;                      // DFT columns a pass: 128 bins
constexpr int kSlotFloats = 2 * 8 * kPassCols;      // a ring slot, 16 KB: one DFT k-step
constexpr int kMaxSlots = 4;
constexpr int kStageBatch = 24;                     // staging loads in flight
constexpr size_t kMaxSmem = 232448;                 // bytes a block may use on sm_90
constexpr int kThreadsB = 128;                      // launch B: 4 warps, one clip
constexpr int kLoadB = 16;                          // loads a launch B thread keeps in flight
constexpr int kRedB = 32;                           // floats of launch B's reduction slots
constexpr int kMaxCluster = 16;                     // launch B: blocks a clip (past 8, a non-portable cluster)
constexpr int kPortableCluster = 8;                 // past it, the kernel needs the non-portable attribute
constexpr int kThreadsBC = 256;                     // launch B's cluster route: 8 warps a block
constexpr int kWarpsBC = kThreadsBC / 32;
constexpr int kRanksBC = 5 * kWarpsBC;              // its slots: 5 reductions' warp partials, then their ranks'
constexpr int kRedBC = kRanksBC + 5 * kMaxCluster;  // 120 floats of reduction slots
constexpr int kSmemSM = 233472;                     // shared memory of an SM, 1 KB of it reserved a block
constexpr int kBlocksSM = 3;                        // launch B's cluster blocks an SM at most
constexpr int kRedC = 16;                           // floats of launch C's reduction slots
constexpr int kBandWarps = 4;                       // launch C's GEMM plan: a warpgroup of band warps
constexpr int kThreadsC = kThreadsA + 32 * kBandWarps;  // beside its two MMA warpgroups: 384
constexpr int kRegMma = 208;                        // its registers a thread by setmaxnreg: 2 x 128 x 208
constexpr int kRegBand = 88;                        // + 128 x 88 = 384 x 168, __launch_bounds__(384, 1)'s
constexpr int kBandFrames = 4;                      // its band items: frames of a band a warp takes at once
constexpr int kSortedBand = 128;                    // its bands sorted in registers (band_values); wider, ranked
constexpr int kBandChunk = 128;                     // launch C: a band's bins a selection pass, 4 a lane
constexpr int kWideBand = 512;                      // launch C's FFT plan: wider bands by the block (block_tails)
constexpr int kFftPoints = 8192;                    // FFT plans: complex points a block holds (64 KB)
constexpr int kFftMaxFrames = 32;                   // FFT plans: frames a block takes at most
constexpr int kFftMinNfft = 640;                    // FFT plans: the least n_fft they take (past 128 mels any)
constexpr int kFftMaxPrime = 113;                   // FFT plans: the largest prime of fft_stage_prime; past it Bluestein
constexpr int kSmemTwo = kSmemSM / 2 - 1024;        // bytes a block may use for two blocks an SM
constexpr int kBluesteinPoints = 4096;              // Bluestein's convolution: its m points at most
constexpr int kPostItems = kFftPoints / kThreadsA + 1;  // launch A's FFT plan: power values a thread holds
constexpr float kAmin = 1e-10f;
constexpr float kDbScale = 4.3429448190325175f;  // 10 / ln(10)

// Launch A's shared memory, in floats: the ring, then the waveform span,
// then the ring's mbarriers and counters. All 128 rows are computed, so the
// span holds every sample they read: the frames' samples, zeros after them.
// A tile whose span would pass the card's shared memory (n_fft 2048 at hop
// 512: 268 KB) is not staged (`staged` false, span 0): its A fragments are
// gathered from device memory, through L1 and L2 (DftPass<false>). A hop
// under 8 takes no skew: a k-step of 8 taps may then cross several hops,
// and DftPass advances the skew at most once a k-step.
struct LayoutA {
  int skew, rs, span;

  __host__ __device__ LayoutA(int hop, int kpad, bool staged = true) {
    skew = hop < 8 ? 0 : ((4 - hop) % 8 + 8) % 8;  // hop + skew = 4 (mod 8): 8 rows, 8 banks
    rs = hop + skew;
    const int len = (kRows - 1) * hop + kpad;
    span = staged ? ((len / hop + 1) * rs + 3) / 4 * 4 : 0;
  }

  __host__ __device__ size_t bytes(int n_slots) const {
    return sizeof(float) * ((size_t)n_slots * kSlotFloats + span) + 12 * kMaxSlots;
  }
};

// Whether launch A stages its tile's span in shared memory (with the
// smallest ring), or gathers its A fragments from device memory.
__host__ __device__ inline bool staged_a(int hop, int kpad) {
  return LayoutA(hop, kpad).bytes(2) <= kMaxSmem;
}

// Launch B's layout. The DCT takes kc MFCCs a pass, its table padded to cp
// columns. Shared memory, in floats: the reduction slots (red floats), the
// DCT table (M x cp), the clip's power mel (M x cols), the MFCC tile
// (C x cols) and, with delta-deltas, the delta tile (C x cols). The MFCC
// and delta tiles take the mel tile's first 2C rows where those fit and the
// DCT takes one pass (see epilogue_kernel), else they follow it. One block
// holds a clip's T frames (cols = T); a block of a cluster its T frames
// and `halo` more on each side (epilogue_cluster_kernel).
struct LayoutB {
  int kc, cp, cols;
  size_t tile, mf, d1, floats;

  __host__ __device__ LayoutB(int T, int M, int C, int delta_delta, int halo = 0, int red = kRedB) {
    kc = C <= 8 ? 8 : (C <= 16 ? 16 : 32);
    cp = (C + kc - 1) / kc * kc;
    cols = T + 2 * halo;
    tile = red + (size_t)M * cp;
    const size_t tile_end = tile + (size_t)M * cols;
    mf = C <= 32 && 2 * C <= M ? tile : tile_end;
    d1 = mf + (size_t)C * cols;
    const size_t end = d1 + (delta_delta ? (size_t)C * cols : 0);
    floats = end > tile_end ? end : tile_end;
  }
};

// The frames a cluster block holds on each side of its own: PCEN's
// smoother reads 5 before a frame and 4 after; a delta reads the MFCCs of
// the frames beside it, a delta-delta the deltas beside it.
__host__ __device__ inline int halo_b(int use_pcen, int delta_delta) { return use_pcen ? 5 : 1 + delta_delta; }

// Shared-memory bytes of a block of launch B's cluster route with n blocks a clip.
__host__ __device__ inline size_t cluster_bytes_b(int T, int M, int C, int use_pcen, int delta_delta, int n) {
  const LayoutB lay((T + n - 1) / n, M, C, delta_delta, halo_b(use_pcen, delta_delta), kRedBC);
  return sizeof(float) * lay.floats;
}

// Launch B's plan for a clip of T frames: 1, one block holds the clip
// (epilogue_kernel's design); 2 to kMaxCluster, a thread-block cluster of
// that many blocks, each holding ceil(T / n) of its frames
// (epilogue_cluster_kernel): for k = kBlocksSM, then fewer, the fewest
// blocks that fit k an SM; 0, not even one an SM fits, and one block a
// clip works in device memory (epilogue_kernel<..., true>).
__host__ __device__ inline int plan_b(int T, int M, int C, int use_pcen, int delta_delta) {
  if (sizeof(float) * LayoutB(T, M, C, delta_delta).floats <= kMaxSmem) return 1;
  for (int k = kBlocksSM; k >= 1; --k)
    for (int n = 2; n <= kMaxCluster; ++n)
      if (cluster_bytes_b(T, M, C, use_pcen, delta_delta, n) <= (size_t)(kSmemSM / k - 1024)) return n;
  return 0;
}

// Launch B's shared memory a block under its plan: LayoutB at the clip's
// frames, a cluster block's, or the reduction slots alone in device memory.
__host__ __device__ inline size_t smem_b(int T, int M, int C, int use_pcen, int delta_delta) {
  const int n = plan_b(T, M, C, use_pcen, delta_delta);
  if (n == 0) return sizeof(float) * kRedB;
  if (n == 1) return sizeof(float) * LayoutB(T, M, C, delta_delta).floats;
  return cluster_bytes_b(T, M, C, use_pcen, delta_delta, n);
}

// Launch B's threads a block under plan n.
__host__ __device__ inline int threads_b(int n) { return n >= 2 ? kThreadsBC : kThreadsB; }

// x rounded to TF32, to nearest with ties away from zero: the bits of
// cvt.rna.tf32.f32 for every finite x, in two integer instructions (the
// cvt's NaN and overflow handling costs four more, and nothing here is
// infinite).
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
}

__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - __uint_as_float(hi));  // exact: hi is x rounded
}

// Shared-memory matrix descriptor of a K-major B tile without swizzle: core
// matrices of 8 columns x 4 k (16 bytes a column), 128 bytes apart along K
// (leading byte offset) and 256 bytes apart along N (stride byte offset).
__device__ __forceinline__ uint64_t b_desc(const float* tile) {
  const uint64_t addr = (uint32_t)__cvta_generic_to_shared(tile);
  return ((addr & 0x3FFFF) >> 4) | ((uint64_t)(128 >> 4) << 16) | ((uint64_t)(256 >> 4) << 32);
}

// d (the warpgroup's 64 x N accumulator fragment, N / 2 floats a thread)
// = A (64 x 8, this thread's fragment in a, TF32 bits) * B (8 x N at desc)
// if kStart, else d += A * B, asynchronously; N = 256 for the DFT, 32, 64
// or 128 for the mel. The first product of a sum starts it (its
// accumulators are outputs only), so no other instruction writes them while
// wgmma groups are in flight, and they hold no registers before it.
// fence_acc is an empty instruction that reads and writes every
// accumulator register, so that the compiler keeps them in place around an
// in-flight wgmma group.
template <bool kStart>
__device__ __forceinline__ void wgmma_tf32(float (&d)[128], const uint32_t (&a)[4], uint64_t desc) {
  if (kStart) {
    asm volatile(
        "{\n .reg .pred p;\n setp.ne.b32 p, 0, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
        "{%128, %129, %130, %131}, %132, p, 1, 1;\n}\n"
        : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]), "=f"(d[4]), "=f"(d[5]), "=f"(d[6]), "=f"(d[7]), "=f"(d[8]), "=f"(d[9]), "=f"(d[10]), "=f"(d[11]), "=f"(d[12]), "=f"(d[13]), "=f"(d[14]), "=f"(d[15]), "=f"(d[16]), "=f"(d[17]), "=f"(d[18]), "=f"(d[19]), "=f"(d[20]), "=f"(d[21]), "=f"(d[22]), "=f"(d[23]), "=f"(d[24]), "=f"(d[25]), "=f"(d[26]), "=f"(d[27]), "=f"(d[28]), "=f"(d[29]), "=f"(d[30]), "=f"(d[31]), "=f"(d[32]), "=f"(d[33]), "=f"(d[34]), "=f"(d[35]), "=f"(d[36]), "=f"(d[37]), "=f"(d[38]), "=f"(d[39]), "=f"(d[40]), "=f"(d[41]), "=f"(d[42]), "=f"(d[43]), "=f"(d[44]), "=f"(d[45]), "=f"(d[46]), "=f"(d[47]), "=f"(d[48]), "=f"(d[49]), "=f"(d[50]), "=f"(d[51]), "=f"(d[52]), "=f"(d[53]), "=f"(d[54]), "=f"(d[55]), "=f"(d[56]), "=f"(d[57]), "=f"(d[58]), "=f"(d[59]), "=f"(d[60]), "=f"(d[61]), "=f"(d[62]), "=f"(d[63]), "=f"(d[64]), "=f"(d[65]), "=f"(d[66]), "=f"(d[67]), "=f"(d[68]), "=f"(d[69]), "=f"(d[70]), "=f"(d[71]), "=f"(d[72]), "=f"(d[73]), "=f"(d[74]), "=f"(d[75]), "=f"(d[76]), "=f"(d[77]), "=f"(d[78]), "=f"(d[79]), "=f"(d[80]), "=f"(d[81]), "=f"(d[82]), "=f"(d[83]), "=f"(d[84]), "=f"(d[85]), "=f"(d[86]), "=f"(d[87]), "=f"(d[88]), "=f"(d[89]), "=f"(d[90]), "=f"(d[91]), "=f"(d[92]), "=f"(d[93]), "=f"(d[94]), "=f"(d[95]), "=f"(d[96]), "=f"(d[97]), "=f"(d[98]), "=f"(d[99]), "=f"(d[100]), "=f"(d[101]), "=f"(d[102]), "=f"(d[103]), "=f"(d[104]), "=f"(d[105]), "=f"(d[106]), "=f"(d[107]), "=f"(d[108]), "=f"(d[109]), "=f"(d[110]), "=f"(d[111]), "=f"(d[112]), "=f"(d[113]), "=f"(d[114]), "=f"(d[115]), "=f"(d[116]), "=f"(d[117]), "=f"(d[118]), "=f"(d[119]), "=f"(d[120]), "=f"(d[121]), "=f"(d[122]), "=f"(d[123]), "=f"(d[124]), "=f"(d[125]), "=f"(d[126]), "=f"(d[127])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc)
        : "memory");
  } else {
    asm volatile(
        "{\n .reg .pred p;\n setp.ne.b32 p, 1, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
        "{%128, %129, %130, %131}, %132, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc)
        : "memory");
  }
}

__device__ __forceinline__ void fence_acc(float (&d)[128]) {
  asm volatile("" : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127]) :: "memory");
}

template <bool kStart>
__device__ __forceinline__ void wgmma_tf32(float (&d)[64], const uint32_t (&a)[4], uint64_t desc) {
  if (kStart) {
    asm volatile(
        "{\n .reg .pred p;\n setp.ne.b32 p, 0, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
        "{%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
        : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]), "=f"(d[4]), "=f"(d[5]), "=f"(d[6]), "=f"(d[7]), "=f"(d[8]), "=f"(d[9]), "=f"(d[10]), "=f"(d[11]), "=f"(d[12]), "=f"(d[13]), "=f"(d[14]), "=f"(d[15]), "=f"(d[16]), "=f"(d[17]), "=f"(d[18]), "=f"(d[19]), "=f"(d[20]), "=f"(d[21]), "=f"(d[22]), "=f"(d[23]), "=f"(d[24]), "=f"(d[25]), "=f"(d[26]), "=f"(d[27]), "=f"(d[28]), "=f"(d[29]), "=f"(d[30]), "=f"(d[31]), "=f"(d[32]), "=f"(d[33]), "=f"(d[34]), "=f"(d[35]), "=f"(d[36]), "=f"(d[37]), "=f"(d[38]), "=f"(d[39]), "=f"(d[40]), "=f"(d[41]), "=f"(d[42]), "=f"(d[43]), "=f"(d[44]), "=f"(d[45]), "=f"(d[46]), "=f"(d[47]), "=f"(d[48]), "=f"(d[49]), "=f"(d[50]), "=f"(d[51]), "=f"(d[52]), "=f"(d[53]), "=f"(d[54]), "=f"(d[55]), "=f"(d[56]), "=f"(d[57]), "=f"(d[58]), "=f"(d[59]), "=f"(d[60]), "=f"(d[61]), "=f"(d[62]), "=f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc)
        : "memory");
  } else {
    asm volatile(
        "{\n .reg .pred p;\n setp.ne.b32 p, 1, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
        "{%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc)
        : "memory");
  }
}

__device__ __forceinline__ void fence_acc(float (&d)[64]) {
  asm volatile("" : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]) :: "memory");
}

template <bool kStart>
__device__ __forceinline__ void wgmma_tf32(float (&d)[32], const uint32_t (&a)[4], uint64_t desc) {
  if (kStart) {
    asm volatile(
        "{\n .reg .pred p;\n setp.ne.b32 p, 0, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
        : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]), "=f"(d[4]), "=f"(d[5]), "=f"(d[6]), "=f"(d[7]), "=f"(d[8]), "=f"(d[9]), "=f"(d[10]), "=f"(d[11]), "=f"(d[12]), "=f"(d[13]), "=f"(d[14]), "=f"(d[15]), "=f"(d[16]), "=f"(d[17]), "=f"(d[18]), "=f"(d[19]), "=f"(d[20]), "=f"(d[21]), "=f"(d[22]), "=f"(d[23]), "=f"(d[24]), "=f"(d[25]), "=f"(d[26]), "=f"(d[27]), "=f"(d[28]), "=f"(d[29]), "=f"(d[30]), "=f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc)
        : "memory");
  } else {
    asm volatile(
        "{\n .reg .pred p;\n setp.ne.b32 p, 1, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc)
        : "memory");
  }
}

__device__ __forceinline__ void fence_acc(float (&d)[32]) {
  asm volatile("" : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]) :: "memory");
}

template <bool kStart>
__device__ __forceinline__ void wgmma_tf32(float (&d)[16], const uint32_t (&a)[4], uint64_t desc) {
  if (kStart) {
    asm volatile(
        "{\n .reg .pred p;\n setp.ne.b32 p, 0, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
        "{%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
        : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]), "=f"(d[4]), "=f"(d[5]), "=f"(d[6]), "=f"(d[7]), "=f"(d[8]), "=f"(d[9]), "=f"(d[10]), "=f"(d[11]), "=f"(d[12]), "=f"(d[13]), "=f"(d[14]), "=f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc)
        : "memory");
  } else {
    asm volatile(
        "{\n .reg .pred p;\n setp.ne.b32 p, 1, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
        "{%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc)
        : "memory");
  }
}

__device__ __forceinline__ void fence_acc(float (&d)[16]) {
  asm volatile("" : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]) :: "memory");
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// Wait until the phase of `bar` with this parity has completed. The loop
// lives inside the asm: a C++ loop around it is control flow the compiler
// must assume divergent, and it then serializes the in-flight wgmma groups.
// After 2^24 polls it traps: a copy that never lands must not hang the card.
__device__ __forceinline__ void mbar_wait(const uint64_t* bar, int parity) {
  asm volatile(
      "{\n"
      " .reg .pred p;\n"
      " .reg .u32 n;\n"
      " mov.u32 n, 0;\n"
      "WAIT:\n"
      " mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      " @p bra.uni DONE;\n"
      " add.u32 n, n, 1;\n"
      " setp.lt.u32 p, n, 16777216;\n"
      " @p bra.uni WAIT;\n"
      " trap;\n"
      "DONE:\n"
      "}\n" ::"r"(smem_addr(bar)), "r"(parity)
      : "memory");
}

// The ring of table chunks launch A streams, 16 KB each, in the order it
// consumes them: per pass the DFT table's k-steps, then the filterbank's
// k-steps for the pass's bins. Chunk q goes to slot q % n_slots by one bulk
// asynchronous copy (TMA without a tensor map: a chunk is contiguous),
// which completes on the slot's `full` mbarrier. The warp that releases a
// slot last refills it, so a warp waits only for its data, never for the
// other warps.
struct Ring {
  float* slots;
  uint64_t* full;  // per slot: one arrival (the filling thread) + the bytes
  int* released;   // per slot: warps done with its current chunk
  const float* table;
  int n_slots, n;

  // Issue chunk q into its slot (nothing past the last chunk). One thread.
  __device__ void fill(int q) const {
    if (q >= n) return;
    const int slot = q % n_slots;
    const uint32_t bar = smem_addr(full + slot);
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                 ::"r"(bar), "r"(4 * kSlotFloats) : "memory");
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1], %2, [%3];\n"
        ::"r"(smem_addr(slots + slot * kSlotFloats)), "l"(table + (size_t)q * kSlotFloats),
        "r"(4 * kSlotFloats), "r"(bar)
        : "memory");
  }

  // Chunk q, in `slot` and its `parity`-th use (q / n_slots), has landed.
  __device__ const float* wait(int slot, int parity) const {
    mbar_wait(full + slot, parity);
    return slots + slot * kSlotFloats;
  }

  // The calling warp is done with chunk q in `slot` (if `live`); the last
  // of the block's warps to say so refills the slot with chunk q + n_slots.
  // Lane 0 does the work under predicates, with no branch around it (see
  // mbar_wait).
  __device__ __forceinline__ void release(int q, int slot, bool live = true) const {
    __syncwarp();
    const int bytes = q + n_slots < n ? 4 * kSlotFloats : 0;
    const uint32_t bar = smem_addr(full + slot);
    asm volatile(
        "{\n"
        " .reg .pred p, last, go;\n"
        " .reg .u32 old;\n"
        " setp.ne.u32 p, %0, 0;\n"
        " @p membar.cta;\n"
        " @p atom.shared.add.u32 old, [%1], 1;\n"
        " setp.eq.and.u32 last, old, %6, p;\n"
        " @last atom.shared.exch.b32 old, [%1], 0;\n"
        " @last fence.proxy.async.shared::cta;\n"
        " setp.ne.and.u32 go, %5, 0, last;\n"
        " @go mbarrier.arrive.expect_tx.shared::cta.b64 _, [%2], %5;\n"
        " @go cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
        " [%3], [%4], %5, [%2];\n"
        "}\n" ::"r"((uint32_t)(live && (threadIdx.x & 31) == 0)),
        "r"(smem_addr(released + slot)), "r"(bar),
        "r"(smem_addr(slots + slot * kSlotFloats)), "l"(table + (size_t)(q + n_slots) * kSlotFloats),
        "r"(bytes), "r"(kWarpsA - 1)
        : "memory");
  }

  // Next chunk: advance slot, and the parity when the slot index wraps.
  __device__ static void next(int& q, int& slot, int& parity, int n_slots) {
    ++q;
    slot = slot + 1 == n_slots ? 0 : slot + 1;
    parity ^= slot == 0;
  }
};

// Launch C's ring (its GEMM plan): a row tile's `per` chunks, the same for
// every tile, run on from one tile to the next. q counts the tile's own
// chunks; the slots and their parities run on across tiles. The release of
// chunk q refills its slot with chunk q + n_slots of this tile or, past
// its last (`more`: another tile follows), with the next tile's chunk q +
// n_slots - per, so that the next tile's first chunks land while this one
// ends (n_slots <= per). The ring serves the MMA warps alone (kWarpsA of
// them): the band warps never touch it.
struct RingC : Ring {
  int per;
  bool more;

  __device__ __forceinline__ void release(int q, int slot, bool live = true) const {
    __syncwarp();
    const int r = q + n_slots, wrap = r >= per;
    const int bytes = !wrap || more ? 4 * kSlotFloats : 0;
    const uint32_t bar = smem_addr(full + slot);
    asm volatile(
        "{\n"
        " .reg .pred p, last, go;\n"
        " .reg .u32 old;\n"
        " setp.ne.u32 p, %0, 0;\n"
        " @p membar.cta;\n"
        " @p atom.shared.add.u32 old, [%1], 1;\n"
        " setp.eq.and.u32 last, old, %6, p;\n"
        " @last atom.shared.exch.b32 old, [%1], 0;\n"
        " @last fence.proxy.async.shared::cta;\n"
        " setp.ne.and.u32 go, %5, 0, last;\n"
        " @go mbarrier.arrive.expect_tx.shared::cta.b64 _, [%2], %5;\n"
        " @go cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
        " [%3], [%4], %5, [%2];\n"
        "}\n" ::"r"((uint32_t)(live && (threadIdx.x & 31) == 0)),
        "r"(smem_addr(released + slot)), "r"(bar),
        "r"(smem_addr(slots + slot * kSlotFloats)), "l"(table + (size_t)(wrap ? r - per : r) * kSlotFloats),
        "r"(bytes), "r"(kWarpsA - 1)
        : "memory");
  }
};

// Launch B's reductions over its block of 4 warps: warp_partial folds v
// across the warp by shuffles and lane 0 leaves it in slot[warp]; after a
// barrier, gather4 folds the four slots, in the same order in every
// thread, so that every thread gets the same result. Each reduction of a
// clip has slots of its own, so none needs a second barrier.
enum { kSum, kMax, kMin };

template <int kOp>
__device__ __forceinline__ float fold(float a, float b) {
  return kOp == kSum ? a + b : (kOp == kMax ? fmaxf(a, b) : fminf(a, b));
}

template <int kOp>
__device__ __forceinline__ void warp_partial(float v, float* slot) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = fold<kOp>(v, __shfl_xor_sync(0xffffffffu, v, off));
  if ((threadIdx.x & 31) == 0) slot[threadIdx.x >> 5] = v;
}

template <int kOp>
__device__ __forceinline__ float gather4(const float* slot) {
  return fold<kOp>(fold<kOp>(slot[0], slot[1]), fold<kOp>(slot[2], slot[3]));
}

// Every store of launch B's output goes through here (tools/epilogue_probe.py
// empties it to time the launch without them).
__device__ __forceinline__ void put(float* p, float v) { *p = v; }

// A clip's waveform as a row tile reads it: sample i of the tile
// (i = row * hop + tap) is the padded signal's sample base + i, reflected
// into [0, n_samples) (numpy "reflect": no edge repeat), pre-emphasized if
// use_pre (y[q] = x[q] - coef x[q - 1], y[0] = x[0], before the padding),
// and 0 from `live` on, past the tile's last frame. Launches A and C stage
// it (stage_span) or gather from it (DftPass<false>). Plain loads: read
// through the non-coherent path (__ldg) the staging took launch A from
// 0.98 to 1.76 ms at B = 4096 on an H100.
struct WaveSrc {
  const float* x;
  int n_samples, base, live, use_pre;
  float pre_coef;

  __device__ __forceinline__ float at(int i) const {
    int q = base + i;
    q = q < 0 ? -q : q;
    q = q >= n_samples ? 2 * (n_samples - 1) - q : q;
    float v = 0.0f;
    if (i < live && q >= 0 && q < n_samples) {
      v = x[q];
      if (use_pre && q > 0) v = __fsub_rn(v, __fmul_rn(pre_coef, x[q - 1]));
    }
    return v;
  }
};

// A row tile's span into shared memory, samples [0, len) of `src`, with
// LayoutA's `skew` pad floats after every hop samples; kStageBatch loads in
// flight a thread. Launch A (pre-emphasis as src says) and launch C (none).
__device__ void stage_span(float* span, const LayoutA& lay, const WaveSrc& src, int len, int hop) {
  const int tid = threadIdx.x;
  const int dseg = kThreadsA / hop, doff = kThreadsA % hop;
  int seg = tid / hop, off = tid % hop;  // sample i sits at seg * rs + off
  for (int i0 = tid; i0 < len; i0 += kStageBatch * kThreadsA) {
    float v[kStageBatch];
#pragma unroll
    for (int u = 0; u < kStageBatch; ++u) v[u] = src.at(i0 + u * kThreadsA);
#pragma unroll
    for (int u = 0; u < kStageBatch; ++u) {
      if (i0 + u * kThreadsA < len) span[seg * lay.rs + off] = v[u];
      seg += dseg;
      off += doff;
      if (off >= hop) {
        off -= hop;
        ++seg;
      }
    }
  }
}

// One DFT pass of a warpgroup: its 64 rows, all 256 columns of the pass, k-step by
// k-step through the ring, into acc. Per k-step the thread gathers and
// splits its A fragment (rows g and g + 8 of its warp's 16, taps 8s + t and
// 8s + t + 4 at span offsets k0 and k1: plus skew once per hop crossed, at
// most one a k-step for a hop of 8 or more; a shorter hop has no skew) and
// issues the three wgmma products as one group. One group stays in flight:
// step s waits for step s - 1's group, then releases its slot, so the
// gather of step s + 1 overlaps the MMAs of step s. The A registers alternate between two buffers (the loop
// runs by pairs of k-steps, so that the buffer index is a constant: kpad is
// a multiple of 16 taps). Pad rows are computed like the others; pad
// columns of the table are zeros. kStaged false: no span; the fragment's
// four values are gathered from `src` at row * hop + tap (row g, and g + 8
// at 8 hops on), and the loads of step s + 1 are in flight with step s's
// MMAs like the span's. R: the ring (launch C's GEMM plan: RingC), whose
// passes may start at a later k-step (run_from).
template <bool kStaged, class R = Ring>
struct DftPass {
  const R& ring;
  const LayoutA& lay;
  const float* r0;  // the thread's row g in the span (kStaged)
  WaveSrc src;      // the tile's waveform (not kStaged)
  int i0;           // row g's first sample in the tile (not kStaged)
  int hop, prev_slot, k0, k1, next0, next1;
  float acc[128];
  uint32_t a_hi[2][4], a_lo[2][4];

  __device__ DftPass(const R& ring_, const LayoutA& lay_, const float* r0_, int hop_)
      : ring(ring_), lay(lay_), r0(r0_), hop(hop_) {}

  // kFrom: a pass from a later k-step (run_from), whose first step is
  // kStart (run's first step is s = 0).
  template <int kBuf, bool kStart, bool kFrom = false>
  __device__ __forceinline__ void step(int s, int& q, int& slot, int& parity) {
    if constexpr (kStaged) {
      split_tf32(r0[k0], a_hi[kBuf][0], a_lo[kBuf][0]);
      split_tf32(r0[8 * lay.rs + k0], a_hi[kBuf][1], a_lo[kBuf][1]);
      split_tf32(r0[k1], a_hi[kBuf][2], a_lo[kBuf][2]);
      split_tf32(r0[8 * lay.rs + k1], a_hi[kBuf][3], a_lo[kBuf][3]);
    } else {
      const int i = i0 + 8 * s + (threadIdx.x & 3);
      split_tf32(src.at(i), a_hi[kBuf][0], a_lo[kBuf][0]);
      split_tf32(src.at(i + 8 * hop), a_hi[kBuf][1], a_lo[kBuf][1]);
      split_tf32(src.at(i + 4), a_hi[kBuf][2], a_lo[kBuf][2]);
      split_tf32(src.at(i + 8 * hop + 4), a_hi[kBuf][3], a_lo[kBuf][3]);
    }
    const float* b = ring.wait(slot, parity);  // hi tile, then lo tile
    if (!kStart) fence_acc(acc);
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
    wgmma_tf32<kStart>(acc, a_lo[kBuf], b_desc(b));                  // lo * hi
    wgmma_tf32<false>(acc, a_hi[kBuf], b_desc(b + kSlotFloats / 2));  // hi * lo
    wgmma_tf32<false>(acc, a_hi[kBuf], b_desc(b));                    // hi * hi
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
    fence_acc(acc);
    ring.release(q - 1, prev_slot, kFrom ? !kStart : s > 0);  // step s - 1's group is done
    prev_slot = slot;
    Ring::next(q, slot, parity, ring.n_slots);
    if constexpr (kStaged) {
      const int kk = 8 * (s + 1) + (threadIdx.x & 3);  // the next k-step's taps
      const bool cross0 = kk >= next0, cross1 = kk + 4 >= next1;
      k0 += 8 + (cross0 ? lay.skew : 0);
      k1 += 8 + (cross1 ? lay.skew : 0);
      next0 += cross0 ? hop : 0;
      next1 += cross1 ? hop : 0;
    }
  }

  __device__ void run(int& q, int& slot, int& parity, int n_ksteps) {
    const int t = threadIdx.x & 3;
    k0 = t;
    k1 = t + 4;
    next0 = next1 = hop;
    step<0, true>(0, q, slot, parity);
    step<1, false>(1, q, slot, parity);
    for (int s = 2; s < n_ksteps; s += 2) {  // n_ksteps is even
      step<0, false>(s, q, slot, parity);
      step<1, false>(s + 1, q, slot, parity);
    }
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    fence_acc(acc);
    ring.release(q - 1, prev_slot);
  }

  // A pass over k-steps [s0, s0 + n_ksteps) (n_ksteps even): run's, its
  // span offsets starting at tap 8 s0 + t.
  __device__ void run_from(int& q, int& slot, int& parity, int s0, int n_ksteps) {
    const int a = 8 * s0 + (threadIdx.x & 3), b = a + 4;
    k0 = a + a / hop * lay.skew;
    k1 = b + b / hop * lay.skew;
    next0 = (a / hop + 1) * hop;
    next1 = (b / hop + 1) * hop;
    step<0, true, true>(s0, q, slot, parity);
    step<1, false, true>(s0 + 1, q, slot, parity);
    for (int s = s0 + 2; s < s0 + n_ksteps; s += 2) {
      step<0, false, true>(s, q, slot, parity);
      step<1, false, true>(s + 1, q, slot, parity);
    }
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    fence_acc(acc);
    ring.release(q - 1, prev_slot);
  }
};

// The mel of one pass's 128 bins, added into macc (the warpgroup's 64 x kN
// fragment; the first pass starts it). The DFT's accumulator already is the mel's A operand: for
// mel k-step s (bins 8s to 8s + 7 of the pass) the thread's fragment,
// bins 8s + t and 8s + t + 4 of rows g and g + 8, is the power of the
// DFT's n-tiles 2s and 2s + 1, which the thread holds. So the power never
// leaves registers: it is formed, split, and fed to three wgmma products a
// k-step, the filterbank's tiles (16 k-steps, 256 / kN a ring slot)
// streaming through the ring like the DFT table.
template <int kN, bool kFirst>
__device__ __forceinline__ void mel_pass(const Ring& ring, int& q, int& slot, int& parity,
                                         const float (&d)[128], float (&macc)[kN / 2]) {
  constexpr int kKs = 256 / kN;  // mel k-steps a slot
  uint32_t p_hi[16][4], p_lo[16][4];
#pragma unroll
  for (int s = 0; s < 16; ++s)
#pragma unroll
    for (int x = 0; x < 4; ++x)  // n-tile 2s + x / 2, row g + 8 * (x % 2)
      split_tf32(d[8 * s + 2 * x] * d[8 * s + 2 * x] + d[8 * s + 2 * x + 1] * d[8 * s + 2 * x + 1],
                 p_hi[s][x], p_lo[s][x]);
  int prev_slot = slot;
#pragma unroll
  for (int c = 0; c < 16 / kKs; ++c) {
    const float* b = ring.wait(slot, parity);
    if (!kFirst || c > 0) fence_acc(macc);
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int sl = 0; sl < kKs; ++sl) {
      const int s = c * kKs + sl;
      const float* hi = b + sl * 16 * kN;  // hi tile, then lo tile
      if (kFirst && s == 0)
        wgmma_tf32<true>(macc, p_lo[s], b_desc(hi));
      else
        wgmma_tf32<false>(macc, p_lo[s], b_desc(hi));
      wgmma_tf32<false>(macc, p_hi[s], b_desc(hi + 8 * kN));
      wgmma_tf32<false>(macc, p_hi[s], b_desc(hi));
    }
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
    fence_acc(macc);
    ring.release(q - 1, prev_slot, c > 0);
    prev_slot = slot;
    Ring::next(q, slot, parity, ring.n_slots);
  }
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
  fence_acc(macc);
  ring.release(q - 1, prev_slot);
}

// Launch A. grid (batch x row tiles x mel groups): block i takes clip
// i / (tiles * n_groups), its row tile i % tiles and its mel group
// i % (tiles * n_groups) / tiles, all folded into grid x, which holds
// 2^31 - 1 blocks where grid y holds 65,535 (ops/frontend_kernel.py's
// spectral_grid and spectral_block mirror it); kThreadsA threads,
// LayoutA's shared memory with n_slots ring slots. table: the chunk stream
// the ring reads (ops/frontend_kernel.py::_constants), per mel group and
// pass kpad / 8 DFT chunks and kMelNT / 2 filterbank chunks; n_bins is
// n_used rounded up to 8, kpad the window's support rounded up to 16 taps;
// kMelNT a mel group's width in n-tiles of 8 (4, 8 or 16), zero past
// n_mels. More than 128 mels take groups of at most 128, each its own
// blocks, which run the group's DFT passes again: a thread's accumulators
// (128 DFT floats, kMelNT * 4 mel floats) stay in registers. kStaged:
// whether the tile's span fits shared memory (staged_a), else DftPass
// gathers from device memory.
template <int kMelNT, bool kStaged>
__global__ void __launch_bounds__(kThreadsA, 1) spectral_kernel(
    const float* __restrict__ wave, int n_samples, int n_frames, int n_fft,
    int hop, int j0, int kpad, const float* __restrict__ table, int n_bins,
    int n_mels, int n_groups, int use_pre, float pre_coef, int n_slots,
    float* __restrict__ mel_out) {
  constexpr int kN = 8 * kMelNT;
  extern __shared__ float4 smem4[];
  const LayoutA lay(hop, kpad, kStaged);
  float* slots = reinterpret_cast<float*>(smem4);
  float* span = slots + n_slots * kSlotFloats;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int tiles = (n_frames + kRows - 1) / kRows, per_clip = tiles * n_groups;
  const int b = blockIdx.x / per_clip, t0 = (blockIdx.x % tiles) * kRows;
  const int grp = blockIdx.x % per_clip / tiles;
  const int n_ksteps = kpad / 8;
  const int n_passes = (2 * n_bins + kPassCols - 1) / kPassCols;
  Ring ring;
  ring.slots = slots;
  ring.full = reinterpret_cast<uint64_t*>(span + lay.span);
  ring.released = reinterpret_cast<int*>(ring.full + kMaxSlots);
  ring.n_slots = n_slots;
  ring.n = n_passes * (n_ksteps + kN / 16);
  ring.table = table + (size_t)grp * ring.n * kSlotFloats;

  // 1. Start the ring, then stage the span while the first chunks land:
  // reflect padding and pre-emphasis, zeros after the tile's frames.
  if (tid == 0) {
    for (int i = 0; i < n_slots; ++i) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(ring.full + i))
                   : "memory");
      ring.released[i] = 0;
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int q = 0; q < n_slots; ++q) ring.fill(q);
  }
  WaveSrc src;
  src.x = wave + (size_t)b * n_samples;
  src.n_samples = n_samples;
  src.base = t0 * hop + j0 - n_fft / 2;
  src.live = (min(n_frames - t0, kRows) - 1) * hop + kpad;
  src.use_pre = use_pre;
  src.pre_coef = pre_coef;
  if (kStaged) stage_span(span, lay, src, (kRows - 1) * hop + kpad, hop);
  __syncthreads();  // the span and the ring's barriers are ready

  // 2. Pass by pass: the DFT, then its bins' mel. Warpgroup w / 4 owns rows
  // 64 * (w / 4) + [0, 64); the thread, rows `row` and row + 8.
  const int row = 64 * (warp / 4) + 16 * (warp & 3) + g;
  int q = 0, slot = 0, parity = 0;  // the next chunk, its slot and parity
  float macc[kN / 2];
  DftPass<kStaged> dft(ring, lay, span + row * lay.rs, hop);
  dft.src = src;
  dft.i0 = row * hop;
  dft.run(q, slot, parity, n_ksteps);
  mel_pass<kN, true>(ring, q, slot, parity, dft.acc, macc);
  for (int p = 1; p < n_passes; ++p) {
    dft.run(q, slot, parity, n_ksteps);
    mel_pass<kN, false>(ring, q, slot, parity, dft.acc, macc);
  }

  // 3. The group's mels, (B, n_mels, n_frames), frames fastest.
  const int m0 = grp * kN;
  float* out = mel_out + ((size_t)b * n_mels + m0) * n_frames;
  const int r0 = t0 + row, r1 = r0 + 8;
#pragma unroll
  for (int j = 0; j < kMelNT; ++j) {
    const int m = 8 * j + 2 * t;
    for (int h = 0; h < 2; ++h) {
      if (m0 + m + h >= n_mels) continue;
      if (r0 < n_frames) out[(size_t)(m + h) * n_frames + r0] = macc[4 * j + h];
      if (r1 < n_frames) out[(size_t)(m + h) * n_frames + r1] = macc[4 * j + 2 + h];
    }
  }
}

// Launch B: the epilogue, FP32 on the CUDA cores.
//  * Replaces the Pallas kernel's steps 4-7 (_kernel, frontend_kernel.py
//    :152-205): log-mel; the dB branch (clamp to the clip's max - 80,
//    (db + 80) / 80 in [0, 1]) or the PCEN branch (10-tap zero-padded
//    smoother, compressive formula, per-clip min-max); the X6 DCT-II of the
//    log-mel; the unbiased per-clip z-norm of the MFCCs; replicate-padded
//    deltas and optional delta-deltas; the stack, written as (B, F, T).
//  * Bound: bytes. A clip of the shipped config is 25.9 KB of power mel in
//    and 36.4 KB of features out, against 0.17 MFLOP of DCT: 0.0761 ms at
//    B = 4096 at 3.35 TB/s.
//  * The first design (one 256-thread block a clip, loops over (feature,
//    time) pairs; 0.257 ms at B = 4096 on an H100, 30% of the bound) was
//    held back by three things. Shared memory set its occupancy: the raw
//    mel, log-mel, MFCC and delta tiles took 62 KB at the shipped config,
//    3 blocks an SM, one at n_fft 256. Each MFCC was a 64-long chain of
//    dependent FMAs, each behind a shared load and a global one. And a clip
//    took 11-12 barriers, three in each block reduction, with no other
//    clip's loads in flight to cover them.
//  * What lost to this design on the card (tools/epilogue_probe.py,
//    PERF.md): each thread sweeping its frames' mel from device memory, and
//    again for the dB rows (the loads' latency in every thread's way); one
//    bulk asynchronous copy of the clip instead of plain loads; the DCT
//    table read from L1 under a 64-register cap.
//  * This design. A block of 128 threads (4 warps) takes one clip and holds
//    it in one shared tile (M x T). It loads the clip flat, every lane busy
//    (101 frames would fill 128 lanes only 79%), kLoadB coalesced loads in
//    flight a thread; the dB branch stores the log-mel and takes the clip's
//    max as it goes, then writes the dB rows flat from the tile. Then the
//    DCT, frames across threads: thread i owns frames i, i + 128, ..., and
//    per mel row reads one log-mel (conflict-free) and the DCT row as
//    float4s from shared memory at one address across the warp (a
//    broadcast) into kc independent register accumulators, in the order the
//    first design added them. MFCCs past 32 take another pass.
//  * From the DCT on, a thread reads only its own frames' column of the
//    tile, so the MFCCs (C x T) overwrite the tile's first C rows, and the
//    deltas the next C, where they fit (C <= 32, 2C <= M): at the shipped
//    config shared memory is the tile and the DCT table, 30,080 B, 7 blocks
//    (28 warps) an SM; 119,424 B at 128 mels x 201 frames x 20 MFCCs.
//  * PCEN (a template parameter) keeps the raw mel in the tile for its
//    smoother, writes its values before the min-max and rescales them
//    after, each thread its own, and takes the log in the DCT pass.
//  * Reductions (clip max, PCEN's min and max, the MFCCs' sum, the sum of
//    squared deviations: the reference's two-pass unbiased form) are warp
//    shuffles and one 4-value exchange in shared memory, one barrier each;
//    with the barrier before the DCT and the one before the deltas, a clip
//    of the shipped config takes 5 barriers.
//  * Numerics as the reference's, except (db + 80) / 80, taken as a
//    multiply by 1/80: a unit in the last place at most.
//  * A clip whose tile passes one block's shared memory runs as a cluster
//    (epilogue_cluster_kernel, plan_b). Past a cluster of kMaxCluster
//    blocks, kGlobal: the same steps with nothing of the clip in shared
//    memory. The tile is the power mel where it lies in device memory (the
//    log taken where it is read, twice in the dB branch), the MFCC and
//    delta tiles are their own rows of the output, rewritten in place.
template <bool kPcen, int kC, bool kGlobal>
__global__ void __launch_bounds__(kThreadsB, 7) epilogue_kernel(
    const float* __restrict__ mel, int n_frames, int n_mels,
    const float* __restrict__ dct, int n_mfcc, int delta_delta,
    int n_features, float* __restrict__ out) {
  extern __shared__ float4 smem4[];
  const int T = n_frames, M = n_mels, C = n_mfcc, nm = M * T, nc = C * T;
  const LayoutB lay(T, M, C, delta_delta);
  float* red = reinterpret_cast<float*>(smem4);  // slots: 0 max, 4 min, 8 max, 12 sum, 16 squares
  const int tid = threadIdx.x;
  const float* src = mel + (size_t)blockIdx.x * nm;
  float* o = out + (size_t)blockIdx.x * n_features * T;
  float* dct_s = red + kRedB;                    // (M, cp)
  float* tile = red + lay.tile;                  // (M, T): the power mel; in the dB branch its log
  float* mf_s = kGlobal ? o + nm : red + lay.mf;       // (C, T)
  float* d1_s = kGlobal ? o + nm + nc : red + lay.d1;  // (C, T), with delta-deltas
  // The log-mel at flat index i of the clip, from the tile or (kGlobal) the power mel.
  auto log_mel = [&](int i) {
    if constexpr (kGlobal)
      return kDbScale * logf(fmaxf(__ldg(src + i), kAmin));
    else
      return kPcen ? kDbScale * logf(fmaxf(tile[i], kAmin)) : tile[i];
  };

  // 1. The DCT table, and the clip into the tile, flat; in the dB branch
  // as its log-mel, with the clip's max.
  float mx = -INFINITY;
  if constexpr (kGlobal) {
    if (!kPcen)
      for (int i = tid; i < nm; i += kThreadsB) mx = fmaxf(mx, log_mel(i));
  } else {
    for (int i = tid; i < M * lay.cp; i += kThreadsB) {
      const int m = i / lay.cp, c = i % lay.cp;
      dct_s[i] = c < C ? __ldg(dct + m * C + c) : 0.0f;
    }
    for (int i0 = tid; i0 < nm; i0 += kLoadB * kThreadsB) {
      float v[kLoadB];
#pragma unroll
      for (int u = 0; u < kLoadB; ++u) {
        const int i = i0 + u * kThreadsB;
        v[u] = i < nm ? __ldg(src + i) : 1.0f;
      }
#pragma unroll
      for (int u = 0; u < kLoadB; ++u) {
        const int i = i0 + u * kThreadsB;
        if (i >= nm) break;
        if (kPcen) {
          tile[i] = v[u];
        } else {
          const float lm = kDbScale * logf(fmaxf(v[u], kAmin));
          tile[i] = lm;
          mx = fmaxf(mx, lm);
        }
      }
    }
  }
  if (!kPcen) warp_partial<kMax>(mx, red);
  __syncthreads();

  // 2. Rows [0, M). The dB branch: clamped to the clip's max - 80, flat.
  // The PCEN branch: the smoother's ten taps in the order the JAX kernel
  // adds them, out-of-clip taps counted as zeros.
  float lo = INFINITY, hi = -INFINITY;
  if (!kPcen) {
    const float floor_db = gather4<kMax>(red) - 80.0f;
    for (int i = tid; i < nm; i += kThreadsB) {
      const float db = fmaxf(log_mel(i), floor_db);
      put(o + i, fminf(fmaxf((db + 80.0f) * 0.0125f, 0.0f), 1.0f));
    }
  } else {
    const float* raw = kGlobal ? src : tile;
    for (int t = tid; t < T; t += kThreadsB) {
      for (int m = 0; m < M; ++m) {
        const float* row = raw + m * T;
        float s = 0.0f;
#pragma unroll
        for (int d = 0; d < 10; ++d) {
          const int tt = t + d - 5;
          if (tt >= 0 && tt < T) s += row[tt];
        }
        s = s / 10.0f;
        const float p = sqrtf(row[t] / powf(1e-6f + s, 0.98f) + 2.0f) - 1.41421356237f;
        put(o + (size_t)m * T + t, p);
        lo = fminf(lo, p);
        hi = fmaxf(hi, p);
      }
    }
    warp_partial<kMin>(lo, red + 4);
    warp_partial<kMax>(hi, red + 8);
  }
  __syncthreads();  // no thread reads another's frames after this

  // 3. The DCT, frames across threads.
  float sum = 0.0f;
  for (int t = tid; t < T; t += kThreadsB) {
    for (int c0 = 0; c0 < C; c0 += kC) {
      float acc[kC];
#pragma unroll
      for (int c = 0; c < kC; ++c) acc[c] = 0.0f;
      if constexpr (kGlobal) {
        for (int m = 0; m < M; ++m) {
          const float lm = log_mel(m * T + t);
#pragma unroll
          for (int c = 0; c < kC; ++c)
            if (c0 + c < C) acc[c] = fmaf(lm, __ldg(dct + m * C + c0 + c), acc[c]);
        }
      } else {
#pragma unroll 4
        for (int m = 0; m < M; ++m) {
          const float lm = log_mel(m * T + t);
          const float4* w = reinterpret_cast<const float4*>(dct_s + m * lay.cp + c0);
#pragma unroll
          for (int q = 0; q < kC / 4; ++q) {
            const float4 d = w[q];
            acc[4 * q] = fmaf(lm, d.x, acc[4 * q]);
            acc[4 * q + 1] = fmaf(lm, d.y, acc[4 * q + 1]);
            acc[4 * q + 2] = fmaf(lm, d.z, acc[4 * q + 2]);
            acc[4 * q + 3] = fmaf(lm, d.w, acc[4 * q + 3]);
          }
        }
      }
#pragma unroll
      for (int c = 0; c < kC; ++c) {
        if (c0 + c < C) {
          mf_s[(c0 + c) * T + t] = acc[c];
          sum += acc[c];
        }
      }
    }
  }
  warp_partial<kSum>(sum, red + 12);
  __syncthreads();
  const float mean = gather4<kSum>(red + 12) / (float)nc;

  if (kPcen) {  // rescale this thread's PCEN values
    lo = gather4<kMin>(red + 4);
    hi = gather4<kMax>(red + 8);
    for (int t = tid; t < T; t += kThreadsB)
      for (int m = 0; m < M; ++m) {
        float* p = o + (size_t)m * T + t;
        put(p, (*p - lo) / (hi - lo + 1e-8f));
      }
  }

  // 4. The MFCCs' z-norm (unbiased), flat: rows [M, M + C).
  float sq = 0.0f;
  for (int i = tid; i < nc; i += kThreadsB) {
    const float dv = mf_s[i] - mean;
    sq += dv * dv;
  }
  warp_partial<kSum>(sq, red + 16);
  __syncthreads();
  const float denom = sqrtf(gather4<kSum>(red + 16) / (float)(nc - 1)) + 1e-8f;
  float* o_mf = o + (size_t)nm;
  for (int i = tid; i < nc; i += kThreadsB) {
    const float z = (mf_s[i] - mean) / denom;
    mf_s[i] = z;
    put(o_mf + i, z);
  }
  __syncthreads();

  // 5. Deltas, rows [M + C, M + 2C), and delta-deltas, [M + 2C, M + 3C):
  // replicate-padded central differences along time, flat over (c, t).
  for (int i = tid, c = tid / T, t = tid % T; i < nc; i += kThreadsB) {
    const float* row = mf_s + c * T;
    const float d = (row[min(t + 1, T - 1)] - row[max(t - 1, 0)]) / 2.0f;
    put(o_mf + nc + i, d);
    if (delta_delta && !kGlobal) d1_s[i] = d;
    for (t += kThreadsB; t >= T; t -= T) ++c;
  }
  if (delta_delta) {
    __syncthreads();
    for (int i = tid, c = tid / T, t = tid % T; i < nc; i += kThreadsB) {
      const float* row = d1_s + c * T;
      put(o_mf + 2 * nc + i, (row[min(t + 1, T - 1)] - row[max(t - 1, 0)]) / 2.0f);
      for (t += kThreadsB; t >= T; t -= T) ++c;
    }
  }
}

// Launch B over a thread-block cluster, for a clip whose M x T tile passes
// one block's shared memory (5 s at 128 mels: 265 KB; 10 s at 64 mels;
// hop 4: 1 MB). The steps and numerics are epilogue_kernel's; only the
// per-clip reductions cross the blocks.
//  * Bound: bytes, as one block's (the power mel read once, the features
//    written once): 0.1885 ms for 10 s clips at B = 1024, 0.1727 for 5 s
//    at 128 mels (3.35 TB/s). The DCT is 2.1 GFLOP there, 0.03 ms at the
//    FP32 peak.
//  * The first design (the fewest blocks that fit, 128 threads,
//    up to 209 KB each) read 11% of the bound, 1.72 ms on 10 s clips: one
//    4-warp block an SM, one load in flight a thread, a division an
//    element, 5-7 cluster barriers a clip with nothing beside them to fill
//    the wait, and every delta's neighbours read through a rank test.
//  * Occupancy. plan_b takes, for k = kBlocksSM (3), then 2, then 1, the
//    fewest blocks (2 to kMaxCluster) whose share fits k blocks an SM: at
//    10 s 4 blocks of 251 frames, 69 KB each, 24 warps an SM; blocks of
//    256 threads (kThreadsBC). Past 8 blocks the cluster is non-portable
//    (cudaFuncAttributeNonPortableClusterSizeAllowed; an H100 takes 16): a
//    hop of 4 runs 15 blocks three an SM, 0.53 ms at B = 256 against 0.74
//    on 5 blocks one an SM; 60 s at 128 mels with PCEN 15 blocks one an SM,
//    1.56 ms at B = 64 against 10.8 in device memory. At most two blocks
//    an SM read 0.52 ms at 10 s, four (registers capped at 64) 0.45, three
//    0.43 (tools/epilogue_probe.py, NVIDIA H100).
//  * Halo. Rank r holds frames [r Tb, r Tb + Tb) and `halo` frames
//    (halo_b) more on each side, loaded from device memory as its own are
//    (zeros past the clip). So PCEN's smoother, the deltas and the
//    delta-deltas read only the block's own tile: the block runs the DCT
//    and the z-norm over the hd = 1 + delta_delta frames beside its own
//    too (the same arithmetic as the rank that owns them, so the same
//    bits), and no frame crosses the cluster.
//  * Loads: the tile (M rows of the block's columns, each contiguous at a
//    stride of T, odd on every cluster config, so no 16-byte copies) flat
//    over (row, column), kLoadB coalesced loads in flight a thread. Every
//    flat loop steps its (row, column) by the block's threads with no
//    division past the first (each_b); stores stay coalesced.
//  * Reductions. Each warp folds its partial by shuffles into the block's
//    slots; after a block barrier, thread k of each block folds the 8 warp
//    partials and writes the block's into rank k's slots (distributed
//    shared memory); after one cluster barrier every thread folds the n
//    ranks' partials, rank by rank, so every rank holds the same value.
//    The dB branch takes the clip max, then the MFCCs' sum, then their
//    squared deviations: 3 cluster barriers a clip. PCEN's min and max go
//    with the sum (its log-mel is taken in the DCT, its outputs rescaled
//    after): 2. Three blocks an SM fill one block's wait. Nothing is read
//    from another rank, and every write into one comes before a barrier
//    its owner waits at, so a block exits after its last barrier with no
//    barrier at its end; an arrive at the start, waited on before the
//    first write, makes sure every rank has started.
// The sums run in another order than one block's (a block's warps, then
// the ranks): within float rounding of it.

// Calls f(r, c) for every r in [0, rows), c in [c0, c1) that this thread
// of a kThreadsBC-thread block takes: flat, the block's threads on
// consecutive columns, with no division past the first.
template <class F>
__device__ __forceinline__ void each_b(int rows, int c0, int c1, F f) {
  const int cols = c1 - c0;
  if (cols <= 0) return;
  int r = (int)threadIdx.x / cols, c = (int)threadIdx.x - r * cols;
  const int dr = kThreadsBC / cols, dc = kThreadsBC - dr * cols;
  while (r < rows) {
    f(r, c0 + c);
    r += dr;
    c += dc;
    if (c >= cols) {
      c -= cols;
      ++r;
    }
  }
}

// Every thread of every block of the cluster arrives (release) and waits
// (acquire).
__device__ __forceinline__ void cluster_sync_b() {
  asm volatile("barrier.cluster.arrive.aligned;\n barrier.cluster.wait.aligned;\n" ::: "memory");
}

// Reduction q of the cluster route: thread k < n folds the block's warp
// partials at red[kWarpsBC q ...] in warp order and writes the block's
// into rank k's slot red[kRanksBC + kMaxCluster q + rank]. After a block
// barrier, before a cluster barrier.
template <int kOp>
__device__ __forceinline__ void push_b(float* red, int q, int n, int rank) {
  if ((int)threadIdx.x < n) {
    const float* w = red + kWarpsBC * q;
    float v = w[0];
#pragma unroll
    for (int i = 1; i < kWarpsBC; ++i) v = fold<kOp>(v, w[i]);
    cooperative_groups::this_cluster().map_shared_rank(red, (unsigned)threadIdx.x)[kRanksBC + kMaxCluster * q + rank] = v;
  }
}

// Reduction q's value over the clip, after the cluster barrier: the n
// ranks' partials, rank by rank.
template <int kOp>
__device__ __forceinline__ float total_b(const float* red, int q, int n) {
  const float* r = red + kRanksBC + kMaxCluster * q;
  float v = r[0];
  for (int k = 1; k < n; ++k) v = fold<kOp>(v, r[k]);
  return v;
}

template <bool kPcen, int kC>
__global__ void __launch_bounds__(kThreadsBC, 3) epilogue_cluster_kernel(
    const float* __restrict__ mel, int n_frames, int n_mels,
    const float* __restrict__ dct, int n_mfcc, int delta_delta,
    int n_features, float* __restrict__ out) {
  extern __shared__ float4 smem4[];
  // Every rank has started before any writes into another's slots: this
  // arrive is waited on before the first write.
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
  const int n = (int)cooperative_groups::this_cluster().num_blocks();
  const int rank = (int)cooperative_groups::this_cluster().block_rank();
  const int T = n_frames, M = n_mels, C = n_mfcc, nc = C * T;
  const int H = halo_b(kPcen, delta_delta), hd = 1 + delta_delta;
  const int Tb = (T + n - 1) / n, f0 = rank * Tb, nf = max(0, min(T - f0, Tb));
  const LayoutB lay(Tb, M, C, delta_delta, H, kRedBC);
  const int W = lay.cols, g0 = f0 - H;  // tile column j holds frame g0 + j
  // Columns: the block's own frames [a0, a1); the DCT's and the z-norm's,
  // hd more each side within the clip, [e0, e1).
  const int a0 = H, a1 = H + nf;
  const int e0 = max(a0 - hd, -g0), e1 = min(a1 + hd, T - g0);
  float* red = reinterpret_cast<float*>(smem4);  // warp slots: 0 max, 1 min, 2 max, 3 sum, 4 squares
  float* dct_s = red + kRedBC;                   // (M, cp)
  float* tile = red + lay.tile;                  // (M, W): the power mel; in the dB branch its log
  float* mf_s = red + lay.mf;                    // (C, W)
  float* d1_s = red + lay.d1;                    // (C, W), with delta-deltas
  const int tid = threadIdx.x;
  const int clip = blockIdx.x / n;
  const float* src = mel + (size_t)clip * M * T;
  float* o = out + (size_t)clip * n_features * T;
  float* o_mf = o + (size_t)M * T;

  // 1. The DCT table, and the block's columns into the tile; in the dB
  // branch as their log-mel, with their max. The halo's frames are the
  // clip's too, and a column past the clip holds the log of kAmin, the
  // least a log-mel can be: neither moves the clip's max.
  for (int i = tid; i < M * lay.cp; i += kThreadsBC) {
    const int m = i / lay.cp, c = i % lay.cp;
    dct_s[i] = c < C ? __ldg(dct + m * C + c) : 0.0f;
  }
  float mx = -INFINITY;
  {
    int r = tid / W, c = tid - r * W;
    const int dr = kThreadsBC / W, dc = kThreadsBC - dr * W;
    while (r < M) {
      float v[kLoadB];
      int at[kLoadB];
#pragma unroll
      for (int u = 0; u < kLoadB; ++u) {
        const int t = g0 + c;
        at[u] = r < M ? r * W + c : -1;
        v[u] = r < M && t >= 0 && t < T ? __ldg(src + (size_t)r * T + t) : 0.0f;
        r += dr;
        c += dc;
        if (c >= W) {
          c -= W;
          ++r;
        }
      }
#pragma unroll
      for (int u = 0; u < kLoadB; ++u) {
        if (at[u] < 0) break;
        if (kPcen) {
          tile[at[u]] = v[u];
        } else {
          const float lm = kDbScale * logf(fmaxf(v[u], kAmin));
          tile[at[u]] = lm;
          mx = fmaxf(mx, lm);
        }
      }
    }
  }
  float lo = INFINITY, hi = -INFINITY;
  if (!kPcen) {
    warp_partial<kMax>(mx, red);
    __syncthreads();
    asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
    push_b<kMax>(red, 0, n, rank);
    cluster_sync_b();
    // 2. The dB rows of the block's frames.
    const float floor_db = total_b<kMax>(red, 0, n) - 80.0f;
    each_b(M, a0, a1, [&](int m, int j) {
      const float db = fmaxf(tile[m * W + j], floor_db);
      put(o + (size_t)m * T + g0 + j, fminf(fmaxf((db + 80.0f) * 0.0125f, 0.0f), 1.0f));
    });
  } else {
    __syncthreads();
    // 2. PCEN of the block's frames: the smoother's ten taps in the order
    // the JAX kernel adds them, a tap past the clip a zero column.
    each_b(M, a0, a1, [&](int m, int j) {
      const float* row = tile + m * W + j - 5;
      float s = 0.0f;
#pragma unroll
      for (int d = 0; d < 10; ++d) s += row[d];
      s = s / 10.0f;
      const float p = sqrtf(row[5] / powf(1e-6f + s, 0.98f) + 2.0f) - 1.41421356237f;
      put(o + (size_t)m * T + g0 + j, p);
      lo = fminf(lo, p);
      hi = fmaxf(hi, p);
    });
    warp_partial<kMin>(lo, red + kWarpsBC);
    warp_partial<kMax>(hi, red + 2 * kWarpsBC);
  }
  __syncthreads();  // no thread reads another's column of the tile after this

  // 3. The DCT, a column a thread, over the block's frames and hd beside
  // them; the sum over its own.
  float sum = 0.0f;
  for (int j = e0 + tid; j < e1; j += kThreadsBC) {
    const bool own = j >= a0 && j < a1;
    for (int c0 = 0; c0 < C; c0 += kC) {
      float acc[kC];
#pragma unroll
      for (int c = 0; c < kC; ++c) acc[c] = 0.0f;
#pragma unroll 4
      for (int m = 0; m < M; ++m) {
        const float v = tile[m * W + j];
        const float lm = kPcen ? kDbScale * logf(fmaxf(v, kAmin)) : v;
        const float4* w = reinterpret_cast<const float4*>(dct_s + m * lay.cp + c0);
#pragma unroll
        for (int q = 0; q < kC / 4; ++q) {
          const float4 d = w[q];
          acc[4 * q] = fmaf(lm, d.x, acc[4 * q]);
          acc[4 * q + 1] = fmaf(lm, d.y, acc[4 * q + 1]);
          acc[4 * q + 2] = fmaf(lm, d.z, acc[4 * q + 2]);
          acc[4 * q + 3] = fmaf(lm, d.w, acc[4 * q + 3]);
        }
      }
#pragma unroll
      for (int c = 0; c < kC; ++c) {
        if (c0 + c < C) {
          mf_s[(c0 + c) * W + j] = acc[c];
          if (own) sum += acc[c];
        }
      }
    }
  }
  warp_partial<kSum>(sum, red + 3 * kWarpsBC);
  __syncthreads();
  if (kPcen) {
    asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
    push_b<kMin>(red, 1, n, rank);
    push_b<kMax>(red, 2, n, rank);
  }
  push_b<kSum>(red, 3, n, rank);
  cluster_sync_b();
  const float mean = total_b<kSum>(red, 3, n) / (float)nc;

  if (kPcen) {  // rescale the block's PCEN values
    lo = total_b<kMin>(red, 1, n);
    hi = total_b<kMax>(red, 2, n);
    each_b(M, a0, a1, [&](int m, int j) {
      float* p = o + (size_t)m * T + g0 + j;
      put(p, (*p - lo) / (hi - lo + 1e-8f));
    });
  }

  // 4. The MFCCs' z-norm (unbiased) over the clip.
  float sq = 0.0f;
  each_b(C, a0, a1, [&](int c, int j) {
    const float dv = mf_s[c * W + j] - mean;
    sq += dv * dv;
  });
  warp_partial<kSum>(sq, red + 4 * kWarpsBC);
  __syncthreads();
  push_b<kSum>(red, 4, n, rank);
  cluster_sync_b();  // the last: nothing crosses the cluster after it
  const float denom = sqrtf(total_b<kSum>(red, 4, n) / (float)(nc - 1)) + 1e-8f;
  each_b(C, e0, e1, [&](int c, int j) {
    const float z = (mf_s[c * W + j] - mean) / denom;
    mf_s[c * W + j] = z;
    if (j >= a0 && j < a1) put(o_mf + (size_t)c * T + g0 + j, z);
  });
  __syncthreads();

  // 5. Deltas of the block's frames (and, with delta-deltas, of the frame
  // beside each edge), then delta-deltas: replicate-padded central
  // differences along time, a neighbour past the clip's edge clamped to it.
  const int dd = delta_delta;
  each_b(C, max(a0 - dd, -g0), min(a1 + dd, T - g0), [&](int c, int j) {
    const int t = g0 + j;
    const float* row = mf_s + c * W;
    const float d = (row[min(t + 1, T - 1) - g0] - row[max(t - 1, 0) - g0]) / 2.0f;
    if (j >= a0 && j < a1) put(o_mf + nc + (size_t)c * T + t, d);
    if (dd) d1_s[c * W + j] = d;
  });
  if (dd) {
    __syncthreads();
    each_b(C, a0, a1, [&](int c, int j) {
      const int t = g0 + j;
      const float* row = d1_s + c * W;
      put(o_mf + 2 * nc + (size_t)c * T + t, (row[min(t + 1, T - 1) - g0] - row[max(t - 1, 0) - g0]) / 2.0f);
    });
  }
}

// Launch C, the contrast rows: the launcher's spectral contrast, which the
// JAX package appends to the Pallas kernel's rows in jnp
// (cough_detector_tpu/ops/pallas/frontend_kernel.py:326-348, computing
// ops/frontend.py::spectral_contrast with method="gemm"). This note is its
// GEMM plan's; an n_fft from 640 on that the FFT plans fit takes its FFT
// plan (contrast_fft_kernel, plan_c; its note with the FFT plans below): at
// n_fft 2048 this design ran 20.4-20.6 ms at B = 1024 against cuFFT's
// 4.2.
//  * Function. Per clip, from the waveform (not pre-emphasized): frames
//    (reflect pad, hop), the win_length-Hann power over the bins the bands
//    read, the n_fft-Hann magnitude over all bins; per frame and band,
//    log1p(mean of the band's top tail) - log1p(mean of its bottom tail)
//    (0 for a one-bin band); the centroid sum f|X| / sum |X| (0 where
//    sum |X| is 0) over sr / 2; then the clip's unbiased z-norm over all
//    its frames and rows. Output (B, n_bands + 1, n_frames).
//  * Bound: operations. At the shipped config (n_fft 512, 6 bands) a clip
//    is 2 * 101 * (399 * 230 + 511 * 514) = 71.6 MFLOP of DFT against 67 KB
//    of bytes: 0.148 ms at B = 1024 at the TF32 tensor-core peak, 20 us for
//    the bytes.
//  * The DFT is a GEMM, as launch A's: M the clip's frames in 128-row tiles
//    (two MMA warpgroups), N column pairs in passes of 256 columns
//    (m64n256k8), K taps in k-steps of 8. First the power passes: the
//    bands' power bins' cos and -sin columns (bins 1-115 at the shipped
//    config: one pass) over the win_length window's own k-steps (50 of 8
//    taps); then the magnitude passes over both windows' support (j0,
//    kpad: 64 k-steps), a bin a pair, an even n_fft's DC and Nyquist cosines
//    in one pair (both sines are zero): 512 columns, two passes, at the
//    shipped config. It reuses launch A's machinery as it is: the span staged with its bank skew
//    (LayoutA), the hi/lo TF32 tables streamed through a ring of 16 KB
//    chunks (RingC: it runs on across a clip's row tiles), DftPass's 3xTF32
//    issue loop (modelled on the CPU by
//    ops/frontend_kernel.py::spectral_contrast_split_reference; PERF.md
//    gives the choice). A 128-row tile for 101 frames pads 21% of the
//    products.
//  * Warp roles. 384 threads: the two MMA warpgroups, and a warpgroup of
//    band warps. setmaxnreg gives the MMA warps 208 registers a thread (the
//    128 accumulator floats of a pass and the A fragments) and the band
//    warps 88 (PERF.md gives the splits tried). After a tile's power
//    passes, where a thread holds re and im of one bin of rows g and g + 8
//    side by side, the MMA warps write the power to the tile's power rows
//    in shared memory (128 x n_pow) and arrive on a named barrier; the
//    band warps, waiting on it, draw the tile's band items from a counter
//    in shared memory while the MMA warps run the magnitude passes, and the
//    MMA warps, done with those, draw the items left. A magnitude bin is
//    folded, after its sqrt, into the thread's running sums |X| and f|X|,
//    which the quad adds up after the last pass: the magnitude never
//    leaves registers.
//  * Band tails: an item is one band of kBandFrames frames, the widest
//    bands drawn first, by a warp, each frame's band sorted in registers by
//    a bitonic network of 32, 64 or 128 bins (band_sorted_frames; up to
//    kSortedBand bins), the frames' networks interleaved, so that a band
//    warp, alone with two MMA warps on its SM sub-partition, keeps
//    independent shuffles in flight; a wider band is ranked (band_ranked:
//    element a's rank counts the bins above it and the equal ones before
//    it, the formulation of ops/frontend.py::_tail_sums_rank). The tails'
//    sums are warp reductions. Exact selections: the means do not depend
//    on how ties are broken.
//  * One block a clip (the z-norm spans every frame), looping over its row
//    tiles; the band warps free the power rows on a second named barrier
//    before the next tile's power passes write them. The clip's rows stay
//    in shared memory until the MMA warps z-norm them.
// Launch C's shared memory, in floats after the ring's slots: the span
// (LayoutA's), the tile's power (128 rows of n_pow bins), the clip's
// contrast rows (n_rows x T), the reduction slots, then the ring's
// mbarriers and counters. A config that passes the card's shared memory
// moves them to device memory one by one, at the first `level` that fits:
// 0 all in shared memory; 1 the span read from device memory (DftPass
// unstaged); 2 the contrast rows too, in the output, z-normed in place;
// 3 the power rows too, in a scratch buffer of kRows x n_pow a block.
struct LayoutC {
  LayoutA a;
  int level, pow, con, red, end;

  __host__ __device__ LayoutC(int hop, int kpad, int n_pow, int n_frames, int n_rows)
      : a(hop, kpad) {
    for (level = 0;; ++level) {
      a = LayoutA(hop, kpad, level == 0);
      pow = a.span;
      con = pow + (level < 3 ? (kRows * n_pow + 3) / 4 * 4 : 0);
      red = con + (level < 2 ? (n_frames * n_rows + 3) / 4 * 4 : 0);
      end = red + kRedC;
      if (level == 3 || bytes(2) <= kMaxSmem) break;
    }
  }

  __host__ __device__ size_t bytes(int n_slots) const {
    return sizeof(float) * ((size_t)n_slots * kSlotFloats + end) + 12 * kMaxSlots;
  }
};

// Launch C's GEMM plan: a row tile's chunks (its power passes of pow_ks
// k-steps, its magnitude passes of kpad / 8; an even n_fft's Nyquist bin
// shares the DC bin's pair), and its ring's slots: as many as shared memory
// holds, up to kMaxSlots and the tile's chunks, at least 2.
__host__ __device__ inline int chunks_c(int n_fft, int kpad, int pow_ks, int n_pow) {
  const int n_mag = n_fft / 2 + 1 - (n_fft % 2 == 0);
  return (2 * n_pow + kPassCols - 1) / kPassCols * pow_ks + (2 * n_mag + kPassCols - 1) / kPassCols * (kpad / 8);
}

__host__ __device__ inline int slots_c(const LayoutC& lay, int chunks) {
  int n_slots = chunks < kMaxSlots ? chunks : kMaxSlots;
  while (n_slots > 2 && lay.bytes(n_slots) > kMaxSmem) --n_slots;
  return n_slots;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// The tails of kF frames' band of w bins, the first frame's at pb and each
// next one's stride floats on, by a warp: lane l ranks bins c0 + l, c0 + l
// + 32, ... (kK of them) of each frame against that frame's whole band,
// read by broadcast, and adds those in the top and bottom tails to the
// frame's sums. The frames' loads and compares are independent, so the
// warp keeps kF chains in flight.
template <int kK, int kF>
__device__ __forceinline__ void band_tails(const float* pb, int stride, int w, int n_top, int n_bot, int lane,
                                           int c0, float (&top)[kF], float (&bot)[kF]) {
  float xs[kF][kK];
  int rank[kF][kK];
#pragma unroll
  for (int f = 0; f < kF; ++f)
#pragma unroll
    for (int k = 0; k < kK; ++k) {
      const int e = c0 + lane + 32 * k;
      xs[f][k] = e < w ? pb[f * stride + e] : 0.0f;
      rank[f][k] = 0;
    }
#pragma unroll 1
  for (int b = 0; b < w; ++b) {  // not unrolled: a short build (it ranks bands past kSortedBand bins alone)
#pragma unroll
    for (int f = 0; f < kF; ++f) {
      const float y = pb[f * stride + b];
#pragma unroll
      for (int k = 0; k < kK; ++k)
        rank[f][k] += (y > xs[f][k]) | ((y == xs[f][k]) & (b < c0 + lane + 32 * k));
    }
  }
#pragma unroll
  for (int f = 0; f < kF; ++f)
#pragma unroll
    for (int k = 0; k < kK; ++k) {
      const bool in = c0 + lane + 32 * k < w;
      top[f] += in && rank[f][k] < n_top ? xs[f][k] : 0.0f;
      bot[f] += in && rank[f][k] >= w - n_bot ? xs[f][k] : 0.0f;
    }
}

// kF frames' contrast in one band of w bins, ranked: lane l ranks bins l,
// l + 32, ... of each frame in passes of kBandChunk (band_tails), then the
// two tails' sums are warp reductions; the first frame's band at pb, each
// next one's stride floats on.
template <int kF>
__device__ __forceinline__ void band_ranked(const float* pb, int stride, int w, int n_top, int n_bot, int lane,
                                            float (&v)[kF]) {
  float top[kF], bot[kF];
#pragma unroll
  for (int f = 0; f < kF; ++f) top[f] = bot[f] = 0.0f;
  for (int c0 = 0; c0 < w; c0 += kBandChunk)
    band_tails<kBandChunk / 32, kF>(pb, stride, w, n_top, n_bot, lane, c0, top, bot);
#pragma unroll
  for (int f = 0; f < kF; ++f)
    v[f] = log1pf(warp_sum(top[f]) / (float)n_top) - log1pf(warp_sum(bot[f]) / (float)n_bot);
}

// kF frames' contrast in one band of w <= kN bins (kN a power of two from
// 32), by a warp: each frame's band sorted in registers, descending, by a
// bitonic network of kN (element i = 32 r + lane in v[f][r], -1 past w: a
// power is never negative), the frames' networks interleaved so that their
// shuffles are independent; then the top tail is elements [0, n_top) and
// the bottom tail [w - n_bot, w). An exact selection, as ranking's: the
// tails' values do not depend on how ties are broken. kN log2(kN)^2 / 4
// compare-exchanges a frame, where ranking takes w^2 compares.
template <int kN, int kF>
__device__ __forceinline__ void band_sorted_frames(const float* pb, int stride, int w, int n_top, int n_bot,
                                                   int lane, float (&out)[kF]) {
  static_assert(kN >= 32 && (kN & (kN - 1)) == 0, "a network of 32, 64, ... bins");
  constexpr int kK = kN / 32;
  float v[kF][kK];
#pragma unroll
  for (int f = 0; f < kF; ++f)
#pragma unroll
    for (int r = 0; r < kK; ++r) v[f][r] = 32 * r + lane < w ? pb[f * stride + 32 * r + lane] : -1.0f;
#pragma unroll
  for (int k = 2; k <= kN; k <<= 1) {
#pragma unroll
    for (int j = k >> 1; j >= 32; j >>= 1)  // the partner is register r ^ (j / 32) of this lane
#pragma unroll
      for (int f = 0; f < kF; ++f)
#pragma unroll
        for (int r = 0; r < kK; ++r) {
          const int q = r ^ (j >> 5);
          if (q < r) continue;
          const bool desc = ((32 * r) & k) == 0;
          const float a = v[f][r], b = v[f][q];
          v[f][r] = desc ? fmaxf(a, b) : fminf(a, b);
          v[f][q] = desc ? fminf(a, b) : fmaxf(a, b);
        }
    // The partner is lane ^ j: a loop, not unrolled, keeps the code small.
#pragma unroll 1
    for (int j = (k >> 1) < 16 ? k >> 1 : 16; j > 0; j >>= 1)
#pragma unroll
      for (int f = 0; f < kF; ++f)
#pragma unroll
        for (int r = 0; r < kK; ++r) {
          const bool desc = ((32 * r + lane) & k) == 0;
          const float y = __shfl_xor_sync(0xffffffffu, v[f][r], j);
          v[f][r] = desc == ((lane & j) == 0) ? fmaxf(v[f][r], y) : fminf(v[f][r], y);
        }
  }
#pragma unroll
  for (int f = 0; f < kF; ++f) {
    float top = 0.0f, bot = 0.0f;
#pragma unroll
    for (int r = 0; r < kK; ++r) {
      const int i = 32 * r + lane;
      top += i < n_top ? v[f][r] : 0.0f;
      bot += i >= w - n_bot && i < w ? v[f][r] : 0.0f;
    }
    out[f] = log1pf(warp_sum(top) / (float)n_top) - log1pf(warp_sum(bot) / (float)n_bot);
  }
}

// kF frames' contrast in one band, by a warp, in launch C's GEMM plan: pb
// the first frame's power row from the first power bin, stride floats to
// the next frame's, bd the band (first bin from pb, bins, top and bottom
// tail lengths); bands of up to kSortedBand bins sorted
// (band_sorted_frames), wider ones ranked (band_ranked). A one-bin band's
// is 0.
template <int kF>
__device__ __forceinline__ void band_values(const float* pb, int stride, int4 bd, int lane, float (&v)[kF]) {
  const int w = bd.y, nt = bd.z, nb = bd.w;
  pb += bd.x;
  if (w <= 1) {
#pragma unroll
    for (int f = 0; f < kF; ++f) v[f] = 0.0f;
  } else if (w > kSortedBand)
    band_ranked<kF>(pb, stride, w, nt, nb, lane, v);
  else if (w > 64)
    band_sorted_frames<128, kF>(pb, stride, w, nt, nb, lane, v);
  else if (w > 32)
    band_sorted_frames<64, kF>(pb, stride, w, nt, nb, lane, v);
  else
    band_sorted_frames<32, kF>(pb, stride, w, nt, nb, lane, v);
}

// Named barrier kId over kCount threads (a multiple of 32): wait for them,
// or arrive and go on. Either orders the caller's memory accesses before
// the barrier for the threads that wait on it.
template <int kId, int kCount>
__device__ __forceinline__ void named_sync() {
  asm volatile("bar.sync %0, %1;\n" ::"n"(kId), "n"(kCount) : "memory");
}

template <int kId, int kCount>
__device__ __forceinline__ void named_arrive() {
  asm volatile("bar.arrive %0, %1;\n" ::"n"(kId), "n"(kCount) : "memory");
}

// The clip's z-norm (unbiased std) of its n contrast values `con` (shared
// or device memory), written to o; red: 2 * kWarpsA floats of shared memory.
// Called by every thread of the block (kBar 0), or by the first kThreadsA
// threads, which meet at named barrier kBar, after the barrier that
// completes con.
template <int kBar = 0>
__device__ void znorm_rows(const float* con, int n, float* red, float* o) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  float s = 0.0f;
  for (int i = tid; i < n; i += kThreadsA) s += con[i];
  s = warp_sum(s);
  if (lane == 0) red[warp] = s;
  if constexpr (kBar != 0)
    named_sync<kBar, kThreadsA>();
  else
    __syncthreads();
  float total = 0.0f;
#pragma unroll
  for (int w = 0; w < kWarpsA; ++w) total += red[w];
  const float mean = total / (float)n;
  float sq = 0.0f;
  for (int i = tid; i < n; i += kThreadsA) {
    const float d = con[i] - mean;
    sq += d * d;
  }
  sq = warp_sum(sq);
  if (lane == 0) red[kWarpsA + warp] = sq;
  if constexpr (kBar != 0)
    named_sync<kBar, kThreadsA>();
  else
    __syncthreads();
  float var = 0.0f;
#pragma unroll
  for (int w = 0; w < kWarpsA; ++w) var += red[kWarpsA + w];
  const float denom = sqrtf(var / (float)(n - 1)) + 1e-8f;
  for (int i = tid; i < n; i += kThreadsA) o[i] = (con[i] - mean) / denom;
}

// Launch C's named barriers: the MMA warps alone; the tile's power rows in
// place; the band warps done with them; the clip's band rows complete.
enum { kBarMma = 1, kBarPower = 2, kBarFree = 3, kBarRows = 4 };

// A row tile's band items, by the calling warp, until none is left: item
// j, drawn from the tile's counter `next` (shared memory), is band
// n_bands - 1 - j / groups (the widest bands first: the last items drawn
// are the cheapest) of frames kBandFrames (j % groups) on. The band warps
// draw from the power rows' barrier on, the MMA warps once their
// magnitude passes are done; each item's arithmetic is the same whoever
// draws it.
__device__ __forceinline__ void band_items(int* next, const float* pw, int n_pow, const int4* bands, int n_bands,
                                           int frames, float* con, int n_frames, int lane) {
  const int groups = (frames + kBandFrames - 1) / kBandFrames;  // the tile's 128 power rows hold them all
  for (;;) {
    int j = 0;
    if (lane == 0) j = atomicAdd(next, 1);
    j = __shfl_sync(0xffffffffu, j, 0);
    if (j >= groups * n_bands) return;
    const int i = n_bands - 1 - j / groups, f0 = kBandFrames * (j % groups);
    float v[kBandFrames];
    band_values<kBandFrames>(pw + f0 * n_pow, n_pow, __ldg(bands + i), lane, v);
    if (lane == 0)
#pragma unroll
      for (int f = 0; f < kBandFrames; ++f)
        if (f0 + f < frames) con[i * n_frames + f0 + f] = v[f];
  }
}

// Launch C. grid (batch): block b takes clip b; kThreadsC threads (warps
// 0-7 the MMA warps, 8-11 the band warps), LayoutC's shared memory with
// n_slots ring slots (2 to kMaxSlots, at most a tile's chunks). table: the
// chunk stream (ops/frontend_kernel.py::_contrast_constants), a row tile's
// chunks: its power passes (ceil(2 n_pow / 256)) of pow_ks chunks, the
// k-steps [pow_k0, pow_k0 + pow_ks) from j0, the bands' power bins' column
// pairs from their first; then its magnitude passes (ceil(2 n_mag / 256))
// of kpad / 8 chunks, n_mag pairs (n_freqs, less one for an even n_fft:
// pair 0 holds the DC and Nyquist cosines); freqs the centroid's bin
// frequencies; bands (n_bands x 4 ints in device memory): per band its
// first bin (from the first power bin), bins, top and bottom tail lengths.
// kStaged: LayoutC's level 0; else levels 1-3, the power rows in `scratch`
// at level 3.
template <bool kStaged>
__global__ void __launch_bounds__(kThreadsC, 1) contrast_kernel(
    const float* __restrict__ wave, int n_samples, int n_frames, int n_fft, int hop, int j0,
    int kpad, int pow_k0, int pow_ks, const float* __restrict__ table, int n_pow, int n_freqs,
    const float* __restrict__ freqs, float half_sr, const int4* __restrict__ bands, int n_bands,
    int n_slots, float* __restrict__ scratch, float* __restrict__ out) {
  extern __shared__ float4 smem4[];
  const int n_rows = n_bands + 1, n = n_rows * n_frames;
  const LayoutC lay(hop, kpad, n_pow, n_frames, n_rows);
  float* slots = reinterpret_cast<float*>(smem4);
  float* span = slots + n_slots * kSlotFloats;
  float* pw = kStaged || lay.level < 3 ? span + lay.pow : scratch + (size_t)blockIdx.x * kRows * n_pow;
  float* con = kStaged || lay.level < 2 ? span + lay.con : out + (size_t)blockIdx.x * n;
  float* red = span + lay.red;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  // A tile's band items are drawn from counters[tile % 2] (the reduction
  // slots', free until the z-norm): zero for the first two tiles here, and
  // for tile t + 1 once every warp is done with tile t - 1's (step 2).
  int* counters = reinterpret_cast<int*>(red);
  if (tid == 0) counters[0] = counters[1] = 0;

  // The band warps: each tile's band items, once its power rows are in
  // place, while the MMA warps run its magnitude passes.
  if (warp >= kWarpsA) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kRegBand));
    for (int t0 = 0; t0 < n_frames; t0 += kRows) {
      named_sync<kBarPower, kThreadsC>();
      band_items(counters + t0 / kRows % 2, pw, n_pow, bands, n_bands, min(n_frames - t0, kRows), con + t0,
                 n_frames, lane);
      if (t0 + kRows < n_frames) named_arrive<kBarFree, kThreadsC>();
    }
    named_arrive<kBarRows, kThreadsC>();
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kRegMma));

  const int g = lane >> 2, t = lane & 3;
  const int mag_ks = kpad / 8, n_mag = n_freqs - (n_fft % 2 == 0);
  const int pow_passes = (2 * n_pow + kPassCols - 1) / kPassCols;
  const int mag_passes = (2 * n_mag + kPassCols - 1) / kPassCols;
  RingC ring;
  ring.slots = slots;
  ring.full = reinterpret_cast<uint64_t*>(span + lay.end);
  ring.released = reinterpret_cast<int*>(ring.full + kMaxSlots);
  ring.table = table;
  ring.n_slots = n_slots;
  ring.per = ring.n = pow_passes * pow_ks + mag_passes * mag_ks;
  if (tid == 0) {  // the first tile's first chunks; the releases fill the rest
    for (int i = 0; i < n_slots; ++i) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(ring.full + i))
                   : "memory");
      ring.released[i] = 0;
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int q = 0; q < n_slots; ++q) ring.fill(q);
  }

  const int row = 64 * (warp / 4) + 16 * (warp & 3) + g;  // and row + 8
  int slot = 0, parity = 0;  // the ring's next slot and its parity
  DftPass<kStaged, RingC> dft(ring, lay.a, span + row * lay.a.rs, hop);
  dft.src.x = wave + (size_t)blockIdx.x * n_samples;
  dft.src.n_samples = n_samples;
  dft.src.use_pre = 0;
  dft.src.pre_coef = 0.0f;
  dft.i0 = row * hop;
  for (int t0 = 0; t0 < n_frames; t0 += kRows) {
    // 1. Stage the tile's span (its chunks are landing).
    if (t0 > 0) named_sync<kBarMma, kThreadsA>();  // every MMA warp is done with the last tile's span
    ring.more = t0 + kRows < n_frames;
    const int frames = min(n_frames - t0, kRows);
    dft.src.base = t0 * hop + j0 - n_fft / 2;
    dft.src.live = (frames - 1) * hop + kpad;
    if (kStaged) stage_span(span, lay.a, dft.src, (kRows - 1) * hop + kpad, hop);
    named_sync<kBarMma, kThreadsA>();  // the span and the ring's barriers are ready

    // 2. The power passes, to the power rows; then the band warps take them.
    int q = 0;
    for (int p = 0; p < pow_passes; ++p) {
      dft.run_from(q, slot, parity, pow_k0, pow_ks);
      if (p == 0 && t0 > 0) {
        named_sync<kBarFree, kThreadsC>();  // the band warps are done with the last tile's
        if (tid == 0) counters[(t0 / kRows + 1) % 2] = 0;  // the next tile's counter: tile t - 1's is free
      }
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        const int bin = 128 * p + 4 * j + t;  // column pair
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float re = dft.acc[4 * j + 2 * h], im = dft.acc[4 * j + 2 * h + 1];
          if (bin < n_pow) pw[(row + 8 * h) * n_pow + bin] = re * re + im * im;
        }
      }
    }
    named_arrive<kBarPower, kThreadsC>();

    // 3. The magnitude passes, into the running sums.
    float msum[2] = {0.0f, 0.0f}, fsum[2] = {0.0f, 0.0f};
    for (int p = 0; p < mag_passes; ++p) {
      dft.run(q, slot, parity, mag_ks);
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        const int i = 128 * p + 4 * j + t;  // column pair: bin i, and pair 0 the Nyquist bin's too
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float re = dft.acc[4 * j + 2 * h], im = dft.acc[4 * j + 2 * h + 1];
          if (i < n_mag) {
            const bool two = i == 0 && n_mag < n_freqs;  // the DC and Nyquist cosines
            const float m = sqrtf(two ? re * re : re * re + im * im);
            msum[h] += m;
            fsum[h] += __ldg(freqs + i) * m;
            if (two) {
              const float mn = sqrtf(im * im);
              msum[h] += mn;
              fsum[h] += __ldg(freqs + n_freqs - 1) * mn;
            }
          }
        }
      }
    }

    // 4. The centroid of rows row and row + 8: the quad's four sums.
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float ms = msum[h], fs = fsum[h];
      ms += __shfl_xor_sync(0xffffffffu, ms, 1);
      fs += __shfl_xor_sync(0xffffffffu, fs, 1);
      ms += __shfl_xor_sync(0xffffffffu, ms, 2);
      fs += __shfl_xor_sync(0xffffffffu, fs, 2);
      const int r = row + 8 * h;
      if (t == 0 && r < frames) con[n_bands * n_frames + t0 + r] = (ms > 0.0f ? fs / ms : 0.0f) / half_sr;
    }

    // 5. The tile's band items the band warps have not drawn yet.
    band_items(counters + t0 / kRows % 2, pw, n_pow, bands, n_bands, frames, con + t0, n_frames, lane);
  }
  named_sync<kBarRows, kThreadsC>();  // the band warps' rows are complete

  // 6. The clip's z-norm, written as (n_rows, n_frames), by the MMA warps.
  znorm_rows<kBarMma>(con, n, red, out + (size_t)blockIdx.x * n);
}

// -- The FFT plans of launches A and C ------------------------------------------
//
// For an n_fft whose rows, Bluestein scratch and tables fit a block, odd
// or even, from kFftMinNfft on (fft_fits, LayoutF), launches A and C
// compute their spectra by FFT instead of the DFT as a GEMM (plan_a,
// plan_c): the GEMM
// costs O(n_fft) a bin, and at n_fft 2048 it pads 32 frames to 128 rows, runs 256 k-steps over 2,048
// taps and 9 passes over 1,025 bins, three TF32 products each, where an
// FFT costs O(log n_fft) a bin.
//  * A block takes `frames` consecutive frames of one clip (kFftPoints
//    complex points a block, at most kFftMaxFrames frames) and stages their
//    span once in shared memory by WaveSrc (reflect pad, pre-emphasis),
//    then packs each windowed frame into complex points, in shared memory.
//  * The FFT, FP32 on the CUDA cores: Stockham autosort stages (first one
//    of a prime past kFftMaxPrime by Bluestein's chirp-z,
//    fft_stage_bluestein, then one of radix 2 when the points hold an odd
//    power of two, then radix 4, then radix 3, 5, 7 and 11, each R-point
//    DFT in registers, then one stage of each larger prime factor up to
//    kFftMaxPrime, fft_stage_prime), every frame of
//    the block at once, each stage in place: a thread reads its
//    butterflies' points into registers, the block meets at a barrier,
//    then it writes their outputs. Rows and butterfly indices come by
//    shifts for a power of two, else by a multiply (DivBy). Twiddles
//    e^{-2 pi i k / n_fft} for k in [0, n_fft / 2] come from a table the
//    host builds in float64 and rounds once (ops/frontend_kernel.py::
//    _twiddles), staged in shared memory; k past n_fft / 2 is the
//    conjugate of entry n_fft - k, which holds for an odd n_fft too.
//  * Launch A (spectral_fft_kernel) packs an even n_fft's frame of n_fft
//    reals as n_fft / 2 complex (even samples real, odd imaginary; an odd
//    count where n_fft / 2 is odd, as 441 at n_fft 882), and the real
//    FFT's bin k is (Z[k] + conj Z[m - k]) / 2 + w^k (-i) (Z[k] - conj
//    Z[m - k]) / 2 (m = n_fft / 2, w = e^{-2 pi i / n_fft}). On an odd
//    n_fft, frames 2j and 2j + 1 are the real and imaginary parts of one
//    FFT of n_fft points, split as launch C splits its two windows: X_2j[k]
//    = (Z[k] + conj Z[n - k]) / 2, X_2j+1[k] = (Z[k] - conj Z[n - k]) / 2i,
//    no post-twiddle; a clip's odd last frame pairs with zeros. Either way
//    a frame costs n_fft / 2 points of FFT. The power of
//    bins [0, n_used) replaces the points in shared memory, then the mel
//    is FP32 FMAs over each filter's nonzero bins (the filters are
//    triangles: about 2 n_used products a frame), read from a packed table
//    (_fft_constants). Output (B, n_mels, n_frames), as the GEMM plan's.
//  * Launch C (contrast_fft_kernel) runs both windows of a frame through
//    one complex FFT of n_fft points, z = w_win x + i w_nfft x, and splits
//    the two real spectra by conjugate symmetry: (Z[k] + conj Z[n - k]) / 2
//    is the win_length window's (its power over the bands' bins goes to
//    the power rows), (Z[k] - conj Z[n - k]) / 2i the n_fft window's (its
//    magnitude into the frame's centroid sums), for an odd n_fft as for an
//    even one. One block a clip loops
//    over its frame groups; a warp takes a (frame, band) and sorts the
//    band in registers (band_value_sorted: ranking the 239-bin band of n_fft
//    2048 by stable rank took 48% of the launch, 1.10 of 2.29 ms at B =
//    1024; sorted, the band stage takes 0.24 of 1.41, tools/contrast_probe.py);
//    the centroid and the z-norm are the GEMM plan's (znorm_rows). The
//    clip's contrast rows go to the output and are z-normed there in
//    place, for every config: kept in shared memory where they fit, they
//    ran 1.4511-1.4514 ms against 1.4542-1.4573 at n_fft 2048 and B =
//    1024 (tools/contrast_probe.py, in turns), a second layout for 0.3%.
//  * Bound: operations at n_fft 2048 (an FFT a frame at the FP32 peak,
//    0.0320 ms for launch A at B = 1024 on 128 mels; 0.0611 for launch C,
//    both windows and the tails as selections), with the bytes close
//    behind. The FFT stages take about half of launch A (0.30 of 0.63 ms
//    at B = 1024, n_fft 2048) and two thirds of launch C (0.98 of 1.41):
//    each stage's barrier pair, and its strided shared-memory writes
//    (radix 4 at a stride of ns points, bank conflicts while ns < 32).
//  * The CPU models of this arithmetic, the same packing, stages, table
//    and post-twiddles in torch ops: ops/frontend_kernel.py's
//    power_mel_fft_reference and spectral_contrast_fft_reference.

// The largest prime factor of n (n >= 1; 1 for n = 1).
__host__ __device__ inline int largest_prime(int n) {
  int p = 1;
  for (int f = 2; f * f <= n; f += 1 + (f > 2))
    while (n % f == 0) {
      p = f;
      n /= f;
    }
  return n > 1 ? n : p;
}

// Whether n's prime factors are all at most 11 (the radix stages').
__host__ __device__ inline bool smooth11(int n) {
  for (int f = 2; f <= 11; ++f)
    while (n % f == 0) n /= f;
  return n == 1;
}

// The prime factor of an n_fft that the FFT plans compute by Bluestein's
// stage (fft_stage_bluestein): its largest, where it passes kFftMaxPrime;
// else 0. A row holds at most kFftPoints points and kFftMaxPrime^2 passes
// that, so a row's points have at most one such factor.
static_assert(kFftMaxPrime * kFftMaxPrime > kFftPoints, "at most one prime factor past the cap a row");
__host__ __device__ inline int bluestein_prime(int n_fft) {
  const int p = largest_prime(n_fft);
  return p > kFftMaxPrime ? p : 0;
}

// Bluestein's convolution length for a prime P: the smallest odd 11-smooth
// m >= 2 P - 1, so the radix stages compute its FFT and a butterfly's row
// of m points starts 2m words after its neighbour's, in another bank pair
// (an even m put up to 8 of a warp's 16 float2 writes in one bank).
__host__ __device__ inline int bluestein_points(int P) {
  int m = 2 * P - 1;
  while (!smooth11(m)) m += 2;
  return m;
}

// Launch A's complex points a row of its FFT: n_fft / 2 for an even n_fft
// (a frame packed as complex), n_fft for an odd one (two frames a row).
__host__ __device__ inline int fft_points_a(int n_fft) { return n_fft % 2 ? n_fft : n_fft / 2; }

// The FFT plans' shared memory, in floats: the points (2 floats each,
// rows x points a row), the frames' waveform span, the tables (n_fft / 2 +
// 1 float2 of twiddles, then for a prime past kFftMaxPrime Bluestein's
// chirp, B^ and m-point stage twiddles: P + m + m - 1 float2, the last
// from `blue`),
// then for launch C the group's power rows (frames x n_pow) and the
// reduction slots (its contrast rows go to the output and are z-normed
// there in place). A row holds a frame, or two for launch A on an odd
// n_fft. Bluestein's scratch takes the span's place (the span is read
// before the FFT) and grows it where it needs more room: two rows of m
// points for each group of `gw` warps (kWarpsA / gw groups; gw a power of
// two). Of gw from 1 up, the tables staged and then all but the FFT_m
// stages' twiddles read from device memory through L1 (`twl1`: the n_fft
// twiddles and the chirp and B^, these two read in consecutive words; the
// stages' twiddles, read R - 1 to a butterfly, stay in shared memory), the
// first layout that lets two blocks on an SM (kSmemTwo) is taken; where
// none does, the first in that order that fits a block (else 8 warps,
// through L1).
// `rows` halves from its most until the layout fits; launch C's most is
// rounded down to a power of two, since its threads split evenly over the
// frames (tpf). The host builds it and the kernels take it as an
// argument: no thread computes it, nor searches for the prime (a prime
// search in every thread cost the older plans 1.6-4.8%, PERF.md).
struct LayoutF {
  // The fields that the instances without Bluestein's stage read keep the
  // offsets they had before it, so that those instances keep their code
  // (tools/spectral_probe.py --turns compares it with an older source's).
  // blue: where Bluestein's FFT_m stages' twiddles start.
  int rows, frames, span, tw, pow, red, end;
  int bp, bm, gw, blue, tables;  // Bluestein's prime (0: none), its m, warps a group (0: none); tables' float2

  // The tables but the FFT_m stages' twiddles read through L1, not staged
  // (those twiddles then start the staged tables).
  __host__ __device__ bool twl1() const { return bp && blue == tw; }

  // Launch A (fft_points_a a row; no power rows).
  __host__ __device__ LayoutF(int n_fft, int hop) { fit(fft_points_a(n_fft), 1 + n_fft % 2, n_fft, hop, 0, false); }

  // Launch C (a frame of n_fft points a row).
  __host__ __device__ LayoutF(int n_fft, int hop, int n_pow) { fit(n_fft, 1, n_fft, hop, n_pow, true); }

  __host__ __device__ void fit(int points, int per_row, int n_fft, int hop, int n_pow, bool contrast) {
    bp = bluestein_prime(n_fft);
    bm = bp ? bluestein_points(bp) : 0;
    tables = n_fft / 2 + 1 + (bp ? bp + 2 * bm - 1 : 0);
    // Floats of the n_fft twiddles, of Bluestein's tables, of its FFT_m stages' twiddles.
    const int twn = n_fft + 2, twb = 2 * (tables - n_fft / 2 - 1), twm = bp ? 2 * (bm - 1) : 0;
    rows = kFftPoints / points < kFftMaxFrames / per_row ? kFftPoints / points : kFftMaxFrames / per_row;
    if (contrast)
      while (rows & (rows - 1)) rows &= rows - 1;
    for (;; rows /= 2) {
      frames = rows * per_row;
      const int spanf = ((frames - 1) * hop + n_fft + 3) / 4 * 4;
      const int rest = 2 * rows * points + (contrast ? (frames * n_pow + 3) / 4 * 4 + kRedC : 0);
      int region = spanf;
      bool l1 = false;
      gw = 0;
      if (bp) {
        const int most[2] = {kSmemTwo / 4, (int)(kMaxSmem / 4)};  // floats: two blocks an SM, else one
        for (int i = 0; i < 2 && !gw; ++i)
          for (int g = 1; g <= kWarpsA && !gw; g *= 2)
            for (int l = 0; l < 2 && !gw; ++l)
              if (rest + scratch(g, spanf) + (l ? twm : twn + twb) <= most[i]) {
                gw = g;
                l1 = l;
              }
        if (!gw) {
          gw = kWarpsA;
          l1 = true;
        }
        region = scratch(gw, spanf);
      }
      span = 2 * rows * points;
      tw = span + region;
      blue = tw + (l1 ? 0 : 2 * (n_fft / 2 + 1 + bp + bm));  // (twn: one float more on an odd n_fft)
      pow = tw + (l1 ? twm : twn + twb);
      red = pow + (frames * n_pow + 3) / 4 * 4;
      end = contrast ? red + kRedC : pow;
      if (rows <= 1 || sizeof(float) * end <= kMaxSmem) break;
    }
  }

  // The span's region with Bluestein's scratch in it: two rows of m points
  // for each group of g warps.
  __host__ __device__ int scratch(int g, int spanf) const {
    const int rowsf = 4 * (kWarpsA / g) * bm;
    return rowsf > spanf ? (rowsf + 3) / 4 * 4 : spanf;
  }

  __host__ __device__ size_t bytes() const { return sizeof(float) * end; }
};

// Whether the FFT plans' kernels take an n_fft at all: from 64, odd or
// even, any prime factors (past 11 fft_stage_prime, past kFftMaxPrime
// Bluestein's stage), a row of points (fft_points_a for launch A, n_fft
// for launch C) that fits a block's points, and Bluestein's m at most
// kBluesteinPoints; the twiddle table's conjugate half holds for any
// n_fft. Their C entry points take what this takes where LayoutF fits,
// whatever the plan says.
__host__ __device__ inline bool fft_fits(int n_fft, int points_a_row) {
  const int bp = bluestein_prime(n_fft);
  return n_fft >= 64 && points_a_row <= kFftPoints && (!bp || bluestein_points(bp) <= kBluesteinPoints);
}

// The plan rule: an n_fft takes an FFT plan where fft_fits and LayoutF
// fits a block; plan_a and plan_c take it from kFftMinNfft on, and
// launch A also past 128 mels, where its GEMM plan runs the DFT again for
// each mel group (1.34 ms at B = 1024 on 256 mels, the FFT plan 0.67). At
// 128 mels and hop n_fft / 4 the FFT plan beat the GEMM at B = 1024 and
// 4096 on n_fft 640 (launch A 1.5x, launch C 1.2x), 768 and 1000
// (2.1-3.1x), with a factor of 7 on 672 (A 1.8-1.9x, C 1.15-1.17x) and 784
// (A 2.4-2.5x, C 2.2-2.3x), with a factor of 11 on 704 (A 1.9-2.0x, C
// 1.8x), and odd on 675 (A 1.8-1.9x, C 1.4-1.5x) and 693 (3^2 7 11: A
// 1.5-1.9x, C 1.5-1.7x), so one threshold serves all; the GEMM keeps n_fft
// 512 (the shipped config: 0.99 ms against the FFT's 1.74 at B = 4096;
// tools/spectral_probe.py, tools/contrast_probe.py). An n_fft that nothing
// fits keeps its GEMM (launch A past 16384, launch C past 8192, or a
// prime whose Bluestein tables and scratch pass shared memory).
// kFftMaxPrime, by the probes' --primes sections: at B = 1024, 128 mels,
// hop n_fft / 4, on the 16 kHz window of p ms (n_fft 16 p), each plan in
// turns with the library call (launch A: torch.stft + mel; C: the fft
// rows) and the other prime stage (generic to the cap, Bluestein's past
// it: variants of kFftMaxPrime), the slower of two reads, ms (H100 at
// 700 W; Bluestein's stage as redesigned, rows of a warp group; PERF.md):
//     p  n_fft   A: generic Bluestein  GEMM  library   C: generic Bluestein  GEMM  fft rows
//    13    208         1.00         -  0.51     1.30         2.33         -  1.90      6.08
//    43    688         1.11         -  1.07     1.72         2.19         -  2.34      6.03
//    89   1424         1.54         -  6.73     1.80         3.00         -  9.52      5.97
//   101   1616         1.37      1.41  8.81     1.87         3.04      3.18 11.54      5.91
//   113   1808         1.51      1.32 10.95     1.98         3.22      2.92 16.87      5.98
//   127   2032         1.55      1.37 12.23     2.04         3.40      3.27 20.38      6.16
//   131   2096         1.83      1.49 14.14     1.55         3.88      3.21 22.50      5.01
//   137   2192         2.00      1.33 14.96     1.68         3.84      3.10 15.65      5.26
//   173   2768         2.20      1.70 22.46     1.62         4.62      3.71 23.68      5.10
//   257   4112         3.20      1.77 49.60     1.75         6.55      3.67 49.37      5.25
//   409   6544         4.05      1.56 122.8     1.51        10.77      4.36 117.3      4.88
// (tools/spectral_probe.py, tools/contrast_probe.py --primes, PERF.md has
// every probed prime). The generic stage costs P / 2 + 1 multiply-add
// pairs a point, Bluestein's two FFTs of m ~ 2P points a butterfly: the
// generic stage's plans beat the GEMM and the library to 127 (launch A
// loses to its library from 131), and Bluestein's plans beat the generic
// ones from 113 on (both launches) but not at 101. The cap is 113, set
// where the first design's Bluestein stage started to win (127); the
// redesigned stage wins at 113 too, not at 101, and 103 to 109 are
// unprobed. Launch A's Bluestein plans lose to their library at 173, 257
// and past (331: 1.80 against 1.67, 409: 1.56 against 1.51); launch C's
// beat the fft rows at every probed prime. The threshold held on a factor
// of 13 at 676 and 715 for both launches and at 650 for launch A; at 650
// launch C's FFT plan ran 1.99-2.07 against the GEMM's 1.95-1.97 ms.
// Launch A's plan: the FFT, else the GEMM with its span staged or not.
enum { kPlanGemmUnstaged = 0, kPlanGemmStaged = 1, kPlanFft = 2 };

__host__ __device__ inline int plan_a(int n_fft, int hop, int kpad, int n_mels) {
  if (fft_fits(n_fft, fft_points_a(n_fft)) && (n_fft >= kFftMinNfft || n_mels > 128) &&
      LayoutF(n_fft, hop).bytes() <= kMaxSmem)
    return kPlanFft;
  return staged_a(hop, kpad) ? kPlanGemmStaged : kPlanGemmUnstaged;
}

// Launch C's plan: LayoutC's level 0-3 (the GEMM), or the FFT (4).
enum { kPlanCFft = 4 };

__host__ __device__ inline int plan_c(int n_fft, int hop, int kpad, int n_pow, int n_frames, int n_bands) {
  if (fft_fits(n_fft, n_fft) && n_fft >= kFftMinNfft && LayoutF(n_fft, hop, n_pow).bytes() <= kMaxSmem)
    return kPlanCFft;
  return LayoutC(hop, kpad, n_pow, n_frames, n_bands + 1).level;
}

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

// e^{-2 pi i idx / n_fft} for idx in [0, n_fft), from the table of idx in
// [0, n_fft / 2]: past it, the conjugate of entry n_fft - idx, for an odd
// n_fft as for an even one. One rule for both: with the negated entry of
// idx - n_fft / 2 kept for an even n_fft (a branch on its parity), the
// two launches ran slower on 19 of 23 configs, by up to 9%, in turns
// (tools/spectral_probe.py, tools/contrast_probe.py; PERF.md).
__device__ __forceinline__ float2 twiddle(const float2* tw, int idx, int n_fft) {
  const bool lo = 2 * idx <= n_fft;
  const float2 t = tw[lo ? idx : n_fft - idx];
  return make_float2(t.x, lo ? t.y : -t.y);
}

// n / d for 0 <= n and 1 <= d with n d < 2^31 (points and counts of a
// block's FFT, at most kFftPoints each), by a multiply: m = ceil(2^31 / d)
// overestimates 2^31 / d by less than 1, so 2n m / 2^32 passes n / d by
// less than n / 2^31 < 1 / d, never reaching the next whole number.
struct DivBy {
  unsigned m;
  __device__ __forceinline__ explicit DivBy(int d) : m((0x7FFFFFFFu + d) / d) {}
  __device__ __forceinline__ int operator()(int n) const { return (int)__umulhi((unsigned)n << 1, m); }
};

// cos and sin of 2 pi / 3, 2 pi / 5, 4 pi / 5, 2 pi / 7, 4 pi / 7 and 6 pi
// / 7, and of 2 pi j / 11 for j in 1-5, from float64 values, rounded once
// (ops/frontend_kernel.py's _stockham uses the same).
constexpr float kSin3 = 0.86602540378443865;
constexpr float kCos5a = 0.30901699437494742, kSin5a = 0.95105651629515357;
constexpr float kCos5b = -0.80901699437494742, kSin5b = 0.58778525229247314;
constexpr float kCos7a = 0.62348980185873359, kSin7a = 0.78183148246802980;
constexpr float kCos7b = -0.22252093395631434, kSin7b = 0.97492791218182362;
constexpr float kCos7c = -0.90096886790241903, kSin7c = 0.43388373911755823;
constexpr float kCos11a = 0.84125353283118121, kSin11a = 0.54064081745559756;
constexpr float kCos11b = 0.41541501300188644, kSin11b = 0.90963199535451833;
constexpr float kCos11c = -0.142314838273285, kSin11c = 0.9898214418809328;
constexpr float kCos11d = -0.65486073394528499, kSin11d = 0.75574957435425827;
constexpr float kCos11e = -0.95949297361449737, kSin11e = 0.28173255684142967;

// e^{-2 pi i j / R} for Bluestein's composite radices (blue_stage): R 9 at
// j 1, 2 and 4, R 15 at j 1-4, 6 and 8, from float64 values rounded once (j
// a constant once the loops unroll).
template <int R>
__device__ __forceinline__ float2 w_composite(int j) {
  if constexpr (R == 9)
    return j == 1 ? make_float2(0.766044443118978f, -0.6427876096865393f)
         : j == 2 ? make_float2(0.17364817766693041f, -0.984807753012208f)
                  : make_float2(-0.9396926207859083f, -0.3420201433256689f);
  else
    return j == 1 ? make_float2(0.9135454576426009f, -0.40673664307580015f)
         : j == 2 ? make_float2(0.6691306063588582f, -0.7431448254773941f)
         : j == 3 ? make_float2(0.30901699437494745f, -0.9510565162951535f)
         : j == 4 ? make_float2(-0.10452846326765333f, -0.9945218953682734f)
         : j == 6 ? make_float2(-0.8090169943749473f, -0.5877852522924732f)
                  : make_float2(-0.9781476007338057f, 0.20791169081775907f);
}

// cos and sin of 2 pi j / 11 for j in [1, 11), from the five above (the
// radix-11 DFT's j is a constant once its loops unroll).
__device__ __forceinline__ constexpr float cos11(int j) {
  const int a = j <= 5 ? j : 11 - j;
  return a == 1 ? kCos11a : a == 2 ? kCos11b : a == 3 ? kCos11c : a == 4 ? kCos11d : kCos11e;
}
__device__ __forceinline__ constexpr float sin11(int j) {
  const int a = j <= 5 ? j : 11 - j;
  const float s = a == 1 ? kSin11a : a == 2 ? kSin11b : a == 3 ? kSin11c : a == 4 ? kSin11d : kSin11e;
  return j <= 5 ? s : -s;
}

__device__ __forceinline__ float2 cadd(float2 a, float2 b) { return make_float2(a.x + b.x, a.y + b.y); }
__device__ __forceinline__ float2 csub(float2 a, float2 b) { return make_float2(a.x - b.x, a.y - b.y); }

// The R-point DFT (w = e^{-2 pi i / R}) of v, in place (R 9 and 15 for
// Bluestein's FFT_m alone).
template <int R>
__device__ __forceinline__ void dft_points(float2 (&v)[R]) {
  if constexpr (R == 2) {
    const float2 a = v[0], b = v[1];
    v[0] = cadd(a, b);
    v[1] = csub(a, b);
  } else if constexpr (R == 3) {
    const float2 s = cadd(v[1], v[2]), d = csub(v[1], v[2]);
    const float2 t = make_float2(v[0].x - 0.5f * s.x, v[0].y - 0.5f * s.y);  // v0 + cos(2 pi / 3) s
    const float2 u = make_float2(kSin3 * d.y, -(kSin3 * d.x));                // -i sin(2 pi / 3) d
    v[0] = cadd(v[0], s);
    v[1] = cadd(t, u);
    v[2] = csub(t, u);
  } else if constexpr (R == 4) {
    const float2 a0 = cadd(v[0], v[2]), a1 = csub(v[0], v[2]), a2 = cadd(v[1], v[3]);
    const float2 d = csub(v[1], v[3]);
    const float2 a3 = make_float2(d.y, -d.x);  // -i d
    v[0] = cadd(a0, a2);
    v[1] = cadd(a1, a3);
    v[2] = csub(a0, a2);
    v[3] = csub(a1, a3);
  } else if constexpr (R == 5) {
    const float2 t1 = cadd(v[1], v[4]), t2 = csub(v[1], v[4]), t3 = cadd(v[2], v[3]), t4 = csub(v[2], v[3]);
    const float2 m1 = make_float2(v[0].x + kCos5a * t1.x + kCos5b * t3.x, v[0].y + kCos5a * t1.y + kCos5b * t3.y);
    const float2 m2 = make_float2(v[0].x + kCos5b * t1.x + kCos5a * t3.x, v[0].y + kCos5b * t1.y + kCos5a * t3.y);
    const float2 n1 = make_float2(kSin5a * t2.x + kSin5b * t4.x, kSin5a * t2.y + kSin5b * t4.y);
    const float2 n2 = make_float2(kSin5b * t2.x - kSin5a * t4.x, kSin5b * t2.y - kSin5a * t4.y);
    v[0] = cadd(cadd(v[0], t1), t3);
    v[1] = make_float2(m1.x + n1.y, m1.y - n1.x);  // m1 - i n1
    v[4] = make_float2(m1.x - n1.y, m1.y + n1.x);  // m1 + i n1
    v[2] = make_float2(m2.x + n2.y, m2.y - n2.x);
    v[3] = make_float2(m2.x - n2.y, m2.y + n2.x);
  } else if constexpr (R == 11) {
    // Pairs a_r = v_r + v_{11-r}, b_r = v_r - v_{11-r} for r in 1-5; output
    // k in 1-5 is m_k - i n_k and output 11 - k is m_k + i n_k, with m_k =
    // v0 + sum_r cos(2 pi r k / 11) a_r and n_k = sum_r sin(2 pi r k / 11)
    // b_r, each summed in r's order.
    float2 a[5], b[5];
#pragma unroll
    for (int r = 1; r <= 5; ++r) {
      a[r - 1] = cadd(v[r], v[11 - r]);
      b[r - 1] = csub(v[r], v[11 - r]);
    }
    const float2 v0 = v[0];
#pragma unroll
    for (int k = 1; k <= 5; ++k) {
      float2 m = v0, n = make_float2(sin11(k) * b[0].x, sin11(k) * b[0].y);
#pragma unroll
      for (int r = 1; r <= 5; ++r) {
        const float c = cos11(r * k % 11);
        m = make_float2(m.x + c * a[r - 1].x, m.y + c * a[r - 1].y);
        if (r > 1) {
          const float sn = sin11(r * k % 11);
          n = make_float2(n.x + sn * b[r - 1].x, n.y + sn * b[r - 1].y);
        }
      }
      v[k] = make_float2(m.x + n.y, m.y - n.x);       // m_k - i n_k
      v[11 - k] = make_float2(m.x - n.y, m.y + n.x);  // m_k + i n_k
    }
    v[0] = cadd(cadd(cadd(cadd(cadd(v0, a[0]), a[1]), a[2]), a[3]), a[4]);
  } else if constexpr (R == 9 || R == 15) {
    // R = 3 R2 (R2 = 3 or 5): point n = R2 n1 + n2; for each n2 the 3-point
    // DFT over n1 (output k1) times w_R^{n2 k1}, then for each k1 the
    // R2-point DFT over n2, output k2 to k1 + 3 k2.
    constexpr int R2 = R / 3;
    float2 y[3][R2];
#pragma unroll
    for (int n2 = 0; n2 < R2; ++n2) {
      float2 t[3] = {v[n2], v[R2 + n2], v[2 * R2 + n2]};
      dft_points<3>(t);
#pragma unroll
      for (int k1 = 0; k1 < 3; ++k1) y[k1][n2] = n2 * k1 ? cmul(t[k1], w_composite<R>(n2 * k1)) : t[k1];
    }
#pragma unroll
    for (int k1 = 0; k1 < 3; ++k1) {
      dft_points<R2>(y[k1]);
#pragma unroll
      for (int k2 = 0; k2 < R2; ++k2) v[k1 + 3 * k2] = y[k1][k2];
    }
  } else {
    static_assert(R == 7, "radix 2, 3, 4, 5, 7, 9, 11 or 15");
    // Pairs a_r = v_r + v_{7-r}, b_r = v_r - v_{7-r}; output k in 1-3 is
    // m_k - i n_k and output 7 - k is m_k + i n_k, with m_k = v0 + sum_r
    // cos(2 pi r k / 7) a_r and n_k = sum_r sin(2 pi r k / 7) b_r.
    const float2 a1 = cadd(v[1], v[6]), b1 = csub(v[1], v[6]), a2 = cadd(v[2], v[5]), b2 = csub(v[2], v[5]);
    const float2 a3 = cadd(v[3], v[4]), b3 = csub(v[3], v[4]);
    const float2 m1 = make_float2(v[0].x + kCos7a * a1.x + kCos7b * a2.x + kCos7c * a3.x,
                                  v[0].y + kCos7a * a1.y + kCos7b * a2.y + kCos7c * a3.y);
    const float2 m2 = make_float2(v[0].x + kCos7b * a1.x + kCos7c * a2.x + kCos7a * a3.x,
                                  v[0].y + kCos7b * a1.y + kCos7c * a2.y + kCos7a * a3.y);
    const float2 m3 = make_float2(v[0].x + kCos7c * a1.x + kCos7a * a2.x + kCos7b * a3.x,
                                  v[0].y + kCos7c * a1.y + kCos7a * a2.y + kCos7b * a3.y);
    const float2 n1 = make_float2(kSin7a * b1.x + kSin7b * b2.x + kSin7c * b3.x,
                                  kSin7a * b1.y + kSin7b * b2.y + kSin7c * b3.y);
    const float2 n2 = make_float2(kSin7b * b1.x - kSin7c * b2.x - kSin7a * b3.x,
                                  kSin7b * b1.y - kSin7c * b2.y - kSin7a * b3.y);
    const float2 n3 = make_float2(kSin7c * b1.x - kSin7a * b2.x + kSin7b * b3.x,
                                  kSin7c * b1.y - kSin7a * b2.y + kSin7b * b3.y);
    v[0] = cadd(cadd(cadd(v[0], a1), a2), a3);
    v[1] = make_float2(m1.x + n1.y, m1.y - n1.x);  // m1 - i n1
    v[6] = make_float2(m1.x - n1.y, m1.y + n1.x);  // m1 + i n1
    v[2] = make_float2(m2.x + n2.y, m2.y - n2.x);
    v[5] = make_float2(m2.x - n2.y, m2.y + n2.x);
    v[3] = make_float2(m3.x + n3.y, m3.y - n3.x);
    v[4] = make_float2(m3.x - n3.y, m3.y + n3.x);
  }
}

// One Stockham stage of radix R over `total` points in rows of p, in
// place: butterfly j of a row reads points j + r p / R, multiplies point r
// by w_{ns R}^{r (j mod ns)} (the table's entry r (j mod ns) n_fft / (ns
// R)), takes their R-point DFT and writes output r to (j - j mod ns) R + j
// mod ns + r ns. All reads, a barrier, all writes, a barrier. Butterfly e
// of the block (row e / q, j = e mod q, q = p / R, a multiple of ns) reads
// from e + (e / q)(p - q) and writes to e + (e / ns)(R - 1) ns, with j mod
// ns = e mod ns: the divisions by shifts where p is a power of two
// (kPow2), else by DivBy.
template <int R, bool kPow2>
__device__ __forceinline__ void fft_stage(float2* buf, int total, int p, int ns, int n_fft, const float2* tw) {
  constexpr int kItems = (kFftPoints / R + kThreadsA - 1) / kThreadsA;
  const int q = p / R, n = total / R, step = n_fft / (ns * R);
  const int lq = __ffs(q) - 1, lns = __ffs(ns) - 1;  // log2 q and log2 ns, where kPow2
  const DivBy by_q(q), by_ns(ns);
  float2 v[kItems][R];
#pragma unroll
  for (int it = 0; it < kItems; ++it) {
    const int e = threadIdx.x + it * kThreadsA;
    if (e < n) {
      const float2* src = buf + e + (kPow2 ? e >> lq : by_q(e)) * (p - q);
      const int k = kPow2 ? e & (ns - 1) : e - by_ns(e) * ns;
#pragma unroll
      for (int r = 0; r < R; ++r) v[it][r] = src[r * q];
#pragma unroll
      for (int r = 1; r < R; ++r) v[it][r] = cmul(v[it][r], twiddle(tw, r * k * step, n_fft));
      dft_points<R>(v[it]);
    }
  }
  __syncthreads();
#pragma unroll
  for (int it = 0; it < kItems; ++it) {
    const int e = threadIdx.x + it * kThreadsA;
    if (e < n) {
      float2* dst = buf + e + (kPow2 ? (e >> lns) << lns : by_ns(e) * ns) * (R - 1);
#pragma unroll
      for (int r = 0; r < R; ++r) dst[r * ns] = v[it][r];
    }
  }
  __syncthreads();
}

// Output pairs a thread holds in fft_stage_prime: a butterfly of prime
// radix P >= 11 has (P + 1) / 2 of them, at most 6 / 11 of its points.
constexpr int kPrimeItems = (kFftPoints / 11 * 6 + kThreadsA - 1) / kThreadsA;  // 18

// One Stockham stage of an odd prime radix P >= 11, a runtime value, over
// `total` points in rows of p, in place, with fft_stage's reads, twiddles
// and writes (butterfly e of the block reads from e + (e / q)(p - q) and
// writes to e + (e / ns)(P - 1) ns, q = p / P). Its P-point DFT is not
// held in registers: output k is sum_s x_s w_P^{(k s) mod P}, each power of
// w_P the table's entry ((k s) mod P) n_fft / P (P divides n_fft), so no
// instance's registers grow with P.
//  1. Points r and P - r of each butterfly (r in [1, P / 2]) times their
//     twiddles, replaced by a_r = x_r + x_{P-r} and b_r = x_r - x_{P-r};
//     a barrier.
//  2. The work splits by output pair: item (k, e) for k in [0, P / 2]
//     sums m_k = x_0 + sum_r cos(2 pi r k / P) a_r and n_k = sum_r sin(2 pi
//     r k / P) b_r, in r's order, into four floats (kPrimeItems items a
//     thread at most); consecutive threads take consecutive butterflies of
//     one k, so their reads are consecutive and their power of w_P one
//     broadcast. A barrier, then output k is m_k - i n_k and output P - k
//     m_k + i n_k (k = 0: m_0 alone), as dft_points<11> forms them; a
//     barrier.
// A stage costs P / 2 + 1 multiply-add pairs a point where dft_points<R>
// costs about R / 2.
__device__ __forceinline__ void fft_stage_prime(float2* buf, int total, int p, int ns, int n_fft,
                                                const float2* tw, int P) {
  const int q = p / P, nb = total / P, h = P / 2, step = n_fft / (ns * P), wstep = n_fft / P;
  const DivBy by_q(q), by_ns(ns), by_nb(nb);
  for (int e = threadIdx.x; e < nb * h; e += kThreadsA) {
    const int r = by_nb(e) + 1, j = e - (r - 1) * nb;
    float2* src = buf + j + by_q(j) * (p - q);
    const int k = j - by_ns(j) * ns;
    const float2 x = cmul(src[r * q], twiddle(tw, r * k * step, n_fft));
    const float2 y = cmul(src[(P - r) * q], twiddle(tw, (P - r) * k * step, n_fft));
    src[r * q] = cadd(x, y);
    src[(P - r) * q] = csub(x, y);
  }
  __syncthreads();
  float4 acc[kPrimeItems];
#pragma unroll
  for (int it = 0; it < kPrimeItems; ++it) {
    const int e = threadIdx.x + it * kThreadsA;
    if (e < nb * (h + 1)) {
      const int k = by_nb(e), j = e - k * nb;
      const float2* src = buf + j + by_q(j) * (p - q);
      float2 m = src[0], n = make_float2(0.0f, 0.0f);
      int idx = 0;  // (k r) mod P
#pragma unroll 1
      for (int r = 1; r <= h; ++r) {
        idx += k;
        if (idx >= P) idx -= P;
        const float2 w = twiddle(tw, idx * wstep, n_fft);  // (cos, -sin) of 2 pi idx / P
        const float2 a = src[r * q], b = src[(P - r) * q];
        m = make_float2(m.x + w.x * a.x, m.y + w.x * a.y);
        n = make_float2(n.x - w.y * b.x, n.y - w.y * b.y);
      }
      acc[it] = make_float4(m.x, m.y, n.x, n.y);
    }
  }
  __syncthreads();
#pragma unroll
  for (int it = 0; it < kPrimeItems; ++it) {
    const int e = threadIdx.x + it * kThreadsA;
    if (e < nb * (h + 1)) {
      const int k = by_nb(e), j = e - k * nb;
      float2* dst = buf + j + by_ns(j) * ns * (P - 1);
      const float4 v = acc[it];
      dst[k * ns] = make_float2(v.x + v.w, v.y - v.z);  // m_k - i n_k
      if (k) dst[(P - k) * ns] = make_float2(v.x - v.w, v.y + v.z);  // m_k + i n_k
    }
  }
  __syncthreads();
}

// fft_stage_prime as a call, not inlined, for the instances whose n_fft
// twiddles lie in shared memory: tw is taken again from the block's shared
// array, so that the call reads them with shared-memory loads whatever the
// compiler infers of its argument (left to infer it, it read them with
// generic loads, launch C's 2704 3% slower: PERF.md).
__device__ __noinline__ void fft_stage_prime_call(float2* buf, int total, int p, int ns, int n_fft, const float2* tw,
                                                  int P) {
#ifdef __CUDACC__
  extern __shared__ float4 smem4[];
  const char* smem = reinterpret_cast<const char*>(smem4);
  tw = reinterpret_cast<const float2*>(smem + (__cvta_generic_to_shared(tw) - __cvta_generic_to_shared(smem)));
#endif
  fft_stage_prime(buf, total, p, ns, n_fft, tw, P);
}

// The same for the instances with Bluestein's stage, whose n_fft twiddles
// may lie in device memory (LayoutF's twl1), which the call above must not
// take (its signature its own, so that the compiler keeps the two apart).
__device__ __noinline__ void fft_stage_prime_call_any(const float2* tw, float2* buf, int total, int p, int ns,
                                                      int n_fft, int P) {
  fft_stage_prime(buf, total, p, ns, n_fft, tw, P);
}

// fft_stage_prime in launch C's instance for a prime factor past 11
// (contrast_fft_kernel<11, true, 0>): inlined (1) or called (2). Called, it
// ran n_fft 1664 with contrast in 2.02 ms against 2.20 inlined, 650 in 2.06
// against 2.26, 2704 in 2.13 against 2.14 (B = 1024, in turns,
// tools/contrast_probe.py --primes); launch A inlines it: called, its 832
// at 256 mels and odd 1365 ran 4-6% slower (tools/spectral_probe.py).
constexpr int kPrimeC = 2;

// Bluestein's stage of radix R at ns: of m / ns, 15 where it divides it,
// else 9, else its least prime factor (3, 5, 7 or 11); so 675 = 15 15 3
// points take three stages, not five (3 3 3 5 5), 825 = 15 5 11 three, not
// four (ops/frontend_kernel.py::_blue_radices).
__device__ __forceinline__ int blue_radix(int m, int ns) {
  const int r = m / ns;
  return r % 15 == 0 ? 15 : r % 9 == 0 ? 9 : r % 3 == 0 ? 3 : r % 5 == 0 ? 5 : r % 7 == 0 ? 7 : 11;
}

// Bluestein's stage's operands (LayoutF): the prime P past kFftMaxPrime,
// the convolution's m points, the warps of a row's group (gw), the scratch
// (two rows of m points for each group, in the span's place) and the tables
// after the n_fft twiddles (ops/frontend_kernel.py::_bluestein_tables,
// float64 rounded once): the chirp c_s = e^{-pi i s^2 / P} for s in [0,
// P), then B^ = FFT_m(b) / m of the wrapped conjugate chirp (b_t = conj c_t
// and b_{m-t} = conj c_t for t in [0, P), zeros between), staged or in
// device memory (LayoutF's twl1), and the FFT_m stages' twiddles, staged
// (LayoutF's blue): for each stage of radix R at ns, from the first, its
// ns (R - 1) twiddles w_{ns R}^{r k} at k (R - 1) + r - 1 for k < ns and r
// in [1, R), m - 1 in all, so a butterfly reads its R - 1 in a row and no
// index is reduced past m / 2.
struct Bluestein {
  int P, m, gw;
  float2* scratch;
  const float2* chirp;  // then B^
  const float2* tw;

  __device__ Bluestein(const LayoutF& lay, float* base, const float2* tables, int n_fft)
      : P(lay.bp), m(lay.bm), gw(lay.gw), scratch(reinterpret_cast<float2*>(base + lay.span)),
        chirp((lay.twl1() ? tables : reinterpret_cast<const float2*>(base + lay.tw)) + n_fft / 2 + 1),
        tw(reinterpret_cast<const float2*>(base + lay.blue)) {}
  __device__ const float2* bhat() const { return chirp + P; }
};

// The FFT_m stages of both of Bluestein's transforms (count) and the last
// one's radix, counted where the stage runs, not in Bluestein's
// constructor, which the instances without the stage build too.
struct BlueStages {
  int count = 0, last = 1;
  __device__ explicit BlueStages(int m) {
    for (int ns = 1; ns < m; ns *= last, count += 2) last = blue_radix(m, ns);
  }
};

// Bluestein's stage in an instance: 0 none, 1 inlined. Both launches
// inline it: called (a __noinline__ wrapper; the probes' variant), launch
// A's 2192 ran 1.52 ms against 1.30-1.33 inlined and launch C's 3.72-3.73
// against 3.00-3.10 (B = 1024, in turns, tools/*_probe.py --primes;
// PERF.md).
__device__ __forceinline__ void fft_stage_bluestein(float2* buf, int total, int p, const Bluestein& bl);
constexpr int kBluesteinA = 1;
constexpr int kBluesteinC = 1;

// fft_rows for p = 2^a 3^b 5^c 7^d 11^e P1 P2 ... (primes P_i > 11) that is
// not a power of two: one of radix 2 when a is odd, then radix 4, then the
// 3s, the 5s, the 7s, the 11s, then one fft_stage_prime for each larger
// prime factor, smallest first, with multiplicity, up to kFftMaxPrime,
// and past it fft_stage_bluestein, first (ns = 1, on rows that BlueOrder
// packed: a row has at most one such prime, the largest). kRadix, the
// instance's largest odd radix
// in registers (7 or 11); kPrime, whether the instance runs the primes
// past it by fft_stage_prime (0 not at all: p then has none; 1 inlined; 2
// called); kBluestein, whether it runs a prime past kFftMaxPrime by
// Bluestein's stage (0 not at all; 1 inlined; bl its operands):
// see fft_rows.
template <int kRadix, int kPrime, int kBluestein>
__device__ __forceinline__ void fft_rows_mixed(float2* buf, int total, int p, int n_fft, const float2* tw,
                                               const Bluestein* bl) {
  static_assert(kRadix == 7 || kRadix == 11, "an instance of radix 7 or 11");
  static_assert(kBluestein == 0 || kPrime != 0, "Bluestein's stage in an instance of the prime stage");
  int twos = 0, threes = 0, sevens = 1, elevens = 1, rest = 1;  // 7^d, 11^e, and the primes past kRadix's product
  for (int r = p; r % 2 == 0; r /= 2) ++twos;
  for (int r = p >> twos; r % 3 == 0; r /= 3) ++threes;
  for (int r = p; r % 7 == 0; r /= 7) sevens *= 7;
  if constexpr (kRadix == 11)
    for (int r = p; r % 11 == 0; r /= 11) elevens *= 11;
  if constexpr (kPrime != 0) {
    for (rest = p >> twos; rest % 3 == 0;) rest /= 3;
    while (rest % 5 == 0) rest /= 5;
    rest /= sevens * elevens;
  }
  int ns = 1;
  if constexpr (kBluestein != 0)
    if (bl->P) {
      fft_stage_bluestein(buf, total, p, *bl);
      ns = bl->P;
      rest /= bl->P;
    }
  if (twos & 1) {
    fft_stage<2, false>(buf, total, p, ns, n_fft, tw);
    ns *= 2;
  }
  for (int i = 0; i < twos / 2; ++i, ns *= 4) fft_stage<4, false>(buf, total, p, ns, n_fft, tw);
  for (int i = 0; i < threes; ++i, ns *= 3) fft_stage<3, false>(buf, total, p, ns, n_fft, tw);
  for (; ns < p / (sevens * elevens * rest); ns *= 5) fft_stage<5, false>(buf, total, p, ns, n_fft, tw);
  for (; ns < p / (elevens * rest); ns *= 7) fft_stage<7, false>(buf, total, p, ns, n_fft, tw);
  if constexpr (kRadix == 11)
    for (; ns < p / rest; ns *= 11) fft_stage<11, false>(buf, total, p, ns, n_fft, tw);
  if constexpr (kPrime != 0)
    while (rest > 1) {  // its smallest prime factor
      int f = 11;
      while (f * f <= rest && rest % f) f += 2;
      if (f * f > rest) f = rest;
      if constexpr (kPrime == 1)
        fft_stage_prime(buf, total, p, ns, n_fft, tw, f);
      else if constexpr (kBluestein != 0)
        fft_stage_prime_call_any(tw, buf, total, p, ns, n_fft, f);
      else
        fft_stage_prime_call(buf, total, p, ns, n_fft, tw, f);
      ns *= f;
      rest /= f;
    }
}

// The FFT of each row of p points in buf (rows x p <= kFftPoints), in
// natural order, in place; w = e^{-2 pi i / n_fft} from the table. The
// stages (ops/frontend_kernel.py::_fft_radices): for a
// power of two, one of radix 2 when log2 p is odd, then radix 4; else
// fft_rows_mixed's. The power-of-two path keeps its shifts: with DivBy's
// multiplies there, in the same kernel as the mixed stages, the registers
// crowd and launch C's power-of-two plans lose time
// (tools/contrast_probe.py's "DivBy for a power of two" variant; PERF.md).
// The instances, by the numbers (tools/spectral_probe.py,
// tools/contrast_probe.py, in turns with the earlier sources; PERF.md):
// launch A runs every n_fft through one instance of radix 11 (with radix 7
// in one instance its 2, 3 and 5 plans had lost 0.3-1.0%; with radix 11
// and its odd rows they ran as fast as in their own instances, within 1%
// either way); launch C keeps its instance of radix 7 for every n_fft
// without a factor of 11 (radix 7 compiled in ran its 2, 3 and 5 plans as
// fast or up to 2.4% faster, its spills moved), and takes its instance of
// radix 11 for a factor of 11 (through it, n_fft 3000 lost 5-7% in two
// runs, 2000 0-8%), and a third instance, radix 11 with fft_stage_prime,
// for a prime factor past 11: compiled into its radix-11 instance, the
// generic stage cost that instance's plans 15-17% (n_fft 2662 and 1760,
// inlined or called), and into its radix-7 one 25-30% (2048, 2000, 1792,
// 1323), in turns with the source before it (tools/contrast_probe.py
// --primes);
// compiled into launch A's one instance it moved its plans 0.4-2.4%.
template <int kRadix, int kPrime, int kBluestein = 0>
__device__ __forceinline__ void fft_rows(float2* buf, int rows, int p, int n_fft, const float2* tw,
                                         const Bluestein* bl = nullptr) {
  const int total = rows * p;
  if (kBluestein != 0 || (p & (p - 1))) {  // (a prime past the cap: no power of two)
    fft_rows_mixed<kRadix, kPrime, kBluestein>(buf, total, p, n_fft, tw, bl);
    return;
  }
  int ns = 1;
  if ((__ffs(p) - 1) & 1) {
    fft_stage<2, true>(buf, total, p, ns, n_fft, tw);
    ns = 2;
  }
  for (; ns < p; ns *= 4) fft_stage<4, true>(buf, total, p, ns, n_fft, tw);
}

// The threads of a group of warps meet at named barrier `id` (1 to 15;
// __syncthreads takes 0).
#ifdef __CUDACC__
__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}
#endif

// The threads of Bluestein's row group meet: its warp, or its gw warps at
// its named barrier.
__device__ __forceinline__ void group_sync(int gw, int id) {
  if (gw == 1)
    __syncwarp();
  else
    bar_sync(id, 32 * gw);
}

// What a stage of Bluestein's rows reads and writes besides its rows: the
// first stage of the first FFT_m gathers its points from the butterfly's
// in buf (kGather), the first of the second reads its row times B^,
// conjugated (kBhat), the last of the second scatters to the butterfly's
// points (kScatter); the others read and write the rows alone (kRow).
enum { kRow = 0, kGather = 1, kBhat = 2, kScatter = 3 };

// Where a row of p = q P points lies in buf for Bluestein's stage, which
// runs first (ns = 1): butterfly j reads points j + s q and writes output
// k to j P + k, so the rows are packed with point j + s q at j P + s, each
// butterfly's P points in consecutive words (point e of the row at
// BlueOrder(e)). Read in natural order (consecutive threads on consecutive
// points of a butterfly, every q-th of the row), n_fft 5296's q = 8 put 16
// of a warp's float2 reads in one bank pair. kOn: whether the instance runs
// Bluestein's stage (else natural order, the instance's code as without
// it); its P 0 where the n_fft has no prime past kFftMaxPrime (launch C's
// wide instance of radix 11 takes those too).
template <bool kOn>
struct BlueOrder {
  int q, P;
  DivBy by_q;
  __device__ BlueOrder(int p, int P_) : q(P_ ? p / P_ : 1), P(P_), by_q(q) {}
  __device__ int operator()(int e) const {
    if (!P) return e;
    const int s = by_q(e);
    return (e - s * q) * P + s;
  }
};

template <>
struct BlueOrder<false> {
  __device__ BlueOrder(int, int) {}
  __device__ int operator()(int e) const { return e; }
};

// One out-of-place Stockham stage of radix R over a group's row of m
// points (gw warps, 32 gw lanes; `lane` the thread's place in the group),
// from src to dst: butterfly j reads points j + r m / R, multiplies point r
// by w_{ns R}^{r (j mod ns)} from the stage's twiddles (tw), takes their
// R-point DFT and writes output r to (j - j mod ns) R + j mod ns + r ns:
// fft_stage's arithmetic, a lane's butterflies one at a time, then the
// group meets, and no block barrier. The modes, each a few warp-uniform
// tests in one body (a body a mode took the build of launch C's Bluestein
// instances from ~31 to ~49 s):
//  - kGather (the first stage, ns = 1: no twiddles): point s < P is x_s
//    c_s, x the butterfly's points in buf (BlueOrder: x[s]), zeros from P
//    on;
//  - kBhat: each point times B^ (1 / m in it), conjugated;
//  - kScatter (the last stage, ns R = m: output r of butterfly j is point j
//    + r ns): X_k = c_k conj(z_k) for k < P, to x[k].
template <int R>
__device__ __forceinline__ void blue_stage(const float2* src, float2* dst, int ns, int mode, const Bluestein& bl,
                                           const float2* tw, float2* x, int lane, int bar) {
  const int m = bl.m, q = m / R, lanes = 32 * bl.gw;
  const DivBy by_ns(ns);
  const float2* in = mode == kGather ? x : src;
  const int in_lim = mode == kGather ? bl.P : m, out_lim = mode == kScatter ? bl.P : m;
  const float2* pre = mode == kGather ? bl.chirp : mode == kBhat ? bl.bhat() : nullptr;
  float2* out = mode == kScatter ? x : dst;
  for (int j = lane; j < q; j += lanes) {
    const int k = j - by_ns(j) * ns;
    float2 v[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int i = j + r * q;
      v[r] = i < in_lim ? in[i] : make_float2(0.0f, 0.0f);
      if (pre) {
        const float2 z = cmul(v[r], pre[i]);
        v[r] = make_float2(z.x, mode == kBhat ? -z.y : z.y);
      }
    }
    if (ns > 1) {
      const float2* t = tw + k * (R - 1);
#pragma unroll
      for (int r = 1; r < R; ++r) v[r] = cmul(v[r], t[r - 1]);
    }
    dft_points<R>(v);
    const int d = (j - k) * R + k;  // (j + r ns in the last stage, k = j)
#pragma unroll
    for (int r = 0; r < R; ++r)
      if (d + r * ns < out_lim)
        out[d + r * ns] = mode == kScatter ? cmul(make_float2(v[r].x, -v[r].y), bl.chirp[d + r * ns]) : v[r];
  }
  group_sync(bl.gw, bar);  // every write before the next stage's reads, every read before its writes
}

__device__ __forceinline__ void blue_stage_at(const float2* src, float2* dst, int ns, int mode, const Bluestein& bl,
                                              const float2* tw, float2* x, int lane, int bar) {
  switch (blue_radix(bl.m, ns)) {
    case 3: blue_stage<3>(src, dst, ns, mode, bl, tw, x, lane, bar); break;
    case 5: blue_stage<5>(src, dst, ns, mode, bl, tw, x, lane, bar); break;
    case 9: blue_stage<9>(src, dst, ns, mode, bl, tw, x, lane, bar); break;
    case 15: blue_stage<15>(src, dst, ns, mode, bl, tw, x, lane, bar); break;
    case 7: blue_stage<7>(src, dst, ns, mode, bl, tw, x, lane, bar); break;
    default: blue_stage<11>(src, dst, ns, mode, bl, tw, x, lane, bar);
  }
}

// The first Stockham stage, of a prime radix P past kFftMaxPrime, by
// Bluestein's chirp-z: the P-point DFT X_k = sum_s x_s w_P^{ks} is c_k
// (a * b)_k with a_s = x_s c_s, b_t = conj c_t and c_s = e^{-pi i s^2 / P}
// (k s = (k^2 + s^2 - (k - s)^2) / 2), the cyclic convolution of m >= 2P -
// 1 points computed by FFTs of m points (m odd and 11-smooth: radix
// stages, nothing recurses). The first stage (ns = 1: no twiddles):
// butterfly j of a row reads its points j + s q (q = p / P) and writes
// output k to j P + k, both at j P + s in a row that BlueOrder packed, so
// no butterfly reads another's points and each reads and writes
// consecutive words. Each group of gw warps (LayoutF) takes butterflies g,
// g + groups, ... on its own, through its own two rows of m points in the
// scratch, every warp of the block so busy: FFT_m (blue_stage, out of
// place from one row to the other), its first stage gathering a_s from the
// butterfly's points, then FFT_m again, its first stage reading each point
// times B^ and conjugated, its last writing c_k conj(z_k) for k < P back to
// the butterfly's points (the conjugate of the convolution's conjugate).
// The group meets at its warp's __syncwarp or its named barrier once a
// stage; the block meets once, after the stage (the packing before ends at
// a barrier). The first design (the stage last; the block gathering into
// scratch rows, two out-of-place warp FFTs a row on up to 8 warps, the
// block scattering; three block barriers a pass) ran launch A at n_fft 5296
// in 3.09 ms, its warp FFTs 1.88 of it, against torch.stft + mel's 1.66; a
// stage held in a lane's registers, in place (all of a lane's butterflies
// loaded, the group meeting, then stored), spilled and ran 2-4x slower;
// gathering and scattering the stage last, at a stride of q points, cost
// 0.49 of 2.62 ms there (PERF.md).
// A stage costs two FFTs of m points, O(m log m), a butterfly, where
// fft_stage_prime costs P / 2 + 1 multiply-add pairs a point.
__device__ __forceinline__ void fft_stage_bluestein(float2* buf, int total, int p, const Bluestein& bl) {
  const int q = p / bl.P, nb = total / bl.P;
  const int group = (threadIdx.x >> 5) / bl.gw, groups = kWarpsA / bl.gw;
  const int lane = threadIdx.x - 32 * bl.gw * group, bar = 1 + group;
  float2* a = bl.scratch + 2 * group * bl.m;
  float2* b = a + bl.m;
  const DivBy by_q(q);
  const BlueStages stages(bl.m);
  for (int c = group; c < nb; c += groups) {
    const int r = by_q(c);
    float2* x = buf + r * p + (c - r * q) * bl.P;
    blue_stage_at(nullptr, a, 1, kGather, bl, bl.tw, x, lane, bar);
    int ns = blue_radix(bl.m, 1);
    const float2* tw = bl.tw + ns - 1;  // the stage's twiddles (past the first stage's, all 1)
    for (int s = 1; s + 1 < stages.count; ++s) {
      const int first = ns == bl.m;  // the second FFT's first stage
      if (first) {
        ns = 1;
        tw = bl.tw;
      }
      const int r = blue_radix(bl.m, ns);
      blue_stage_at(a, b, ns, first ? kBhat : kRow, bl, tw, x, lane, bar);
      float2* t = a;
      a = b;
      b = t;
      tw += ns * (r - 1);
      ns *= r;
    }
    blue_stage_at(a, nullptr, bl.m / stages.last, kScatter, bl, tw, x, lane, bar);
  }
  __syncthreads();
}

// One frame's contrast in one band, by a warp, for the FFT plan: bands of
// up to kWideBand bins sorted in registers (band_sorted_frames, one frame;
// wider ones take block_tails).
static_assert(kWideBand <= 512, "band_value_sorted sorts up to 512 bins");
__device__ __forceinline__ float band_value_sorted(const float* pb, int4 bd, int lane) {
  const int w = bd.y, nt = bd.z, nb = bd.w;
  const float* b = pb + bd.x;
  float v[1] = {0.0f};
  if (w > 256)
    band_sorted_frames<512, 1>(b, 0, w, nt, nb, lane, v);
  else if (w > 128)
    band_sorted_frames<256, 1>(b, 0, w, nt, nb, lane, v);
  else if (w > 64)
    band_sorted_frames<128, 1>(b, 0, w, nt, nb, lane, v);
  else if (w > 32)
    band_sorted_frames<64, 1>(b, 0, w, nt, nb, lane, v);
  else if (w > 1)
    band_sorted_frames<32, 1>(b, 0, w, nt, nb, lane, v);
  return v[0];
}

// The digit (0-255) whose counter in h (256 counters in shared memory, the
// values that share the bits fixed so far, by their next 8 bits) holds
// ascending rank r, by a warp: lane l adds up counters [8 l, 8 l + 8), an
// exclusive scan over the lanes (xor shuffles) finds the lane where the
// counts pass r, which walks its 8. Returns the digit in d, the values
// under it in below and its counter in eq, in every lane.
__device__ __forceinline__ void digit_of_rank(const unsigned* h, unsigned r, int lane, int& d, unsigned& below,
                                              unsigned& eq) {
  const uint4 a = reinterpret_cast<const uint4*>(h)[2 * lane], b = reinterpret_cast<const uint4*>(h)[2 * lane + 1];
  const unsigned c[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
  unsigned s = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) s += c[i];
  unsigned incl = s, total = s;  // the lanes' inclusive scan, by xor partners
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const unsigned y = __shfl_xor_sync(0xffffffffu, total, off);
    if (lane & off) incl += y;
    total += y;
  }
  const int src = __ffs(__ballot_sync(0xffffffffu, incl > r)) - 1;
  unsigned acc = incl - s, at = 0;
  int k = 0;
  bool go = true;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const bool pass = go && acc + c[i] <= r;
    at = go && !pass ? c[i] : at;  // the counter that holds r
    go = pass;
    acc += pass ? c[i] : 0;
    k += pass;
  }
  d = 8 * src + __shfl_sync(0xffffffffu, k, src);
  below = __shfl_sync(0xffffffffu, acc, src);
  eq = __shfl_sync(0xffffffffu, at, src);
}

// The two tails' sums (top, bottom) of one frame's band of w bins at pb,
// by the whole block, in every thread: an exact selection whose work
// follows the bins over the block's warps, where ranking (band_tails) takes
// w^2 compares on one warp and band_value_sorted sorts at most 512 bins. The
// n_top-th largest value t and the n_bot-th smallest b come from a radix
// select over the values' bits (a power is never negative, so its bits
// order as an unsigned integer's), 8 bits a pass from the top, both tails
// at once: each pass counts the values that share the bits fixed so far by
// their next 8 bits, in 256 counters in shared memory, and every warp then
// finds the digit that holds the wanted rank (digit_of_rank). Then top =
// the sum of x > t plus (n_top - |{x > t}|) t, and the bottom tail
// likewise: as band_value_sorted's, independent of how ties are broken. hist: 3
// x 512 counters, then 2 kWarpsA floats, in shared memory: pass q (five an
// item: four digits, then the sums) counts into the q % 3 set and zeroes
// the next before its one barrier; the q % 3 set is zero on entry.
__device__ __forceinline__ float2 block_tails(const float* pb, int w, int n_top, int n_bot, unsigned* hist,
                                              int& q) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const unsigned* x = reinterpret_cast<const unsigned*>(pb);
  unsigned key[2] = {0u, 0u}, rank[2] = {(unsigned)(w - n_top), (unsigned)(n_bot - 1)}, eq[2];
  for (int shift = 24; shift >= 0; shift -= 8, ++q) {
    unsigned* h = hist + q % 3 * 512;
    unsigned* next = hist + (q + 1) % 3 * 512;
    const unsigned hi = shift == 24 ? 0u : ~0u << (shift + 8);  // the bits fixed so far
    for (int e = tid; e < w; e += kThreadsA) {
      const unsigned v = x[e], digit = v >> shift & 255u;
      if ((v & hi) == key[0]) atomicAdd(h + digit, 1u);
      if ((v & hi) == key[1]) atomicAdd(h + 256 + digit, 1u);
    }
    for (int i = tid; i < 512; i += kThreadsA) next[i] = 0u;
    __syncthreads();
#pragma unroll
    for (int t = 0; t < 2; ++t) {
      int d;
      unsigned below;
      digit_of_rank(h + 256 * t, rank[t], lane, d, below, eq[t]);
      rank[t] -= below;
      key[t] |= (unsigned)d << shift;
    }
  }
  const float t = __uint_as_float(key[0]), b = __uint_as_float(key[1]);
  float top = 0.0f, bot = 0.0f;
  for (int e = tid; e < w; e += kThreadsA) {
    const float v = pb[e];
    top += v > t ? v : 0.0f;
    bot += v < b ? v : 0.0f;
  }
  top = warp_sum(top);
  bot = warp_sum(bot);
  float* part = reinterpret_cast<float*>(hist + 3 * 512);
  if (lane == 0) {
    part[warp] = top;
    part[kWarpsA + warp] = bot;
  }
  unsigned* next = hist + (q + 1) % 3 * 512;
  for (int i = tid; i < 512; i += kThreadsA) next[i] = 0u;
  __syncthreads();
  ++q;
  top = bot = 0.0f;
#pragma unroll
  for (int i = 0; i < kWarpsA; ++i) {
    top += part[i];
    bot += part[kWarpsA + i];
  }
  // |{x > t}| = n_top + rank - eq (rank: t's among the values equal to it);
  // |{x < b}| = n_bot - 1 - rank.
  const int n_gt = n_top + (int)rank[0] - (int)eq[0], n_lt = n_bot - 1 - (int)rank[1];
  return make_float2(top + (float)(n_top - n_gt) * t, bot + (float)(n_bot - n_lt) * b);
}

// Step 4 of the FFT plan for its bands past kWideBand bins: each (frame,
// band) by the whole block (block_tails), one after another. pw: the
// group's power rows (n_pow a frame); con: the clip's rows from the
// group's first frame; hist: block_tails' scratch (the FFT rows' place).
// Called by every thread, after the barrier that completes pw; a call,
// so that the instances' other plans keep their registers.
__device__ __noinline__ void wide_bands(const float* pw, int n_pow, const int4* bands, int n_bands, int frames,
                                        float* con, int n_frames, unsigned* hist) {
  for (int i = threadIdx.x; i < 512; i += kThreadsA) hist[i] = 0u;
  __syncthreads();
  int q = 0;
  for (int f = 0; f < frames; ++f)
    for (int i = 0; i < n_bands; ++i) {
      const int4 bd = __ldg(bands + i);
      if (bd.y <= kWideBand) continue;
      const float2 s = block_tails(pw + f * n_pow + bd.x, bd.y, bd.z, bd.w, hist, q);
      if (threadIdx.x == 0) con[i * n_frames + f] = log1pf(s.x / (float)bd.z) - log1pf(s.y / (float)bd.w);
    }
}

// A group's span into shared memory: samples [0, len) of `src`.
__device__ __forceinline__ void stage_flat(float* span, const WaveSrc& src, int len) {
  for (int i = threadIdx.x; i < len; i += kThreadsA) span[i] = src.at(i);
}

// LayoutF's tables into shared memory from lay.tw: all of them, or, where
// the others are read through L1 (l1), Bluestein's FFT_m stages' twiddles alone.
__device__ __forceinline__ void stage_tables(float* base, const float2* tables, const LayoutF& lay, bool l1,
                                             int n_fft) {
  const int skip = l1 ? n_fft / 2 + 1 + lay.bp + lay.bm : 0;
  float2* dst = reinterpret_cast<float2*>(base + lay.tw);
  for (int i = skip + threadIdx.x; i < lay.tables; i += kThreadsA) dst[i - skip] = tables[i];
}

// Launch A, FFT plan. grid (batch x groups): block i takes clip i / groups
// and its frames [t0, t0 + frames) from t0 = (i % groups) * frames (LayoutF's
// frames); window (n_fft) the padded win_length Hann; twiddles (n_fft / 2 +
// 1 float2); fb_w the filters' nonzero weights, mel by mel, and fb_ranges
// (n_mels x 3) per mel its first bin, bins and offset in fb_w; past the
// twiddles, Bluestein's tables where the n_fft has a prime past
// kFftMaxPrime (LayoutF's tables). One instance for every n_fft without
// such a prime: its stages of radix 2 to 11 and of larger primes
// (fft_rows), and on an odd n_fft two frames a row of n_fft points; and
// one with Bluestein's stage (kBluestein, kBluesteinA) for those with one,
// so that the others' plans keep their registers.
template <int kBluestein>
__global__ void __launch_bounds__(kThreadsA, 2) spectral_fft_kernel(
    const float* __restrict__ wave, int n_samples, int n_frames, int n_fft, int hop,
    const float* __restrict__ window, const float2* __restrict__ twiddles, const LayoutF lay, int n_used,
    const float* __restrict__ fb_w, const int* __restrict__ fb_ranges, int n_mels, int use_pre,
    float pre_coef, float* __restrict__ mel_out) {
  extern __shared__ float4 smem4[];
  float* base = reinterpret_cast<float*>(smem4);
  float2* buf = reinterpret_cast<float2*>(base);
  float* span = base + lay.span;
  // The n_fft twiddles: staged, or through L1 where LayoutF says so (in
  // the instance with Bluestein's stage; twl1).
  const bool l1 = kBluestein != 0 && lay.twl1();
  const float2* tw = reinterpret_cast<const float2*>(base + lay.tw);
  if constexpr (kBluestein != 0)
    if (l1) tw = twiddles;
  const int m = n_fft / 2;
  const bool pairs = n_fft % 2;  // two frames a row (F is even)
  const int points = pairs ? n_fft : m;
  const int groups = (n_frames + lay.frames - 1) / lay.frames;
  // The instance with Bluestein's stage spreads a clip's frames evenly
  // over its groups (n_fft 1048 at hop 262: 13 frames a block, not 15 and
  // a last block of 2), so its blocks' stages run fewer rows; the other
  // keeps LayoutF's frames.
  int F = lay.frames;
  if constexpr (kBluestein != 0) {
    F = (n_frames + groups - 1) / groups;
    F += pairs && F % 2;
  }
  const int rows = pairs ? F / 2 : F;
  const int b = blockIdx.x / groups, t0 = blockIdx.x % groups * F, frames = min(F, n_frames - t0);
  const int tid = threadIdx.x;

  // 1. The tables, and the group's span: reflect padding and
  // pre-emphasis, zeros past its last frame.
  stage_tables(base, twiddles, lay, l1, n_fft);
  WaveSrc src;
  src.x = wave + (size_t)b * n_samples;
  src.n_samples = n_samples;
  src.base = t0 * hop - n_fft / 2;
  src.live = (frames - 1) * hop + n_fft;
  src.use_pre = use_pre;
  src.pre_coef = pre_coef;
  stage_flat(span, src, (F - 1) * hop + n_fft);
  __syncthreads();

  // 2. Each windowed frame's n_fft reals as m complex points; on an odd
  // n_fft, frames 2j and 2j + 1 of the group as the real and imaginary
  // parts of row j's n_fft points, zeros for a frame past the clip's last.
  // A row's points in BlueOrder where Bluestein's stage runs first.
  const BlueOrder<kBluestein != 0> order(points, lay.bp);
  if (pairs) {
    const DivBy by_n(n_fft);
    for (int e = tid; e < rows * n_fft; e += kThreadsA) {
      const int j = by_n(e), n = e - j * n_fft;
      const float* x = span + 2 * j * hop + n;
      const float wn = __ldg(window + n);
      buf[j * n_fft + order(n)] =
          make_float2(2 * j < frames ? x[0] * wn : 0.0f, 2 * j + 1 < frames ? x[hop] * wn : 0.0f);
    }
  } else {
    const DivBy by_m(m);
    for (int e = tid; e < F * m; e += kThreadsA) {
      const int f = by_m(e), n = 2 * (e - f * m);
      const float* x = span + f * hop + n;
      buf[f * m + order(e - f * m)] = make_float2(x[0] * __ldg(window + n), x[1] * __ldg(window + n + 1));
    }
  }
  __syncthreads();

  // 3. The FFT of each row's points.
  const Bluestein bl(lay, base, twiddles, n_fft);
  fft_rows<11, 1, kBluestein>(buf, rows, points, n_fft, tw, &bl);

  // 4. The real FFT's bins [0, n_used), their power in registers, then in
  // place of the points: F rows of an odd stride, so that the mel's reads
  // of consecutive frames fall in distinct banks. On an odd n_fft, frame
  // 2j's bin k is (Z[k] + conj Z[n - k]) / 2 and frame 2j + 1's (Z[k] -
  // conj Z[n - k]) / 2i of row j, whose power is that of (Z[k].y + Z[n -
  // k].y, Z[k].x - Z[n - k].x) / 2.
  const int stride = n_used | 1;
  float pw[kPostItems];
#pragma unroll
  for (int it = 0; it < kPostItems; ++it) {
    const int e = tid + it * kThreadsA;
    if (e < F * n_used) {
      const int f = e / n_used, k = e - f * n_used;
      float re, im;
      if (pairs) {
        const float2* z = buf + (f >> 1) * n_fft;
        const float2 a = z[k], c = z[k == 0 ? 0 : n_fft - k];  // Z[k], Z[n - k] mod n
        re = 0.5f * (f & 1 ? a.y + c.y : a.x + c.x);
        im = 0.5f * (f & 1 ? a.x - c.x : a.y - c.y);
      } else {
        const float2 a = buf[f * m + (k == m ? 0 : k)], c = buf[f * m + (k == 0 ? 0 : m - k)];  // Z[k], Z[m - k] mod m
        const float2 ev = make_float2(0.5f * (a.x + c.x), 0.5f * (a.y - c.y));
        const float2 d = make_float2(0.5f * (a.x - c.x), 0.5f * (a.y + c.y));
        const float2 od = cmul(tw[k], make_float2(d.y, -d.x));  // w^k (-i d)
        re = ev.x + od.x;
        im = ev.y + od.y;
      }
      pw[it] = re * re + im * im;
    }
  }
  __syncthreads();
  float* power = base;
#pragma unroll
  for (int it = 0; it < kPostItems; ++it) {
    const int e = tid + it * kThreadsA;
    if (e < F * n_used) {
      const int f = e / n_used;
      power[f * stride + e - f * n_used] = pw[it];
    }
  }
  __syncthreads();

  // 5. The mel over each filter's nonzero bins, (B, n_mels, n_frames),
  // frames fastest.
  for (int e = tid; e < F * n_mels; e += kThreadsA) {
    const int mel = e / F, f = e - mel * F;
    if (f >= frames) continue;
    const int lo = __ldg(fb_ranges + 3 * mel), cnt = __ldg(fb_ranges + 3 * mel + 1);
    const float* w = fb_w + __ldg(fb_ranges + 3 * mel + 2);
    const float* p = power + f * stride + lo;
    float acc = 0.0f;
    for (int i = 0; i < cnt; ++i) acc = fmaf(__ldg(w + i), p[i], acc);
    mel_out[((size_t)b * n_mels + mel) * n_frames + t0 + f] = acc;
  }
}

// Launch C, FFT plan. grid (batch): block b takes clip b and loops over its
// groups of LayoutF's frames; windows (2 x n_fft): the padded win_length
// Hann (the bands' power), then the n_fft Hann (the centroid's magnitude);
// twiddles (n_fft / 2 + 1 float2); the power rows cover bins [pow_lo, pow_lo
// + n_pow); freqs, bands and out as contrast_kernel's. kRadix: the
// instance's largest odd radix in registers; kPrime: whether it runs the
// prime factors past 11 by fft_stage_prime; kBluestein: whether it runs
// one past kFftMaxPrime by Bluestein's stage, its tables past the
// twiddles (fft_rows); kWide: whether it runs bands past kWideBand bins,
// by the block (wide_bands), in instances of their own, so that the
// others' plans keep their code (with the wider bands' path in every
// instance, as a call taken where a band passes kWideBand, n_fft 2048,
// 4096, 2704 and 1664 ran 1.6-5.1% slower than without it; PERF.md).
template <int kRadix, bool kPrime, int kBluestein, bool kWide>
__global__ void __launch_bounds__(kThreadsA, 2) contrast_fft_kernel(
    const float* __restrict__ wave, int n_samples, int n_frames, int n_fft, int hop,
    const float* __restrict__ windows, const float2* __restrict__ twiddles, const LayoutF lay, int pow_lo,
    int n_pow, const float* __restrict__ freqs, float half_sr, const int4* __restrict__ bands, int n_bands,
    float* __restrict__ out) {
  extern __shared__ float4 smem4[];
  const int n_rows = n_bands + 1, n = n_rows * n_frames, half = n_fft / 2;
  float* base = reinterpret_cast<float*>(smem4);
  float2* buf = reinterpret_cast<float2*>(base);
  float* span = base + lay.span;
  float2* tw = reinterpret_cast<float2*>(base + lay.tw);
  float* pw = base + lay.pow;
  float* con = out + (size_t)blockIdx.x * n;  // the clip's rows, z-normed in place at the end
  float* red = base + lay.red;
  const int F = lay.frames, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tpf = kThreadsA / F;  // threads a frame in the split (F a power of two: LayoutF)
  const int f_own = tid / tpf, l_own = tid - f_own * tpf;
  const DivBy by_n(n_fft);

  // The tables; the n_fft twiddles the FFT reads (twr), staged, or through
  // L1 where LayoutF says so. The instances without Bluestein's stage keep
  // the code they had before it, line for line (their instructions, by
  // tools/spectral_probe.py --turns, as an older source's).
  const float2* twr = tw;
  if constexpr (kBluestein != 0) {
    stage_tables(base, twiddles, lay, lay.twl1(), n_fft);
    if (lay.twl1()) twr = twiddles;
  } else {
    for (int i = tid; i < lay.tables; i += kThreadsA) tw[i] = twiddles[i];
  }
  const Bluestein bl(lay, base, twiddles, n_fft);
  const BlueOrder<kBluestein != 0> order(n_fft, lay.bp);
  WaveSrc src;
  src.x = wave + (size_t)blockIdx.x * n_samples;
  src.n_samples = n_samples;
  src.use_pre = 0;
  src.pre_coef = 0.0f;
  for (int t0 = 0; t0 < n_frames; t0 += F) {
    // 1. The group's span, then its frames through both windows (a row in
    // BlueOrder where Bluestein's stage runs first).
    const int frames = min(F, n_frames - t0);
    __syncthreads();  // the twiddles are in place; the last group's rows are read
    src.base = t0 * hop - half;
    src.live = (frames - 1) * hop + n_fft;
    stage_flat(span, src, (F - 1) * hop + n_fft);
    __syncthreads();
    for (int e = tid; e < F * n_fft; e += kThreadsA) {
      const int f = by_n(e), k = e - f * n_fft;
      const float x = span[f * hop + k];
      buf[kBluestein != 0 ? f * n_fft + order(k) : e] =
          make_float2(__ldg(windows + k) * x, __ldg(windows + n_fft + k) * x);
    }
    __syncthreads();

    // 2. The FFT of each frame's n_fft points.
    fft_rows<kRadix, kPrime ? kPrimeC : 0, kBluestein>(buf, F, n_fft, n_fft, twr, &bl);

    // 3. The two spectra: the power rows over the bands' bins, the
    // magnitude into the frame's sums; tpf threads a frame.
    const float2* z = buf + f_own * n_fft;
    float ms = 0.0f, fs = 0.0f;
    for (int k = l_own; k <= half; k += tpf) {
      const float2 a = z[k], c = z[k == 0 ? 0 : n_fft - k];
      if (k >= pow_lo && k < pow_lo + n_pow) {
        const float re = 0.5f * (a.x + c.x), im = 0.5f * (a.y - c.y);
        pw[f_own * n_pow + k - pow_lo] = re * re + im * im;
      }
      const float dre = 0.5f * (a.x - c.x), dim = 0.5f * (a.y + c.y);  // |(Z[k] - conj Z[n - k]) / 2i|
      const float mg = sqrtf(dre * dre + dim * dim);
      ms += mg;
      fs += __ldg(freqs + k) * mg;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      if (off < tpf) {
        ms += __shfl_xor_sync(0xffffffffu, ms, off);
        fs += __shfl_xor_sync(0xffffffffu, fs, off);
      }
    if (tpf > 32) {  // a frame's warps add up their partial sums
      if (lane == 0) {
        red[warp] = ms;
        red[kWarpsA + warp] = fs;
      }
      __syncthreads();
      if (l_own == 0)
        for (int w = 1; w < tpf / 32; ++w) {
          ms += red[warp + w];
          fs += red[kWarpsA + warp + w];
        }
    }
    if (l_own == 0 && f_own < frames) con[n_bands * n_frames + t0 + f_own] = (ms > 0.0f ? fs / ms : 0.0f) / half_sr;
    __syncthreads();  // the group's power rows are in place

    // 4. The bands' tails, a warp a (frame, band); in an instance for
    // bands past kWideBand bins (kWide), the others so, then the wider ones
    // by the block (wide_bands; the FFT rows are free for its scratch).
    for (int item = warp; item < frames * n_bands; item += kWarpsA) {
      const int f = item / n_bands, i = item - f * n_bands;
      const int4 bd = __ldg(bands + i);
      if (kWide && bd.y > kWideBand) continue;
      const float v = band_value_sorted(pw + f * n_pow, bd, lane);
      if (lane == 0) con[i * n_frames + t0 + f] = v;
    }
    if constexpr (kWide)
      wide_bands(pw, n_pow, bands, n_bands, frames, con + t0, n_frames, reinterpret_cast<unsigned*>(buf));
  }
  __syncthreads();  // the clip's rows are complete

  // 5. The clip's z-norm, written as (n_rows, n_frames).
  znorm_rows(con, n, red, out + (size_t)blockIdx.x * n);
}

int set_smem(const void* fn, size_t bytes) {
  if (bytes <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

}  // namespace

extern "C" {

// Shared-memory bytes each launch needs (the GEMM plans of launches A and
// C: with the smallest ring, two slots), and the plan each launch takes:
// the FFT or the GEMM staged or not (A, plan_a), one block, a cluster of n
// or device memory (B), LayoutC's level or the FFT (C, plan_c).
// ops/frontend_kernel.py mirrors each in Python (spectral_smem_bytes,
// spectral_plan, epilogue_smem_bytes, epilogue_blocks,
// contrast_smem_bytes, contrast_level) to size buffers and grids from the
// config alone; chip_smoke.py holds the mirrors against these.
size_t cdt_frontend_smem_a(int n_fft, int hop, int kpad, int n_mels) {
  const int plan = plan_a(n_fft, hop, kpad, n_mels);
  if (plan == kPlanFft) return LayoutF(n_fft, hop).bytes();
  return LayoutA(hop, kpad, plan == kPlanGemmStaged).bytes(2);
}

int cdt_frontend_plan_a(int n_fft, int hop, int kpad, int n_mels) { return plan_a(n_fft, hop, kpad, n_mels); }

size_t cdt_frontend_smem_b(int n_frames, int n_mels, int n_mfcc, int use_pcen, int delta_delta) {
  return smem_b(n_frames, n_mels, n_mfcc, use_pcen, delta_delta);
}

int cdt_frontend_plan_b(int n_frames, int n_mels, int n_mfcc, int use_pcen, int delta_delta) {
  return plan_b(n_frames, n_mels, n_mfcc, use_pcen, delta_delta);
}

// Launch A. wave (B, n_samples); table: the chunk stream its ring reads
// (ops/frontend_kernel.py::_constants), n_groups mel groups of mel_tiles
// (4, 8 or 16) n-tiles of 8 mels; mel (B, n_mels, n_frames). All float32,
// contiguous, on one device. The ring gets as many slots (up to four) as
// shared memory holds.
int cdt_frontend_spectral(
    const float* wave, int batch, int n_samples, int n_frames, int n_fft,
    int hop, int j0, int kpad, const float* table, int n_bins, int n_mels,
    int mel_tiles, int n_groups, int use_pre, float pre_coef, float* mel, cudaStream_t stream) {
  if (n_groups < 1 || n_mels > 8 * mel_tiles * n_groups || kpad % 16 || n_bins % 8 || hop < 1)
    return (int)cudaErrorInvalidValue;
  const bool staged = staged_a(hop, kpad);
  const void* fn = nullptr;
  if (staged)
    fn = mel_tiles == 4   ? (const void*)spectral_kernel<4, true>
         : mel_tiles == 8 ? (const void*)spectral_kernel<8, true>
         : mel_tiles == 16 ? (const void*)spectral_kernel<16, true>
                           : nullptr;
  else
    fn = mel_tiles == 4   ? (const void*)spectral_kernel<4, false>
         : mel_tiles == 8 ? (const void*)spectral_kernel<8, false>
         : mel_tiles == 16 ? (const void*)spectral_kernel<16, false>
                           : nullptr;
  if (!fn) return (int)cudaErrorInvalidValue;
  const LayoutA lay(hop, kpad, staged);
  int n_slots = kMaxSlots;
  while (n_slots > 2 && lay.bytes(n_slots) > kMaxSmem) --n_slots;
  const size_t smem = lay.bytes(n_slots);
  const int err = set_smem(fn, smem);
  if (err) return err;
  const long long blocks = (long long)((n_frames + kRows - 1) / kRows) * n_groups * batch;
  if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)blocks);
  void* args[] = {&wave, &n_samples, &n_frames, &n_fft, &hop, &j0, &kpad, &table,
                  &n_bins, &n_mels, &n_groups, &use_pre, &pre_coef, &n_slots, &mel};
  const cudaError_t launched = cudaLaunchKernel(fn, grid, dim3(kThreadsA), args, smem, stream);
  return launched ? (int)launched : (int)cudaGetLastError();
}

// Launch A, FFT plan (spectral_fft_kernel). wave (B, n_samples); window
// (n_fft); twiddles (LayoutF's tables, 2): the n_fft / 2 + 1 twiddles, then
// Bluestein's tables for a prime factor past kFftMaxPrime; fb_w and
// fb_ranges (n_mels, 3) int32 (ops/frontend_kernel.py::_fft_constants);
// mel (B, n_mels, n_frames). All contiguous, on one device. Takes any
// n_fft that fft_fits and LayoutF take, whatever plan_a says
// (tools/spectral_probe.py times it on the shipped config); the instance
// with Bluestein's stage for a prime past kFftMaxPrime.
int cdt_frontend_spectral_fft(
    const float* wave, int batch, int n_samples, int n_frames, int n_fft, int hop,
    const float* window, const float* twiddles, int n_used, const float* fb_w, const int* fb_ranges,
    int n_mels, int use_pre, float pre_coef, float* mel, cudaStream_t stream) {
  LayoutF lay(n_fft, hop);
  if (!fft_fits(n_fft, fft_points_a(n_fft)) || hop < 1 || n_used < 1 || n_used > n_fft / 2 + 1 ||
      lay.bytes() > kMaxSmem)
    return (int)cudaErrorInvalidValue;
  const void* fn = lay.bp ? (const void*)spectral_fft_kernel<kBluesteinA> : (const void*)spectral_fft_kernel<0>;
  const int err = set_smem(fn, lay.bytes());
  if (err) return err;
  const long long blocks = (long long)((n_frames + lay.frames - 1) / lay.frames) * batch;
  if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;
  void* args[] = {&wave, &n_samples, &n_frames, &n_fft, &hop, &window, &twiddles, &lay, &n_used,
                  &fb_w, &fb_ranges, &n_mels, &use_pre, &pre_coef, &mel};
  const cudaError_t launched = cudaLaunchKernel(fn, dim3((unsigned)blocks), dim3(kThreadsA), args, lay.bytes(), stream);
  return launched ? (int)launched : (int)cudaGetLastError();
}

// Launch B. mel (B, n_mels, n_frames); dct (n_mels, n_mfcc);
// out (B, n_features, n_frames). All float32, contiguous, on one device.
// plan_b: one block a clip, a cluster of n blocks of kThreadsBC threads a
// clip (launched through cudaLaunchKernelEx with the cluster's dimension,
// allowed past the portable 8 by the kernel's attribute), or one block a
// clip in device memory.
int cdt_frontend_epilogue(
    const float* mel, int batch, int n_frames, int n_mels, const float* dct,
    int n_mfcc, int use_pcen, int delta_delta, int n_features, float* out,
    cudaStream_t stream) {
  const int n = plan_b(n_frames, n_mels, n_mfcc, use_pcen, delta_delta);
  const int kc = LayoutB(n_frames, n_mels, n_mfcc, delta_delta).kc;
  const void* fn;
  if (n == 1)
    fn = use_pcen ? (kc == 8    ? (const void*)epilogue_kernel<true, 8, false>
                     : kc == 16 ? (const void*)epilogue_kernel<true, 16, false>
                                : (const void*)epilogue_kernel<true, 32, false>)
                  : (kc == 8    ? (const void*)epilogue_kernel<false, 8, false>
                     : kc == 16 ? (const void*)epilogue_kernel<false, 16, false>
                                : (const void*)epilogue_kernel<false, 32, false>);
  else if (n == 0)
    fn = use_pcen ? (kc == 8    ? (const void*)epilogue_kernel<true, 8, true>
                     : kc == 16 ? (const void*)epilogue_kernel<true, 16, true>
                                : (const void*)epilogue_kernel<true, 32, true>)
                  : (kc == 8    ? (const void*)epilogue_kernel<false, 8, true>
                     : kc == 16 ? (const void*)epilogue_kernel<false, 16, true>
                                : (const void*)epilogue_kernel<false, 32, true>);
  else
    fn = use_pcen ? (kc == 8    ? (const void*)epilogue_cluster_kernel<true, 8>
                     : kc == 16 ? (const void*)epilogue_cluster_kernel<true, 16>
                                : (const void*)epilogue_cluster_kernel<true, 32>)
                  : (kc == 8    ? (const void*)epilogue_cluster_kernel<false, 8>
                     : kc == 16 ? (const void*)epilogue_cluster_kernel<false, 16>
                                : (const void*)epilogue_cluster_kernel<false, 32>);
  const size_t smem = smem_b(n_frames, n_mels, n_mfcc, use_pcen, delta_delta);
  const int err = set_smem(fn, smem);
  if (err) return err;
  void* args[] = {&mel, &n_frames, &n_mels, &dct, &n_mfcc, &delta_delta, &n_features, &out};
  if (n <= 1) {
    const cudaError_t launched = cudaLaunchKernel(fn, dim3(batch), dim3(threads_b(n)), args, smem, stream);
    return launched ? (int)launched : (int)cudaGetLastError();
  }
  const long long blocks = (long long)batch * n;
  if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;
  if (n > kPortableCluster) {
    const cudaError_t allowed = cudaFuncSetAttribute(fn, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (allowed) return (int)allowed;
  }
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3((unsigned)blocks);
  config.blockDim = dim3(threads_b(n));
  config.dynamicSmemBytes = smem;
  config.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = n;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  config.attrs = attr;
  config.numAttrs = 1;
  const cudaError_t launched = cudaLaunchKernelExC(&config, fn, args);
  return launched ? (int)launched : (int)cudaGetLastError();
}

size_t cdt_frontend_smem_c(int n_fft, int hop, int kpad, int n_pow, int n_frames, int n_bands) {
  if (plan_c(n_fft, hop, kpad, n_pow, n_frames, n_bands) == kPlanCFft)
    return LayoutF(n_fft, hop, n_pow).bytes();
  return LayoutC(hop, kpad, n_pow, n_frames, n_bands + 1).bytes(2);
}

int cdt_frontend_plan_c(int n_fft, int hop, int kpad, int n_pow, int n_frames, int n_bands) {
  return plan_c(n_fft, hop, kpad, n_pow, n_frames, n_bands);
}

// Launch C, FFT plan (contrast_fft_kernel). wave (B, n_samples); windows
// (2, n_fft); twiddles (LayoutF's tables, 2), as cdt_frontend_spectral_fft's
// (ops/frontend_kernel.py's _contrast_fft_constants); freqs (n_fft / 2 +
// 1); bands as cdt_frontend_contrast's, widest its widest band's bins;
// out (B, n_bands + 1, n_frames). All contiguous, on one device. Takes any
// n_fft that fft_fits and LayoutF take, whatever plan_c says. The instance
// by the n_fft's largest prime factor: radix 7 up to 7, radix 11 at 11,
// past 11 radix 11 with fft_stage_prime, and past kFftMaxPrime that with
// Bluestein's stage; for a band past kWideBand bins, radix 7 up to 7, else
// the last, each with wide_bands (kWide).
int cdt_frontend_contrast_fft(
    const float* wave, int batch, int n_samples, int n_frames, int n_fft, int hop,
    const float* windows, const float* twiddles, int pow_lo, int n_pow, const float* freqs,
    float half_sr, const int* bands, int n_bands, int widest, float* out, cudaStream_t stream) {
  LayoutF lay(n_fft, hop, n_pow);
  if (!fft_fits(n_fft, n_fft) || hop < 1 || n_bands < 0 || n_pow < 0 || pow_lo < 0 ||
      pow_lo + n_pow > n_fft / 2 + 1 || widest < 0 || widest > n_pow || lay.bytes() > kMaxSmem)
    return (int)cudaErrorInvalidValue;
  const int lp = largest_prime(n_fft);
  const void* fn = widest > kWideBand   ? lp <= 7 ? (const void*)contrast_fft_kernel<7, false, 0, true>
                                                  : (const void*)contrast_fft_kernel<11, true, kBluesteinC, true>
                   : lp <= 7            ? (const void*)contrast_fft_kernel<7, false, 0, false>
                   : lp == 11           ? (const void*)contrast_fft_kernel<11, false, 0, false>
                   : lp <= kFftMaxPrime ? (const void*)contrast_fft_kernel<11, true, 0, false>
                                        : (const void*)contrast_fft_kernel<11, true, kBluesteinC, false>;
  const int err = set_smem(fn, lay.bytes());
  if (err) return err;
  void* args[] = {&wave, &n_samples, &n_frames, &n_fft, &hop, &windows, &twiddles, &lay, &pow_lo, &n_pow,
                  &freqs, &half_sr, &bands, &n_bands, &out};
  const cudaError_t launched = cudaLaunchKernel(fn, dim3(batch), dim3(kThreadsA), args, lay.bytes(), stream);
  return launched ? (int)launched : (int)cudaGetLastError();
}

// Launch C. wave (B, n_samples); table: the chunk stream its ring reads
// (ops/frontend_kernel.py::_contrast_constants): a row tile's power passes
// of pow_ks chunks (k-steps [pow_k0, pow_k0 + pow_ks) from j0), then its
// magnitude passes of kpad / 8 chunks; freqs (n_freqs = n_fft / 2 + 1,);
// bands (n_bands, 4) int32: per band its first bin (from the first power
// bin), bins, top and bottom tail lengths; scratch (B, 128, n_pow) at
// LayoutC's level 3, else unused (may be null); out (B, n_bands + 1,
// n_frames). All device buffers contiguous, on one device. The ring gets
// as many slots (up to kMaxSlots, at most a tile's chunks) as shared
// memory holds.
int cdt_frontend_contrast(
    const float* wave, int batch, int n_samples, int n_frames, int n_fft, int hop, int j0,
    int kpad, int pow_k0, int pow_ks, const float* table, int n_pow, int n_freqs, const float* freqs,
    float half_sr, const int* bands, int n_bands, float* scratch, float* out, cudaStream_t stream) {
  if (kpad % 16 || hop < 1 || n_bands < 1 || n_pow < 1 || n_freqs != n_fft / 2 + 1 || pow_k0 < 0 ||
      pow_ks < 2 || pow_ks % 2 || 8 * (pow_k0 + pow_ks) > kpad)
    return (int)cudaErrorInvalidValue;
  const LayoutC lay(hop, kpad, n_pow, n_frames, n_bands + 1);
  if (lay.level == 3 && !scratch) return (int)cudaErrorInvalidValue;
  int n_slots = slots_c(lay, chunks_c(n_fft, kpad, pow_ks, n_pow));
  const size_t smem = lay.bytes(n_slots);
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  const void* fn = lay.level == 0 ? (const void*)contrast_kernel<true> : (const void*)contrast_kernel<false>;
  const int err = set_smem(fn, smem);
  if (err) return err;
  void* args[] = {&wave, &n_samples, &n_frames, &n_fft, &hop, &j0, &kpad, &pow_k0, &pow_ks, &table, &n_pow,
                  &n_freqs, &freqs, &half_sr, &bands, &n_bands, &n_slots, &scratch, &out};
  const cudaError_t launched = cudaLaunchKernel(fn, dim3(batch), dim3(kThreadsC), args, smem, stream);
  return launched ? (int)launched : (int)cudaGetLastError();
}

const char* cdt_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
