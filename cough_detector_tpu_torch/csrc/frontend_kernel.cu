// Fused front end for Hopper (sm_90a): raw waveform batch → stacked
// feature image (B, num_features, num_frames), in two launches.
//
// Replaces cough_detector_tpu/ops/pallas/frontend_kernel.py::_kernel and
// its launcher _run (the repo's only Pallas kernel): reflect-padded
// framing, windowed band-limited rDFT, power, mel projection, log-mel,
// then the dB branch (clamp to per-clip max - 80, (db+80)/80 in [0, 1]) or
// the PCEN branch (10-tap zero-padded smoother, compressive formula,
// per-clip min-max), the DCT-II, the per-clip unbiased z-norm, deltas and
// optional delta-deltas. Pre-emphasis, which _run applies before the pad,
// is applied here while the waveform is staged.
//
// Bound on an H100 SXM. Per clip of the shipped config (16000 samples,
// 101 frames, n_fft 512 with a 400-tap window, 128 of 257 bins used,
// 64 mels, 13 MFCCs) the work is about 22.5 MFLOP: the DFT over the
// window's 400 nonzero taps 4*101*400*128 = 20.7 M, mel 2*101*128*64 =
// 1.65 M, DCT 2*101*64*13 = 0.17 M. The bytes the pair must move are
// about 100 KB (64 KB of waveform in, 36 KB of features out), plus the
// power mel's round trip below. At 67 TFLOP/s FP32 (no tensor cores)
// against 3.35 TB/s that is 0.34 us of arithmetic against 0.03 us of
// memory: launch A is bound by FP32 operations, the DFT 92% of them.
// Launch B does 0.17 MFLOP of DCT on 62 KB of traffic a clip: bound by
// bytes.
//
// Design.
//  * Per-clip reductions (dB max, PCEN min/max, MFCC mean/variance) span
//    all frames of a clip, which do not fit one block's registers once
//    the DFT is spread over enough blocks to fill 132 SMs. So launch A
//    (spectral_kernel) runs over (frame tile, clip) and writes the power
//    mel, and launch B (epilogue_kernel) takes one clip per block and
//    does everything after the mel.
//  * Launch A stages its tile's waveform span in shared memory with
//    reflect indexing (and pre-emphasis): frames never reach device
//    memory. Each thread owns one DFT bin and FPT frames and accumulates
//    re/im in registers with FP32 FMAs over the window's support only
//    (the padded Hann window is zero outside it). The windowed cos/sin
//    tables are read through the read-only cache: every block of a tile
//    row reads the same ones, so they stay in L2.
//  * Band-limiting: the tables are cut to n_used bins, the filterbank's
//    last nonzero row, so bins that feed no mel band are never computed.
//  * Precision: plain FP32 FMAs on the CUDA cores. The bf16 operand
//    splitting of the TPU kernel exists only for the TPU's matrix unit.
//  * Launch B writes (B, F, T), the reference layout, directly.
//
// What a later PR removes first: the power mel's round trip through
// device memory between the launches, about 52 KB per clip (26 KB
// written, 26 KB read) against 64 KB of waveform in. Next, the DFT on
// the tensor cores (wgmma with split operands) instead of FP32 FMAs.
//
// Interface: plain C, loaded with ctypes, one function per launch. The
// caller allocates every buffer; each function launches its kernel on
// `stream`, does not synchronise, and returns cudaGetLastError() (or the
// error of a refused attribute call).

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kBinsPerPass = 128;  // threads along the bin axis
constexpr int kGroups = 2;         // frame groups per block
constexpr int kFramesPerThread = 13;
constexpr int kTileFrames = kGroups * kFramesPerThread;  // 26: 4 tiles cover 101
constexpr int kThreadsA = kBinsPerPass * kGroups;        // 256
constexpr int kThreadsB = 256;
constexpr float kAmin = 1e-10f;
constexpr float kDbScale = 4.3429448190325175f;  // 10 / ln(10)

__device__ __forceinline__ float warp_reduce(float v, int op) {
  for (int off = 16; off > 0; off >>= 1) {
    float o = __shfl_xor_sync(0xffffffffu, v, off);
    v = op == 0 ? v + o : (op == 1 ? fmaxf(v, o) : fminf(v, o));
  }
  return v;
}

// op: 0 sum, 1 max, 2 min. `scratch` holds 32 floats. Every thread gets
// the result. Ends with a barrier, so `scratch` may be reused at once.
__device__ float block_reduce(float v, int op, float* scratch) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n_warps = (blockDim.x + 31) >> 5;
  v = warp_reduce(v, op);
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  if (warp == 0) {
    float identity = op == 0 ? 0.0f : (op == 1 ? -INFINITY : INFINITY);
    float w = lane < n_warps ? scratch[lane] : identity;
    w = warp_reduce(w, op);
    if (lane == 0) scratch[32] = w;
  }
  __syncthreads();
  float out = scratch[32];
  __syncthreads();
  return out;
}

// Launch A. grid (n_tiles, batch), kThreadsA threads.
// Shared: the tile's waveform span, then the power tile (kTileFrames rows
// of `pstride` floats; pstride is odd so the mel pass reads conflict-free).
__global__ void spectral_kernel(
    const float* __restrict__ wave, int n_samples, int n_frames, int n_fft,
    int hop, int j0, int j1, const float* __restrict__ cosm,
    const float* __restrict__ sinm, int n_used,
    const float* __restrict__ fb, int n_mels, int use_pre, float pre_coef,
    float* __restrict__ mel_out) {
  extern __shared__ float smem[];
  const int span = (kTileFrames - 1) * hop + n_fft;
  const int pstride = n_used | 1;
  float* wave_s = smem;
  float* pow_s = smem + span;

  const int b = blockIdx.y;
  const int t0 = blockIdx.x * kTileFrames;
  const int tid = threadIdx.x;
  const float* x = wave + (size_t)b * n_samples;
  const int half = n_fft / 2;

  // Stage the span with reflect padding (numpy "reflect": no edge repeat).
  for (int i = tid; i < span; i += blockDim.x) {
    int q = t0 * hop + i - half;
    q = q < 0 ? -q : q;
    q = q >= n_samples ? 2 * (n_samples - 1) - q : q;
    float v = 0.0f;  // only frames past n_frames read outside the clip
    if (q >= 0 && q < n_samples) {
      v = x[q];
      if (use_pre && q > 0) v = __fsub_rn(v, __fmul_rn(pre_coef, x[q - 1]));
    }
    wave_s[i] = v;
  }
  __syncthreads();

  const int g = tid / kBinsPerPass;
  const float* frame0 = wave_s + g * kFramesPerThread * hop;
  for (int k0 = 0; k0 < n_used; k0 += kBinsPerPass) {
    const int k = k0 + tid % kBinsPerPass;
    if (k < n_used) {
      float re[kFramesPerThread], im[kFramesPerThread];
#pragma unroll
      for (int f = 0; f < kFramesPerThread; ++f) re[f] = im[f] = 0.0f;
      for (int j = j0; j < j1; ++j) {
        const float c = __ldg(cosm + (size_t)j * n_used + k);
        const float s = __ldg(sinm + (size_t)j * n_used + k);
#pragma unroll
        for (int f = 0; f < kFramesPerThread; ++f) {
          const float v = frame0[f * hop + j];
          re[f] = fmaf(v, c, re[f]);
          im[f] = fmaf(v, s, im[f]);
        }
      }
#pragma unroll
      for (int f = 0; f < kFramesPerThread; ++f) {
        pow_s[(g * kFramesPerThread + f) * pstride + k] =
            re[f] * re[f] + im[f] * im[f];
      }
    }
  }
  __syncthreads();

  // Mel projection; output (B, n_mels, n_frames), frames fastest.
  for (int o = tid; o < kTileFrames * n_mels; o += blockDim.x) {
    const int tl = o % kTileFrames, m = o / kTileFrames;
    const int t = t0 + tl;
    if (t >= n_frames) continue;
    const float* p = pow_s + tl * pstride;
    float acc = 0.0f;
    for (int k = 0; k < n_used; ++k)
      acc = fmaf(p[k], __ldg(fb + (size_t)k * n_mels + m), acc);
    mel_out[((size_t)b * n_mels + m) * n_frames + t] = acc;
  }
}

// Launch B. grid (batch), kThreadsB threads. Works in (feature, time)
// layout throughout. Shared: mel, log-mel (n_mels*T each), MFCC and
// delta (n_mfcc*T each), 33 floats of reduction scratch.
__global__ void epilogue_kernel(
    const float* __restrict__ mel, int n_frames, int n_mels,
    const float* __restrict__ dct, int n_mfcc, int use_pcen,
    int delta_delta, int n_features, float* __restrict__ out) {
  extern __shared__ float smem[];
  const int T = n_frames, M = n_mels, C = n_mfcc;
  const int nm = M * T, nc = C * T;
  float* mel_s = smem;
  float* lm_s = mel_s + nm;
  float* mf_s = lm_s + nm;
  float* d1_s = mf_s + nc;
  float* red = d1_s + nc;

  const int b = blockIdx.x, tid = threadIdx.x, nt = blockDim.x;
  const float* src = mel + (size_t)b * nm;
  float* o = out + (size_t)b * n_features * T;

  float local_max = -INFINITY;
  for (int i = tid; i < nm; i += nt) {
    const float v = src[i];
    mel_s[i] = v;
    const float lm = kDbScale * logf(fmaxf(v, kAmin));
    lm_s[i] = lm;
    local_max = fmaxf(local_max, lm);
  }
  __syncthreads();

  if (!use_pcen) {
    const float floor_db = block_reduce(local_max, 1, red) - 80.0f;
    for (int i = tid; i < nm; i += nt) {
      const float db = fmaxf(lm_s[i], floor_db);
      o[i] = fminf(fmaxf((db + 80.0f) / 80.0f, 0.0f), 1.0f);
    }
  } else {
    // Smoother: the ten taps in the order the JAX kernel adds them, with
    // out-of-clip taps counted as zeros.
    float lo = INFINITY, hi = -INFINITY;
    for (int i = tid; i < nm; i += nt) {
      const int m = i / T, t = i % T;
      const float* row = mel_s + m * T;
      float s = 0.0f;
      for (int d = 0; d < 10; ++d) {
        const int tt = t + d - 5;
        if (tt >= 0 && tt < T) s += row[tt];
      }
      s = s / 10.0f;
      const float p =
          sqrtf(mel_s[i] / powf(1e-6f + s, 0.98f) + 2.0f) - 1.41421356237f;
      o[i] = p;  // normalized below by this same thread
      lo = fminf(lo, p);
      hi = fmaxf(hi, p);
    }
    lo = block_reduce(lo, 2, red);
    hi = block_reduce(hi, 1, red);
    for (int i = tid; i < nm; i += nt) o[i] = (o[i] - lo) / (hi - lo + 1e-8f);
  }

  // DCT-II of the log-mel: mf[c, t] = sum_m lm[m, t] * dct[m, c].
  float local_sum = 0.0f;
  for (int i = tid; i < nc; i += nt) {
    const int c = i / T, t = i % T;
    float acc = 0.0f;
    for (int m = 0; m < M; ++m)
      acc = fmaf(lm_s[m * T + t], __ldg(dct + m * C + c), acc);
    mf_s[i] = acc;
    local_sum += acc;
  }
  const float mean = block_reduce(local_sum, 0, red) / (float)nc;
  float local_sq = 0.0f;
  for (int i = tid; i < nc; i += nt) {
    const float dlt = mf_s[i] - mean;
    local_sq += dlt * dlt;
  }
  const float var = block_reduce(local_sq, 0, red) / (float)(nc - 1);
  const float denom = sqrtf(var) + 1e-8f;
  for (int i = tid; i < nc; i += nt) {
    const float z = (mf_s[i] - mean) / denom;
    mf_s[i] = z;
    o[nm + i] = z;
  }
  __syncthreads();

  // Deltas: replicate-padded central difference along time.
  for (int i = tid; i < nc; i += nt) {
    const int t = i % T, row = i - t;
    const float up = mf_s[row + min(t + 1, T - 1)];
    const float dn = mf_s[row + max(t - 1, 0)];
    const float d = (up - dn) / 2.0f;
    d1_s[i] = d;
    o[nm + nc + i] = d;
  }
  if (delta_delta) {
    __syncthreads();
    for (int i = tid; i < nc; i += nt) {
      const int t = i % T, row = i - t;
      const float up = d1_s[row + min(t + 1, T - 1)];
      const float dn = d1_s[row + max(t - 1, 0)];
      o[nm + 2 * nc + i] = (up - dn) / 2.0f;
    }
  }
}

int set_smem(const void* fn, size_t bytes) {
  if (bytes <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

}  // namespace

extern "C" {

// Shared-memory bytes each launch needs; the wrapper refuses configs
// past the card's 227 KB per block.
size_t cdt_frontend_smem_a(int n_fft, int hop, int n_used) {
  return sizeof(float) *
         ((size_t)(kTileFrames - 1) * hop + n_fft +
          (size_t)kTileFrames * (n_used | 1));
}

size_t cdt_frontend_smem_b(int n_frames, int n_mels, int n_mfcc) {
  return sizeof(float) *
         (2 * (size_t)n_mels * n_frames + 2 * (size_t)n_mfcc * n_frames + 33);
}

// Launch A. wave (B, n_samples); cosm/sinm (n_fft, n_used);
// fb (n_used, n_mels); mel (B, n_mels, n_frames). All float32,
// contiguous, on one device.
int cdt_frontend_spectral(
    const float* wave, int batch, int n_samples, int n_frames, int n_fft,
    int hop, int j0, int j1, const float* cosm, const float* sinm,
    int n_used, const float* fb, int n_mels, int use_pre, float pre_coef,
    float* mel, cudaStream_t stream) {
  const size_t smem = cdt_frontend_smem_a(n_fft, hop, n_used);
  const int err = set_smem((const void*)spectral_kernel, smem);
  if (err) return err;
  const dim3 grid((n_frames + kTileFrames - 1) / kTileFrames, batch);
  spectral_kernel<<<grid, kThreadsA, smem, stream>>>(
      wave, n_samples, n_frames, n_fft, hop, j0, j1, cosm, sinm, n_used, fb,
      n_mels, use_pre, pre_coef, mel);
  return (int)cudaGetLastError();
}

// Launch B. mel (B, n_mels, n_frames); dct (n_mels, n_mfcc);
// out (B, n_features, n_frames). All float32, contiguous, on one device.
int cdt_frontend_epilogue(
    const float* mel, int batch, int n_frames, int n_mels, const float* dct,
    int n_mfcc, int use_pcen, int delta_delta, int n_features, float* out,
    cudaStream_t stream) {
  const size_t smem = cdt_frontend_smem_b(n_frames, n_mels, n_mfcc);
  const int err = set_smem((const void*)epilogue_kernel, smem);
  if (err) return err;
  epilogue_kernel<<<batch, kThreadsB, smem, stream>>>(
      mel, n_frames, n_mels, dct, n_mfcc, use_pcen, delta_delta, n_features,
      out);
  return (int)cudaGetLastError();
}

const char* cdt_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
