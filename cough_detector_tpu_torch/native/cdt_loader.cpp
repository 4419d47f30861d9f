// cdt_loader: native batch audio loader for cough_detector_tpu_torch
// (the same C ABI as the JAX package's native/cdt_loader.cpp).
//
// The reference delegates its input pipeline to torch DataLoader's C++
// worker machinery plus torchaudio's C++ decoders (reference:
// src/dataset.py:368-418). This is the equivalent native tier here: a
// thread-pooled WAV decode → mono → polyphase windowed-sinc resample →
// center pad/trim pipeline that fills a dense (batch, segment) float32
// buffer without holding the GIL (called via ctypes).
//
// Resampling matches ops/resample.py exactly: torchaudio
// "sinc_interp_hann" semantics (lowpass_filter_width=6, rolloff=0.99,
// Hann^2 window, gcd-reduced rates), so native- and python-loaded batches
// are bit-comparable to ~1e-6.
//
// Build: utils/native_build.py (g++ -O3 -fPIC -shared -pthread -std=c++17)
// into build/native/libcdt_loader-<hash>.so.

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <mutex>
#include <numeric>
#include <string>
#include <thread>
#include <vector>

namespace {

constexpr int kLowpassWidth = 6;
constexpr double kRolloff = 0.99;
constexpr double kPi = 3.14159265358979323846;

struct Wav {
  std::vector<float> samples;  // interleaved
  int channels = 0;
  int sample_rate = 0;
};

uint32_t rd_u32(const uint8_t* p) {
  return (uint32_t)p[0] | ((uint32_t)p[1] << 8) | ((uint32_t)p[2] << 16) |
         ((uint32_t)p[3] << 24);
}
uint16_t rd_u16(const uint8_t* p) {
  return (uint16_t)p[0] | ((uint16_t)p[1] << 8);
}

bool decode_wav(const std::string& path, Wav* out, std::string* err) {
  FILE* f = fopen(path.c_str(), "rb");
  if (!f) {
    *err = "cannot open " + path;
    return false;
  }
  fseek(f, 0, SEEK_END);
  long size = ftell(f);
  fseek(f, 0, SEEK_SET);
  std::vector<uint8_t> raw(size);
  if (fread(raw.data(), 1, size, f) != (size_t)size) {
    fclose(f);
    *err = "short read: " + path;
    return false;
  }
  fclose(f);

  if (size < 12 || memcmp(raw.data(), "RIFF", 4) != 0 ||
      memcmp(raw.data() + 8, "WAVE", 4) != 0) {
    *err = "not a RIFF/WAVE file: " + path;
    return false;
  }

  long pos = 12;
  const uint8_t* fmt = nullptr;
  long fmt_size = 0;
  const uint8_t* data = nullptr;
  long data_size = 0;
  while (pos + 8 <= size) {
    const uint8_t* cid = raw.data() + pos;
    uint32_t csize = rd_u32(raw.data() + pos + 4);
    if ((long)(pos + 8 + csize) > size) {
      // Overrunning chunk size = truncated download/write. Decoding the
      // short payload would silently hand back a partial clip; fail loudly
      // instead (same contract as the python twin, audio_io.read_wav).
      *err = "truncated WAV chunk in " + path;
      return false;
    }
    if (memcmp(cid, "fmt ", 4) == 0) {
      fmt = raw.data() + pos + 8;
      fmt_size = csize;
    } else if (memcmp(cid, "data", 4) == 0) {
      data = raw.data() + pos + 8;
      data_size = csize;
    }
    pos += 8 + csize + (csize & 1);
  }
  if (!fmt || !data) {
    *err = "missing fmt/data chunk: " + path;
    return false;
  }
  if (fmt_size < 16) {  // fields below read fmt[0..15]
    *err = "truncated fmt chunk: " + path;
    return false;
  }

  uint16_t audio_fmt = rd_u16(fmt);
  uint16_t n_ch = rd_u16(fmt + 2);
  uint32_t sr = rd_u32(fmt + 4);
  uint16_t bits = rd_u16(fmt + 14);
  if (audio_fmt == 0xFFFE && fmt_size >= 26) audio_fmt = rd_u16(fmt + 24);
  if (n_ch == 0 || sr == 0) {  // sr=0 would SIGFPE in resample()
    *err = "invalid fmt (channels/sample_rate = 0): " + path;
    return false;
  }

  out->channels = n_ch;
  out->sample_rate = (int)sr;
  long n;
  switch (audio_fmt) {
    case 1:  // PCM
      if (bits == 16) {
        n = data_size / 2;
        out->samples.resize(n);
        for (long i = 0; i < n; ++i) {
          int16_t v = (int16_t)rd_u16(data + 2 * i);
          out->samples[i] = (float)v / 32768.0f;
        }
      } else if (bits == 8) {
        n = data_size;
        out->samples.resize(n);
        for (long i = 0; i < n; ++i)
          out->samples[i] = ((float)data[i] - 128.0f) / 128.0f;
      } else if (bits == 24) {
        n = data_size / 3;
        out->samples.resize(n);
        for (long i = 0; i < n; ++i) {
          int32_t v = (int32_t)data[3 * i] | ((int32_t)data[3 * i + 1] << 8) |
                      ((int32_t)data[3 * i + 2] << 16);
          v = (v << 8) >> 8;  // sign extend
          out->samples[i] = (float)v / 8388608.0f;
        }
      } else if (bits == 32) {
        n = data_size / 4;
        out->samples.resize(n);
        for (long i = 0; i < n; ++i) {
          int32_t v = (int32_t)rd_u32(data + 4 * i);
          out->samples[i] = (float)((double)v / 2147483648.0);
        }
      } else {
        *err = "unsupported PCM depth in " + path;
        return false;
      }
      break;
    case 3:  // IEEE float
      if (bits == 32) {
        n = data_size / 4;
        out->samples.resize(n);
        memcpy(out->samples.data(), data, n * 4);
      } else if (bits == 64) {
        n = data_size / 8;
        out->samples.resize(n);
        const double* d = (const double*)data;
        for (long i = 0; i < n; ++i) out->samples[i] = (float)d[i];
      } else {
        *err = "unsupported float depth in " + path;
        return false;
      }
      break;
    default:
      *err = "unsupported WAV format in " + path;
      return false;
  }
  return true;
}

std::vector<float> to_mono(const Wav& w) {
  if (w.channels <= 1) return w.samples;
  long frames = (long)w.samples.size() / w.channels;
  std::vector<float> mono(frames);
  for (long i = 0; i < frames; ++i) {
    double acc = 0;
    for (int c = 0; c < w.channels; ++c) acc += w.samples[i * w.channels + c];
    mono[i] = (float)(acc / w.channels);
  }
  return mono;
}

long gcd_long(long a, long b) { return b == 0 ? a : gcd_long(b, a % b); }

// Polyphase kernel bank identical to ops/resample.py::_sinc_kernel.
struct ResampleKernel {
  std::vector<float> taps;  // (new_freq, width*2 + orig_freq)
  long orig, nu, width, ksz;
};

ResampleKernel build_kernel(long orig_sr, long new_sr) {
  long g = gcd_long(orig_sr, new_sr);
  long orig = orig_sr / g, nu = new_sr / g;
  double base_freq = (double)std::min(orig, nu) * kRolloff;
  long width = (long)std::ceil((double)kLowpassWidth * orig / base_freq);
  long ksz = 2 * width + orig;

  ResampleKernel k;
  k.orig = orig;
  k.nu = nu;
  k.width = width;
  k.ksz = ksz;
  k.taps.resize(nu * ksz);
  for (long p = 0; p < nu; ++p) {
    for (long j = 0; j < ksz; ++j) {
      double idx = (double)(j - width) / orig;
      double t = -(double)p / nu + idx;
      t *= base_freq;
      if (t < -kLowpassWidth) t = -kLowpassWidth;
      if (t > kLowpassWidth) t = kLowpassWidth;
      double window = std::cos(t * kPi / kLowpassWidth / 2.0);
      window *= window;
      double tp = t * kPi;
      double sinc = tp == 0.0 ? 1.0 : std::sin(tp) / tp;
      k.taps[p * ksz + j] = (float)(sinc * window * base_freq / orig);
    }
  }
  return k;
}

std::vector<float> resample(const std::vector<float>& x, long orig_sr,
                            long new_sr) {
  if (orig_sr == new_sr) return x;
  ResampleKernel k = build_kernel(orig_sr, new_sr);
  long length = (long)x.size();
  long target = (new_sr / gcd_long(orig_sr, new_sr) * length +
                 (orig_sr / gcd_long(orig_sr, new_sr)) - 1) /
                (orig_sr / gcd_long(orig_sr, new_sr));
  // padded input: width zeros front, width + orig zeros back
  std::vector<float> padded(length + 2 * k.width + k.orig, 0.0f);
  memcpy(padded.data() + k.width, x.data(), length * sizeof(float));

  long n_frames = ((long)padded.size() - k.ksz) / k.orig + 1;
  std::vector<float> out(n_frames * k.nu);
  for (long fidx = 0; fidx < n_frames; ++fidx) {
    const float* frame = padded.data() + fidx * k.orig;
    for (long p = 0; p < k.nu; ++p) {
      const float* taps = k.taps.data() + p * k.ksz;
      float acc = 0.0f;
      for (long j = 0; j < k.ksz; ++j) acc += frame[j] * taps[j];
      out[fidx * k.nu + p] = acc;
    }
  }
  out.resize(std::min((long)out.size(), target));
  out.resize(target, 0.0f);
  return out;
}

// Center pad/trim with an optional window displacement: final[j] =
// x[c + j - shift] iff both c+j and c+j-shift lie in [0, n), matching the
// Python loader's _crop_window (reference shift-then-center-trim
// semantics). The window origin truncates toward ZERO: the reference pad
// branch puts floor(pad/2) zeros on the LEFT, so for n < segment the
// origin is -((segment - n) / 2) — C++ division of positives already
// truncates, which is exactly right on odd pads.
void center_fit(const std::vector<float>& x, float* dst, long segment,
                long shift = 0) {
  long n = (long)x.size();
  long c = (n - segment) >= 0 ? (n - segment) / 2
                              : -((segment - n) / 2);
  memset(dst, 0, segment * sizeof(float));
  long j_lo = std::max({-c, shift - c, 0L});
  long j_hi = std::min({n - c, n - c + shift, segment});
  if (j_hi > j_lo) {
    long src = c - shift;
    memcpy(dst + j_lo, x.data() + src + j_lo,
           (j_hi - j_lo) * sizeof(float));
  }
}

}  // namespace

extern "C" {

// Load n clips into out (n * segment_samples floats). Returns the number of
// successfully loaded clips; failures leave a zero row and append the path
// to errbuf (quarantine-with-count semantics). shift_fracs (nullable,
// length n) displaces each clip's crop window by round(frac * clip_len)
// samples — the crop-time time-shift augmentation.
int cdt_load_batch_shifted(const char** paths, int n, int target_sr,
                           long segment_samples, const double* shift_fracs,
                           float* out, int n_threads, char* errbuf,
                           int errbuf_len) {
  std::atomic<int> next(0), ok(0);
  std::mutex err_mu;
  std::string errors;

  auto worker = [&]() {
    for (;;) {
      int i = next.fetch_add(1);
      if (i >= n) break;
      Wav w;
      std::string err;
      float* dst = out + (long)i * segment_samples;
      if (!decode_wav(paths[i], &w, &err)) {
        std::lock_guard<std::mutex> lock(err_mu);
        if (!errors.empty()) errors += "; ";
        errors += err;
        memset(dst, 0, segment_samples * sizeof(float));
        continue;
      }
      std::vector<float> mono = to_mono(w);
      if (w.sample_rate != target_sr)
        mono = resample(mono, w.sample_rate, target_sr);
      long shift = 0;
      if (shift_fracs != nullptr)
        shift = (long)llround(shift_fracs[i] * (double)mono.size());
      center_fit(mono, dst, segment_samples, shift);
      ok.fetch_add(1);
    }
  };

  int threads = std::max(1, n_threads);
  std::vector<std::thread> pool;
  pool.reserve(threads);
  for (int t = 0; t < threads; ++t) pool.emplace_back(worker);
  for (auto& t : pool) t.join();

  if (errbuf && errbuf_len > 0) {
    strncpy(errbuf, errors.c_str(), errbuf_len - 1);
    errbuf[errbuf_len - 1] = '\0';
  }
  return ok.load();
}

// Backwards-compatible entry without shifts.
int cdt_load_batch(const char** paths, int n, int target_sr,
                   long segment_samples, float* out, int n_threads,
                   char* errbuf, int errbuf_len) {
  return cdt_load_batch_shifted(paths, n, target_sr, segment_samples,
                                nullptr, out, n_threads, errbuf, errbuf_len);
}

// Single-file decode+resample to mono. Returns sample count or -1.
long cdt_load_clip(const char* path, int target_sr, float* out,
                   long capacity, char* errbuf, int errbuf_len) {
  Wav w;
  std::string err;
  if (!decode_wav(path, &w, &err)) {
    if (errbuf && errbuf_len > 0) {
      strncpy(errbuf, err.c_str(), errbuf_len - 1);
      errbuf[errbuf_len - 1] = '\0';
    }
    return -1;
  }
  std::vector<float> mono = to_mono(w);
  if (w.sample_rate != target_sr)
    mono = resample(mono, w.sample_rate, target_sr);
  long n = std::min((long)mono.size(), capacity);
  memcpy(out, mono.data(), n * sizeof(float));
  return n;
}

int cdt_version() { return 1; }

}  // extern "C"
