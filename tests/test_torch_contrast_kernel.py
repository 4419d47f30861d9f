"""The contrast launch (ops/frontend_kernel.py::spectral_contrast_fused,
csrc/frontend_kernel.cu::contrast_kernel) on the CPU: its arithmetic's
model, its plain version, its shapes, its plan rules and the card route,
against the JAX package on the same numpy inputs.

The kernel cannot run here, so its arithmetic is held through
`spectral_contrast_split_reference` (the GEMM plan's DFT with 3xTF32
operands as its table lays it out: the power pairs over the win_length
window's k-steps, the magnitude pairs over both windows' support, an even
n_fft's DC and Nyquist cosines in one pair; stable-rank tails), which
chip_smoke.py holds the kernel against on the card. Inputs: fixture_batch
(coughs, non-coughs, sine sweeps, impulses), a digitally silent clip, a
clip silent in its first half and a click train, whose frames repeat and
whose silent frames tie in every bin. Budget: 1e-3 max-relative
(docs/PARITY.md). Measured on an x86 CPU: the 3xTF32 model 3.7e-7 to
2.2e-6 from the JAX gemm rows, one TF32 pass 7.9e-4 to 9.6e-4.
"""

import dataclasses
import shutil
import subprocess

import numpy as np
import pytest
import torch

from cough_detector_tpu.config import FeatureConfig as JaxFeatureConfig
from cough_detector_tpu.data import synth
from cough_detector_tpu.ops import frontend as jax_frontend
from cough_detector_tpu.ops.pallas.frontend_kernel import (
    extract_features_fused as jax_fused,
)
from cough_detector_tpu_torch.config import FeatureConfig
from cough_detector_tpu_torch.ops import frontend_kernel
from cough_detector_tpu_torch.utils import kernel_build
from test_torch_frontend import _rel

TOL = 1e-3
CONFIGS = {
    "contrast": {},
    "all_flags": dict(use_pcen=True, use_pre_emphasis=True, use_delta_delta=True),
    "n_fft_256": dict(n_fft=256, win_length=200, hop_length=80),
    "n_fft_1024": dict(n_fft=1024),
    "bands_4": dict(n_contrast_bands=4),
    "bands_8": dict(n_contrast_bands=8),
}
# What cdt_frontend_smem_c and cdt_frontend_plan_c returned on the card for
# each config (an NVIDIA H100's run of chip_smoke.py phase 3); the Python
# mirrors must equal them. n_fft 1024 takes the FFT plan (4).
SMEM_ON_CARD = {
    "contrast": 180528, "all_flags": 180528, "n_fft_256": 114784,
    "n_fft_1024": 84968, "bands_4": 163344, "bands_8": 192608,
}
PLAN_ON_CARD = {"contrast": 0, "all_flags": 0, "n_fft_256": 0, "n_fft_1024": 4, "bands_4": 0, "bands_8": 0}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Small tensors: one intra-op thread for the module (its module-scoped
    JAX rows and waves included), restored after it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(name: str) -> FeatureConfig:
    return FeatureConfig(use_spectral_contrast=True, **CONFIGS[name])


def _jax_cfg(name: str) -> JaxFeatureConfig:
    return JaxFeatureConfig(use_spectral_contrast=True, **CONFIGS[name])


@pytest.fixture(scope="module")
def waves() -> np.ndarray:
    """fixture_batch's 8 clips, then silence, half silence, a click train."""
    n = 16000
    silent = np.zeros(n, np.float32)
    half = np.zeros(n, np.float32)
    half[n // 2 :] = np.random.default_rng(5).standard_normal(n // 2).astype(np.float32) * 0.1
    clicks = np.zeros(n, np.float32)
    clicks[::160] = 0.5
    return np.concatenate([synth.fixture_batch(8, 1.0, seed=6), np.stack([silent, half, clicks])])


@pytest.fixture(scope="module")
def jax_rows(waves):
    """Per config name, the JAX gemm contrast rows as (B, bands + 1, T)."""
    cache = {}

    def get(name):
        if name not in cache:
            rows = jax_frontend.spectral_contrast(waves, _jax_cfg(name), method="gemm")
            cache[name] = np.asarray(rows).transpose(0, 2, 1)
        return cache[name]

    return get


def _split(waves: np.ndarray, name: str, passes: int = 3) -> np.ndarray:
    return frontend_kernel.spectral_contrast_split_reference(
        torch.from_numpy(waves), _cfg(name), passes=passes
    ).numpy()


@pytest.mark.parametrize("name", list(CONFIGS))
def test_split_model_vs_jax_gemm_rows(waves, jax_rows, name):
    """The kernel's arithmetic, 3xTF32 over both windows' support and
    stable-rank tails, against the JAX rows on every clip, sweeps, silence
    and ties included."""
    got, want = _split(waves, name), jax_rows(name)
    cfg = _cfg(name)
    assert got.shape == want.shape == (len(waves), cfg.n_contrast_bands + 1, cfg.num_frames)
    assert np.isfinite(got).all()
    assert _rel(got, want) < TOL
    np.testing.assert_array_equal(got[8], 0.0)  # the silent clip's rows


@pytest.mark.parametrize("name", list(CONFIGS))
def test_one_pass_tf32_lacks_the_margin(waves, jax_rows, name):
    """Why the contrast launch keeps three TF32 passes: one pass lands
    within the 1e-3 budget but without a tenfold margin (above 1e-4) on
    every config, where three stay a hundred times inside it."""
    want = jax_rows(name)
    assert _rel(_split(waves, name, passes=1), want) > TOL / 10
    assert _rel(_split(waves, name, passes=3), want) < TOL / 100


@pytest.mark.parametrize("name", ["contrast", "all_flags"])
def test_hybrid_with_split_rows_vs_jax_launcher(waves, name):
    """The launcher's three launches as the card computes them (the pair's
    plain version on the config without contrast, the contrast launch's
    model on the un-emphasized waves) against the JAX launcher's hybrid
    with its Pallas kernel in interpret mode."""
    w = waves[[0, 2, 8, 10]]
    cfg = _cfg(name)
    base = dataclasses.replace(cfg, use_spectral_contrast=False)
    pair = frontend_kernel.frontend_kernel_reference(torch.from_numpy(w), base).numpy()
    got = np.concatenate([pair, _split(w, name)], axis=1)
    want = np.asarray(jax_fused(w, _jax_cfg(name), interpret=True))
    assert got.shape == want.shape == (4, cfg.num_features, cfg.num_frames)
    assert _rel(got, want) < TOL


def test_fused_on_cpu_is_the_plain_version_and_launches_nothing(waves):
    cfg = _cfg("contrast")
    w = torch.from_numpy(waves)
    before = frontend_kernel.CONTRAST_LAUNCHES
    got = frontend_kernel.spectral_contrast_fused(w, cfg)
    assert frontend_kernel.CONTRAST_LAUNCHES == before
    np.testing.assert_array_equal(got.numpy(), frontend_kernel.spectral_contrast_reference(w, cfg).numpy())
    assert got.shape == (len(waves), 7, 101)
    with pytest.raises(ValueError, match="segment_samples"):
        frontend_kernel.spectral_contrast_fused(w[:, :8000], cfg)


def test_launcher_appends_the_contrast_launch_rows(waves):
    """On CPU tensors the launcher's last rows are the contrast wrapper's,
    and the pair's plain versions give the rest; nothing is launched."""
    cfg = _cfg("all_flags")
    w = torch.from_numpy(waves[:4])
    before = tuple(getattr(frontend_kernel, c) for c in frontend_kernel.LAUNCH_COUNTERS)
    got = frontend_kernel.extract_features_fused(w, cfg).numpy()
    assert tuple(getattr(frontend_kernel, c) for c in frontend_kernel.LAUNCH_COUNTERS) == before
    base = dataclasses.replace(cfg, use_spectral_contrast=False)
    np.testing.assert_array_equal(got[:, base.num_features :], frontend_kernel.spectral_contrast_fused(w, cfg).numpy())
    np.testing.assert_array_equal(got[:, : base.num_features], frontend_kernel.frontend_kernel_reference(w, base).numpy())


def _decode(stream: torch.Tensor, n_passes: int, ks: int) -> np.ndarray:
    """A part of the chunk stream as the kernel's wgmma reads it (per pass
    and k-step a hi and a lo tile of 256 columns), summed: (8 ks, 256
    n_passes)."""
    v = stream.reshape(n_passes, ks, 2, 32, 2, 8, 4)
    return (v[:, :, 0] + v[:, :, 1]).permute(1, 3, 5, 0, 2, 4).reshape(8 * ks, -1).numpy()


@pytest.mark.parametrize("name", list(CONFIGS))
def test_table_stream_holds_both_windows_columns(name):
    """The chunk stream, decoded as the kernel's wgmma reads it, gives
    first the power passes: the power bins' win_length-window columns over
    the window's own k-steps [pow_k0, pow_k0 + pow_ks), which hold every
    nonzero tap of it; then the magnitude passes over [j0, j0 + kpad):
    every bin's n_fft-window columns, an even n_fft's DC and Nyquist
    cosines in the first pair; cos and -sin interleaved, zero past them
    and past the taps."""
    from cough_detector_tpu_torch.ops import filters

    cfg = _cfg(name)
    g = frontend_kernel._geometry(cfg)
    k = frontend_kernel._contrast_constants(cfg, torch.device("cpu"))
    head = g.pow_passes * g.pow_ks * 4096
    power = _decode(k.table[:head], g.pow_passes, g.pow_ks)
    mag = _decode(k.table[head:], g.n_passes - g.pow_passes, g.kpad // 8)
    assert k.table.numel() == head + (g.n_passes - g.pow_passes) * g.kpad // 8 * 4096
    c4, s4 = filters.dft_matrices(cfg.n_fft, cfg.win_length)
    c5, s5 = filters.dft_matrices(cfg.n_fft, cfg.n_fft)
    t0, p2, n = g.j0 + 8 * g.pow_k0, 2 * g.n_pow, g.j1 - g.j0
    bins = slice(g.pow_lo, g.pow_lo + g.n_pow)
    rows = min(8 * g.pow_ks, g.j1 - t0)
    assert not c4[:t0].any() and not c4[t0 + 8 * g.pow_ks :].any()  # the power window's support
    assert 8 * (g.pow_k0 + g.pow_ks) <= g.kpad and g.pow_ks % 2 == 0
    for got, want in ((power[:rows, 0:p2:2], c4[t0 : t0 + rows, bins]), (power[:rows, 1:p2:2], s4[t0 : t0 + rows, bins])):
        np.testing.assert_allclose(got, want, atol=2e-7)
    assert not power[rows:].any() and not power[:, p2:].any()
    taps, f2 = slice(g.j0, g.j1), 2 * g.n_mag
    if cfg.n_fft % 2 == 0:  # DC's and Nyquist's cosines in pair 0; their sines zero (to float64 rounding)
        half = cfg.n_fft // 2
        assert g.n_mag == g.n_freqs - 1
        np.testing.assert_allclose(mag[:n, 0], c5[taps, 0], atol=2e-7)
        np.testing.assert_allclose(mag[:n, 1], c5[taps, half], atol=2e-7)
        assert not s5[:, 0].any() and np.abs(s5[:, half]).max() < 1e-12
        cos, sin = c5[taps, 1:half], s5[taps, 1:half]
        got_cos, got_sin = mag[:n, 2:f2:2], mag[:n, 3:f2:2]
    else:
        cos, sin, got_cos, got_sin = c5[taps], s5[taps], mag[:n, 0:f2:2], mag[:n, 1:f2:2]
    np.testing.assert_allclose(got_cos, cos, atol=2e-7)
    np.testing.assert_allclose(got_sin, sin, atol=2e-7)
    assert not mag[n:].any() and not mag[:, f2:].any()
    assert not c5[: g.j0].any() and not c5[g.j1 :].any()


def test_geometry_of_the_shipped_bands():
    """Bins 1-115 feed the six bands (1, 2, 6, 13, 29, 64 bins), every bin
    the centroid. 511 taps: the power pass, 230 columns in one pass of 256,
    over the 400-tap window's 50 k-steps from the 8th; the magnitude, 512
    columns (256 pairs: the Nyquist cosine beside the DC one) in two
    passes over 64; a row tile's 178 chunks through a ring of 4 slots."""
    cfg = _cfg("contrast")
    g = frontend_kernel._geometry(cfg)
    assert (g.j0, g.j1, g.kpad, g.pow_lo, g.n_pow, g.n_freqs) == (1, 512, 512, 1, 115, 257)
    assert (g.pow_k0, g.pow_ks, g.n_mag, g.pow_passes, g.n_passes) == (7, 50, 256, 1, 3)
    assert g.widths == (1, 2, 6, 13, 29, 64)
    assert g.offsets == (0, 1, 3, 9, 22, 51)
    assert g.tops == (1, 1, 2, 3, 6, 13) and g.bots == (1, 1, 1, 2, 5, 12)
    assert frontend_kernel.contrast_ring(cfg) == (178, 4)
    assert frontend_kernel.contrast_threads(cfg) == 384


@pytest.mark.parametrize("name", list(CONFIGS))
def test_smem_mirror_and_grid(name):
    cfg = _cfg(name)
    assert frontend_kernel.contrast_smem_bytes(cfg) == SMEM_ON_CARD[name]
    # One block a clip, looping over its row tiles (2 at 201 frames) or its
    # FFT plan's frame groups, all in shared memory (level 0, plan 4): 384
    # threads a block on the GEMM plan (its band warps beside the MMA
    # warps), 256 on the FFT plan.
    assert frontend_kernel.contrast_level(cfg) == PLAN_ON_CARD[name]
    assert frontend_kernel.contrast_threads(cfg) == (256 if PLAN_ON_CARD[name] == 4 else 384)


@pytest.fixture(scope="module")
def c_rules(tmp_path_factory):
    """csrc/frontend_kernel.cu's plan rules built for the host with g++:
    a program that reads "n_fft hop kpad pow_ks n_pow n_frames n_bands"
    lines and prints plan_c, cdt_frontend_smem_c's bytes, the threads its
    entries launch (kThreadsA for the FFT plan, kThreadsC for the GEMM), and
    the GEMM plan's chunks_c and slots_c at its LayoutC."""
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
  int n_fft, hop, kpad, pow_ks, n_pow, n_frames, n_bands;
  while (scanf("%d %d %d %d %d %d %d", &n_fft, &hop, &kpad, &pow_ks, &n_pow, &n_frames, &n_bands) == 7) {
    const int plan = plan_c(n_fft, hop, kpad, n_pow, n_frames, n_bands);
    const LayoutC lay(hop, kpad, n_pow, n_frames, n_bands + 1);
    const size_t smem = plan == kPlanCFft ? LayoutF(n_fft, hop, n_pow).bytes() : lay.bytes(2);
    const int chunks = chunks_c(n_fft, kpad, pow_ks, n_pow);
    printf("%d %zu %d %d %d %d\n", plan, smem, plan == kPlanCFft ? kThreadsA : kThreadsC, lay.level, chunks, slots_c(lay, chunks));
  }
}""",
    ])
    d = tmp_path_factory.mktemp("c_rules")
    (d / "rules.cpp").write_text(code)
    subprocess.run([gxx, "-std=c++17", "-O1", "-o", str(d / "rules"), str(d / "rules.cpp")], check=True)
    return d / "rules"


# A config at each LayoutC level (the coverage configs that drive them on
# the card), and n_fft 1000 at hop 4 (an even n_fft under the FFT plan's
# 640 would take the GEMM; 1000 takes the FFT plan: threads 256).
LEVELS = {
    0: dict(),
    1: dict(hop_length=400),
    2: dict(segment_duration=60.0, n_mels=128, f_max=8000.0, use_pcen=True, use_pre_emphasis=True,
            use_delta_delta=True),
    3: dict(n_fft=2129, win_length=2129, hop_length=532, n_mels=256, f_max=8000.0),
}


@pytest.mark.parametrize("level", sorted(LEVELS))
def test_gemm_plan_mirror_equals_the_c_rule_at_each_level(c_rules, level):
    """At each LayoutC level, the Python mirrors' plan, shared memory,
    threads, a row tile's chunks and the ring's slots equal the kernel
    source's own rules (compiled for the host): cdt_frontend_plan_c's
    plan_c, cdt_frontend_smem_c's LayoutC bytes, kThreadsC, chunks_c and
    slots_c, which cdt_frontend_contrast launches by; the odd n_fft 2129
    (level 3) has no Nyquist pair to pack."""
    cfg = FeatureConfig(use_spectral_contrast=True, **LEVELS[level])
    g = frontend_kernel._geometry(cfg)
    line = f"{cfg.n_fft} {cfg.hop_length} {g.kpad} {g.pow_ks} {g.n_pow} {cfg.num_frames} {cfg.n_contrast_bands}"
    out = subprocess.run([str(c_rules)], input=line, capture_output=True, text=True, check=True).stdout.split()
    plan, smem, threads, lay_level, chunks, slots = map(int, out)
    assert plan == lay_level == level == frontend_kernel.contrast_level(cfg)
    assert smem == frontend_kernel.contrast_smem_bytes(cfg)
    assert threads == frontend_kernel.contrast_threads(cfg) == 384
    assert (chunks, slots) == frontend_kernel.contrast_ring(cfg)
    assert g.n_mag == g.n_freqs - (cfg.n_fft % 2 == 0)
    assert chunks == g.pow_passes * g.pow_ks + (g.n_passes - g.pow_passes) * g.kpad // 8


@pytest.mark.parametrize("kw, level", [
    ({}, 0), (dict(n_fft=1024), 4), (dict(n_contrast_bands=16), 0),
    (dict(n_contrast_bands=17), 0),  # the bands are read from device memory
    (dict(n_fft=2048), 4),           # a band of 239 bins, by FFT
    (dict(n_fft=1024, n_contrast_bands=8), 4),  # by FFT (the GEMM's span would pass shared memory)
    (dict(n_fft=2096, win_length=2096, hop_length=524), 4),  # by FFT: Bluestein's stage (a prime 131)
    (dict(n_fft=2192, win_length=2192, hop_length=548), 4),  # by FFT: Bluestein's stage (a prime 137)
    (dict(hop_length=400), 1),  # the GEMM's span past shared memory (a 25 ms hop)
    (dict(n_fft=2129, win_length=2129, hop_length=532), 3),  # and its power rows too (no FFT layout fits)
    (dict(n_fft=2000, win_length=2000, hop_length=500), 4),  # by FFT: radix-5 stages
    (dict(n_fft=3000, win_length=3000, hop_length=750), 4),  # by FFT: radix-3 and radix-5 stages
    (dict(n_fft=1792, win_length=1792, hop_length=448), 4),  # by FFT: radix-7 stages
    (dict(n_fft=2744, win_length=2744, hop_length=686), 4),  # by FFT: radix-7 stages
    (dict(n_fft=1760, win_length=1760, hop_length=440), 4),  # by FFT: radix-11 stages
    (dict(n_fft=2662, win_length=2662, hop_length=665), 4),  # by FFT: radix-11 stages, two frames a block
    (dict(n_fft=1125, win_length=1125, hop_length=281), 4),  # by FFT: an odd n_fft
    (dict(n_fft=1664, win_length=1664, hop_length=416), 4),  # by FFT: a radix-13 stage
    (dict(n_fft=2704, win_length=2704, hop_length=676), 4),  # by FFT: two radix-13 stages
    (dict(n_fft=5296, win_length=5296, hop_length=1324), 4),  # by FFT: a 581-bin band by the block
    (dict(n_fft=6144, win_length=6144, hop_length=1536), 4),  # by FFT: a 666-bin band by the block
    (dict(n_fft=6544, win_length=6544, hop_length=1636), 4),  # by FFT: Bluestein's rows of 825 points, four warps each
    (dict(n_fft=1987, win_length=1987, hop_length=496), 4),  # by FFT: the prime itself, rows of 3993 points
    (dict(n_fft=4608, win_length=4608, hop_length=1152, n_contrast_bands=8), 4),  # a 563-bin band by the block
    (dict(sample_rate=44100, n_fft=8192, win_length=8192, hop_length=2048, n_mels=128, f_max=22050.0), 4),  # 868 bins
])
def test_card_route_on_contrast_configs(kw, level):
    """The card route takes every contrast config the JAX launcher's hybrid
    takes, and so does the contrast launch: at the level of its layout
    that fits shared memory."""
    cfg = FeatureConfig(use_spectral_contrast=True, **kw)
    base = dataclasses.replace(cfg, use_spectral_contrast=False)
    assert frontend_kernel.kernel_supports(base, cfg.segment_samples)
    assert frontend_kernel.kernel_supports(cfg, cfg.segment_samples)
    assert frontend_kernel.contrast_level(cfg) == level
    assert frontend_kernel.contrast_smem_bytes(cfg) <= 232448


def test_custom_op_fake_gives_the_real_shape(waves):
    """torch.library.opcheck runs the fake beside the real op (here the
    plain version) and checks schema and output metadata."""
    cfg = _cfg("bands_4")
    args = frontend_kernel._op_args(cfg)
    w = torch.from_numpy(waves[:2])
    got = torch.ops.cdt.spectral_contrast(w, *args)
    assert got.shape == (2, 5, 101)
    torch.library.opcheck(torch.ops.cdt.spectral_contrast.default, (w, *args))
    np.testing.assert_array_equal(got.numpy(), frontend_kernel.spectral_contrast_fused(w, cfg).numpy())


GEMM_BAND_MAIN = r"""
int main() {
  int frames, n_pow, n_bands;
  if (scanf("%d %d %d", &frames, &n_pow, &n_bands) != 3) return 1;
  std::vector<int4> bands(n_bands);
  for (auto& b : bands)
    if (scanf("%d %d %d %d", &b.x, &b.y, &b.z, &b.w) != 4) return 2;
  std::vector<float> pw(frames * n_pow), con(n_bands * frames, -1e30f);
  for (auto& v : pw)
    if (scanf("%f", &v) != 1) return 3;
  std::unique_ptr<std::barrier<>> warps[kWarpsA];
  for (int w = 0; w < kWarpsA; ++w) {
    warps[w] = std::make_unique<std::barrier<>>(32);
    warp_barriers[w] = warps[w].get();
  }
  const int groups = (frames + kBandFrames - 1) / kBandFrames;
  std::vector<std::thread> threads;
  for (int t = 0; t < kThreadsA; ++t)
    threads.emplace_back([&, t] {
      threadIdx.x = t;
      const int lane = t & 31, warp = t >> 5;
      for (int j = warp; j < groups * n_bands; j += kWarpsA) {  // band_items' order, a warp an item
        const int i = n_bands - 1 - j / groups, f0 = kBandFrames * (j % groups);
        float v[kBandFrames];
        band_values<kBandFrames>(pw.data() + f0 * n_pow, n_pow, bands[i], lane, v);
        if (lane == 0)
          for (int f = 0; f < kBandFrames; ++f)
            if (f0 + f < frames) con[i * frames + f0 + f] = v[f];
      }
    });
  for (auto& th : threads) th.join();
  for (float v : con) printf("%.9g\n", v);
}
"""


@pytest.fixture(scope="module")
def gemm_bands(tmp_path_factory):
    """The GEMM plan's band items (band_values: bands to kSortedBand bins
    sorted, kBandFrames frames' networks interleaved; wider ones ranked)
    built for the host with g++, 8 warps of emulated lanes, a warp an item
    in band_items' order; the power rows hold whole frames (kBandFrames
    of them an item), as the tile's 128 rows do."""
    from test_torch_fft_plan import HOST_PRELUDE

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
        between("__device__ __forceinline__ float warp_sum", "// Named barrier kId over kCount threads"),
        GEMM_BAND_MAIN,
    ])
    d = tmp_path_factory.mktemp("gemm_bands")
    (d / "bands.cpp").write_text(code)
    subprocess.run([gxx, "-std=c++20", "-O2", "-pthread", "-w", "-o", str(d / "bands"), str(d / "bands.cpp")],
                   check=True)
    return d / "bands"


@pytest.mark.parametrize("kind", ["ties", "power"])
def test_gemm_band_items_built_for_the_host(gemm_bands, kind):
    """The band items of the GEMM plan's band warps and MMA warps
    (band_values), built for the host, on 6 frames (an item's 4, then 2
    and 2 past the clip's rows) and bands of 1 to 200 bins, one-bin tails
    and tails of all but one bin among them: each row equals the
    stable-rank tails' contrast in float64, sorted bands and ranked ones
    alike, ties and all."""
    from test_torch_fft_plan import _band_rows, _rank_tails

    rng = np.random.default_rng(["ties", "power"].index(kind) + 40)
    widths = (1, 2, 6, 13, 29, 32, 33, 64, 65, 100, 128, 129, 200)
    bands, lo = [], 0
    for i, w in enumerate(widths):
        n_top, n_bot = ((1, 1), (w - 1, 1), (1, w - 1))[i % 3] if i % 2 and w > 2 else (
            w - min(max(1, int(w * 0.8)), w - 1) if w > 1 else 1, max(1, int(w * 0.2)))
        bands.append((lo, w, n_top, n_bot))
        lo += w
    frames, rows = 6, _band_rows(kind, 8 * lo, rng).reshape(8, lo)  # 8 rows held, 6 frames read
    text = "\n".join([f"{frames} {lo} {len(bands)}", *(" ".join(map(str, b)) for b in bands),
                      *(f"{v:.9g}" for v in rows.reshape(-1))])
    out = subprocess.run([str(gemm_bands)], input=text, capture_output=True, text=True, check=True).stdout.split()
    con = np.array(out, dtype=np.float64).reshape(len(bands), frames)
    for f in range(frames):
        for i, (lo_b, w, n_top, n_bot) in enumerate(bands):
            top, bot = _rank_tails(rows[f, lo_b : lo_b + w], n_top, n_bot)
            want = np.log1p(top / n_top) - np.log1p(bot / n_bot) if w > 1 else 0.0
            assert abs(con[i, f] - want) <= 1e-6 * max(1.0, abs(want)), (kind, f, w, n_top, n_bot)
