"""Launch B's span route (csrc/frontend_kernel.cu: span_mfcc_kernel,
span_var_kernel, span_rows_kernel) on the CPU: its model, its kernels
built for the host, and the JAX package on the same numpy inputs.

The route takes a clip past a cluster of 16 blocks over a grid of frame
spans, its reductions folded between three launches through a buffer of
partials. `mel_epilogue_span_reference` models it in torch: the spans, the
halos (PCEN's smoother, the MFCCs beside a span), the folds in the
kernels' order. It is held against the plain version
(`mel_epilogue_reference`) at spans of 16-48 frames, so that spans are
short and sit at a clip's edge, and against the JAX jnp chain on JAX's
own power mel. The kernels themselves, built with g++ (CUDA's names
shimmed, a block's 256 threads as std::threads meeting at std::barriers,
the blocks one after another), run the route at the same shapes against
the model. Budgets: 1e-5 max-relative against the plain version and the
model (float rounding of sums in another order), 1e-3 against JAX
(docs/PARITY.md).
"""

import shutil
import subprocess

import numpy as np
import pytest
import torch

from cough_detector_tpu.config import FeatureConfig as JaxFeatureConfig
from cough_detector_tpu.ops import frontend as jax_frontend
from cough_detector_tpu_torch.config import FeatureConfig
from cough_detector_tpu_torch.ops import frontend_kernel
from cough_detector_tpu_torch.utils import kernel_build
from test_torch_fft_plan import HOST_PRELUDE
from test_torch_frontend import CONFIGS, _clips, _jax_power_mel, _rel

TOL = 1e-3
MODEL_TOL = 1e-5
# (n_mels, n_mfcc, PCEN, delta-deltas): the dB branch and PCEN, with and
# without delta-deltas, 40, 64 and 128 mels; 36 MFCCs of 40 mels puts the
# MFCC and delta tiles after the mel tile.
BRANCHES = {
    "db64": (64, 13, False, False),
    "pcen64_dd": (64, 13, True, True),
    "db40_dd": (40, 13, False, True),
    "pcen40_mfcc36_dd": (40, 36, True, True),
    "db128_dd": (128, 13, False, True),
    "pcen128": (128, 13, True, False),
}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Small tensors: one intra-op thread for the module (its module-scoped
    work included), restored after it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(name: str, frames: int) -> FeatureConfig:
    m, c, pcen, dd = BRANCHES[name]
    return FeatureConfig(segment_duration=(frames - 1) / 100, n_mels=m, f_max=8000.0, n_mfcc=c, use_pcen=pcen,
                         use_delta_delta=dd)


def _mel(cfg: FeatureConfig, batch: int, seed: int) -> torch.Tensor:
    """A power mel with the range a clip's has: loud and silent stretches,
    exact zeros (the log's floor) in one clip."""
    rng = np.random.default_rng(seed)
    level = 10.0 ** rng.uniform(-9, 2, size=(batch, 1, cfg.num_frames))
    mel = (rng.random((batch, cfg.n_mels, cfg.num_frames)) ** 3 * level).astype(np.float32)
    mel[0, :, : cfg.num_frames // 7] = 0.0
    return torch.from_numpy(mel)


@pytest.mark.parametrize("frames", [101, 201])
@pytest.mark.parametrize("span", [16, 33, 48])
@pytest.mark.parametrize("name", list(BRANCHES))
def test_span_model_holds_the_plain_version(name, span, frames):
    """The model at spans of at most `span` frames (the last short, the
    first and last at the clip's edges) against the plain version."""
    cfg = _cfg(name, frames)
    assert cfg.num_frames == frames
    mel = _mel(cfg, 3, seed=span + frames)
    got = frontend_kernel.mel_epilogue_span_reference(mel, cfg, span)
    want = frontend_kernel.mel_epilogue_reference(mel, cfg)
    assert got.shape == want.shape == (3, cfg.num_features, frames)
    assert _rel(got.numpy(), want.numpy()) < MODEL_TOL


@pytest.mark.parametrize("name", ["shipped", "pcen", "pre_emphasis_delta_delta"])
def test_span_model_vs_jax(name):
    """Fed JAX's own power mel, the model at spans of 16 frames gives the
    JAX jnp chain's feature image."""
    kw = CONFIGS[name]
    w = _clips(5, seed=31, pcen=kw.get("use_pcen", False))
    jcfg = JaxFeatureConfig(**kw)
    mel = _jax_power_mel(w, jcfg)
    want = np.asarray(jax_frontend.make_feature_fn(jcfg)(w))
    got = frontend_kernel.mel_epilogue_span_reference(
        torch.from_numpy(np.ascontiguousarray(mel)), FeatureConfig(**kw), 16).numpy()
    assert got.shape == want.shape
    assert _rel(got, want) < TOL


def test_fold_spans_is_the_kernels_order():
    """_fold_spans folds as fold_spans does: lanes over spans l, l + 32,
    ..., then a butterfly; for a sum that is another order than a plain
    one's, within float rounding of it, and the same for every count of
    spans up to past 64."""
    rng = np.random.default_rng(3)
    for n in (1, 5, 32, 33, 98, 179):
        parts = torch.from_numpy(rng.standard_normal((2, n)).astype(np.float32))
        lanes = np.zeros((2, 32), np.float32)
        for k in range(n):
            lanes[:, k % 32] += parts[:, k].numpy()
        for off in (16, 8, 4, 2, 1):
            lanes = lanes + lanes[:, np.arange(32) ^ off]
        got = frontend_kernel._fold_spans(parts, torch.add)
        np.testing.assert_array_equal(got.numpy(), lanes[:, 0])
        np.testing.assert_allclose(got.numpy(), parts.double().sum(1).numpy(), rtol=1e-5, atol=1e-5)
        assert torch.equal(frontend_kernel._fold_spans(parts, torch.maximum), parts.amax(1))
        assert torch.equal(frontend_kernel._fold_spans(parts, torch.minimum), parts.amin(1))


# The span route's three kernels on the host: a block's 256 threads as
# std::threads, which take every block of a pass one after another (a
# barrier between blocks), the passes in order. Reads "T M C pcen dd n
# batch", then the power mel (batch, M, T) and the DCT table (M, C); runs
# n spans a clip; prints a span's shared memory and spans_b, then the
# features (batch, M + (2 + dd) C, T).
HOST_MAIN = r"""
float4 smem4[65536];
thread_local Dim3 blockIdx;

template <class F>
void run_grid(int blocks, F f) {
  std::barrier<> bar(kThreadsBC);
  block_barrier = &bar;
  std::unique_ptr<std::barrier<>> warps[kWarpsBC];
  for (int w = 0; w < kWarpsBC; ++w) {
    warps[w] = std::make_unique<std::barrier<>>(32);
    warp_barriers[w] = warps[w].get();
  }
  std::vector<std::thread> threads;
  for (int t = 0; t < kThreadsBC; ++t)
    threads.emplace_back([&, t] {
      threadIdx.x = t;
      for (int pass = 0; pass < 3; ++pass)
        for (int b = 0; b < blocks; ++b) {
          blockIdx.x = b;
          f(pass);
          bar.arrive_and_wait();  // the block's shared memory is free for the next
        }
    });
  for (auto& th : threads) th.join();
}

int main() {
  int T, M, C, pcen, dd, n, batch;
  if (scanf("%d %d %d %d %d %d %d", &T, &M, &C, &pcen, &dd, &n, &batch) != 7) return 1;
  const int F = M + (2 + dd) * C;
  std::vector<float> mel((size_t)batch * M * T), dct((size_t)M * C), out((size_t)batch * F * T, -1e30f);
  for (auto& v : mel)
    if (scanf("%f", &v) != 1) return 2;
  for (auto& v : dct)
    if (scanf("%f", &v) != 1) return 3;
  const size_t smem = cluster_bytes_b(T, M, C, pcen, dd, n);  // a span's LayoutB at ceil(T / n) frames
  if (smem > sizeof(smem4)) return 4;
  std::vector<float> scratch((size_t)batch * (C * T + kPartsB * n), -1e30f);
  float* raw = scratch.data();
  float* part = raw + (size_t)batch * C * T;
  run_grid(batch * n, [&](int pass) {
    if (pass == 0 && pcen) span_mfcc_kernel<true>(mel.data(), T, M, dct.data(), C, dd, F, n, raw, part, out.data());
    if (pass == 0 && !pcen) span_mfcc_kernel<false>(mel.data(), T, M, dct.data(), C, dd, F, n, raw, part, out.data());
    if (pass == 1) span_var_kernel(T, C, n, raw, part);
    if (pass == 2 && pcen) span_rows_kernel<true>(mel.data(), T, M, C, dd, F, n, raw, part, out.data());
    if (pass == 2 && !pcen) span_rows_kernel<false>(mel.data(), T, M, C, dd, F, n, raw, part, out.data());
  });
  printf("%zu %d\n", smem, spans_b(T, M, C, pcen, dd));
  for (float v : out) printf("%.9g\n", v);
}
"""


@pytest.fixture(scope="module")
def host_span(tmp_path_factory):
    """The span route's kernels and rules built for the host with g++."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is not installed")
    src = (kernel_build._CSRC / "frontend_kernel.cu").read_text()

    def between(a, b):
        i = src.index(a)
        return src[i : src.index(b, i)]

    code = "\n".join([
        HOST_PRELUDE,
        "#define __global__\n#define __launch_bounds__(...)\n#define __restrict__\n#define __shared__\n"
        "using std::max;\nextern float4 smem4[];\nextern thread_local Dim3 blockIdx;",
        between("constexpr int kWarpsA", "// Launch A's shared memory, in floats"),
        between("struct LayoutB {", "// x rounded to TF32"),
        between("// Launch B's reductions over its block of 4 warps", "// A clip's waveform as a row tile reads it"),
        between("// Calls f(r, c) for every r in [0, rows), c in [c0, c1) that this thread",
                "// Every thread of every block of the cluster arrives"),
        between("// Launch B where no cluster takes the clip", "// Launch C, the contrast rows"),
        HOST_MAIN,
    ])
    path = tmp_path_factory.mktemp("span")
    (path / "span.cpp").write_text(code)
    subprocess.run([gxx, "-std=c++20", "-O2", "-pthread", "-o", str(path / "span"), str(path / "span.cpp")],
                   check=True)

    def run(mel: torch.Tensor, cfg: FeatureConfig, n: int):
        b, m, t = mel.shape
        dct = frontend_kernel._dct(cfg.n_mfcc, m, torch.device("cpu"))
        text = (f"{t} {m} {cfg.n_mfcc} {int(cfg.use_pcen)} {int(cfg.use_delta_delta)} {n} {b}\n"
                + " ".join(f"{v:.9g}" for v in mel.flatten().tolist()) + "\n"
                + " ".join(f"{v:.9g}" for v in dct.flatten().tolist()))
        out = subprocess.run([str(path / "span")], input=text, capture_output=True, text=True, check=True)
        lines = out.stdout.split("\n")
        smem, spans = map(int, lines[0].split())
        feats = np.array(lines[1 : 1 + b * cfg.num_features * t], dtype=np.float32)
        return feats.reshape(b, cfg.num_features, t), smem, spans

    return run


@pytest.mark.parametrize("frames, span", [(101, 16), (201, 48)])
@pytest.mark.parametrize("name", list(BRANCHES))
def test_span_kernels_built_for_the_host(host_span, name, frames, span):
    """The kernels' own code, built for the host, at spans of at most
    `span` frames, against the model and the plain version; every
    element written."""
    cfg = _cfg(name, frames)
    mel = _mel(cfg, 2, seed=7 * span + frames)
    n = -(-frames // span)
    got, _, _ = host_span(mel, cfg, n)
    model = frontend_kernel.mel_epilogue_span_reference(mel, cfg, span).numpy()
    plain = frontend_kernel.mel_epilogue_reference(mel, cfg).numpy()
    assert np.isfinite(got).all()
    assert _rel(got, model) < MODEL_TOL
    assert _rel(got, plain) < MODEL_TOL


def test_span_kernels_at_the_route_own_spans(host_span):
    """A 12 s clip of 64 mels at the route's own spans (5 of 121 frames,
    what spans_b gives), shared memory and spans as the mirrors count
    them."""
    cfg = FeatureConfig(segment_duration=12.0, use_delta_delta=True)
    mel = _mel(cfg, 1, seed=5)
    n = frontend_kernel.epilogue_spans(cfg)
    got, smem, spans = host_span(mel, cfg, n)
    assert (spans, n) == (-(-cfg.num_frames // 128), 10)
    assert smem == frontend_kernel._cluster_bytes(cfg, n)
    assert _rel(got, frontend_kernel.mel_epilogue_span_reference(mel, cfg).numpy()) < MODEL_TOL
