"""Where the epilogue launch's time goes, on one NVIDIA card.

    python3 tools/epilogue_probe.py [--baseline PATH ...] [--cluster | --build-times]

Times launch B of the front-end kernel (csrc/frontend_kernel.cu: log, dB
or PCEN, DCT, z-norm, deltas) with CUDA events at B = 4096 on the shipped
config, as built and in variants, each a string edit of the source built
with the same nvcc flags into build/kernels/ (all builds run at once). The
variants that remove work keep every result they still compute in use, so
that the compiler cannot drop more than the variant says:
  - no DCT: the MFCC accumulators stay zero;
  - no output writes: every store of the output becomes an empty asm that
    takes the value, so the value is still computed;
  - no dB rows: the flat pass that writes them is left out (the clip's
    max is written once a block, so the log-mel's max is still taken);
  - no mel loads: each element of the tile is its own index instead of a
    load of the power mel (the log and everything after it still run).
Four variants compute the same features another way and are checked
against the plain version: (db + 80) / 80 as the reference writes it,
a division, instead of the kernel's multiply by 1/80 (a unit in the last
place apart); 8 loads in flight a thread instead of 16; registers capped
for 6 blocks an SM instead of 7; and a fast log (__logf) in the load pass
(a few units apart), which measures the log's share. Each --baseline is
another copy of the source (the same C interface) whose launch B is timed
in turns with this one: the baselines, as built, the variants, as built,
the baselines.
Then as built (and the baselines) at n_fft 256 and with PCEN.

The cluster section (alone with --cluster): launch B's cluster route
(epilogue_cluster_kernel, a clip over 2-16 blocks) on 5 s clips at 128
mels, 10 s clips, 10 s with PCEN, delta-deltas and 20 MFCCs, 10 s with 36
MFCCs of 40 mels and delta-deltas, at B = 1024, a hop of 4 at B = 256, 60
s at 128 mels with PCEN, pre-emphasis and delta-deltas at B = 64, 30 s at
128 mels with PCEN and delta-deltas at B = 128 and 60 s of the shipped
config at B = 64 (clusters of two blocks an SM), 40 s at 128 mels at B =
96 (one an SM); and past a cluster of 16, on the span route, 120 s at 128
mels with PCEN and delta-deltas at B = 32 and B = 1 and 150 s of the
shipped config at B = 32 (its dB branch); each with the plan the library
returns (plan, blocks a clip, shared memory a block); in turns the
baselines, as built, every clip past one block on the span route (plan_b's
boundary), three variants (at most two blocks an SM, or four with
registers capped to match; portable clusters alone, up to 8 blocks), on
the configs past a cluster the SPLIT variants of every source that holds
their text (each leaves out one part of the route past a cluster, or
does it another way: on the span route pass (a) alone, no pass (b), no
PCEN formula, no DCT, PCEN recomputed in pass (c), no output writes; on
the earlier device memory route, one block a clip, no PCEN pass, no DCT,
no rescale, no output writes), the span route past one block again, as
built, the baselines.
Then every build's
launch B kernels' registers and stack frame (cuobjdump
--dump-resource-usage).
`--build-times` builds the source as built and each baseline one at a
time, in turns (as built, the baselines, the baselines, as built), with
the library's own nvcc flags, and prints nvcc's seconds for each; no
card work.
Prints the card's name and power limit first. Needs a CUDA card and nvcc;
imports no JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import re
import subprocess
import sys
import time
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
ITERS = 20
PEAK_HBM_BYTES = 3.35e12
# The cluster section's configs (chip_smoke.py's coverage_configs) and
# their batches.
CLUSTER = {
    "clip5s_128": (dict(segment_duration=5.0, n_mels=128, f_max=8000.0), 1024),
    "clip10s": (dict(segment_duration=10.0), 1024),
    "clip10s_pcen_dd20": (dict(segment_duration=10.0, use_pcen=True, use_delta_delta=True, n_mfcc=20), 1024),
    "clip10s_mels40_mfcc36_dd": (dict(segment_duration=10.0, n_mels=40, n_mfcc=36, use_delta_delta=True), 1024),
    "hop4": (dict(hop_length=4), 256),
    "clip60s_128_pcen_dd": (dict(segment_duration=60.0, n_mels=128, f_max=8000.0, use_pcen=True,
                                 use_pre_emphasis=True, use_delta_delta=True), 64),
    # plan_b's boundary: clusters of two blocks an SM (30 s at 128 mels with
    # PCEN, 60 s of the shipped config) and of one (40 s at 128 mels).
    "clip30s_128_pcen_dd": (dict(segment_duration=30.0, n_mels=128, f_max=8000.0, use_pcen=True,
                                 use_delta_delta=True), 128),
    "clip60s_64": (dict(segment_duration=60.0), 64),
    "clip40s_128": (dict(segment_duration=40.0, n_mels=128, f_max=8000.0), 96),
    "clip120s_128_pcen_dd": (dict(segment_duration=120.0, n_mels=128, f_max=8000.0, use_pcen=True,
                                  use_delta_delta=True), 32),
    "clip120s_128_pcen_dd B=1": (dict(segment_duration=120.0, n_mels=128, f_max=8000.0, use_pcen=True,
                                      use_delta_delta=True), 1),
    "clip150s_64": (dict(segment_duration=150.0), 32),
}
# The configs past a cluster of 16, whose route is split by the variants
# of SPLIT.
PAST_CLUSTER = ("clip120s_128_pcen_dd", "clip120s_128_pcen_dd B=1", "clip150s_64")
BLOCKS_SM = "constexpr int kBlocksSM = 3;"

DCT = (
    "        const float4* w = reinterpret_cast<const float4*>(dct_s + m * lay.cp + c0);\n"
    "#pragma unroll\n"
    "        for (int q = 0; q < kC / 4; ++q) {\n"
    "          const float4 d = w[q];\n"
    "          acc[4 * q] = fmaf(lm, d.x, acc[4 * q]);\n"
    "          acc[4 * q + 1] = fmaf(lm, d.y, acc[4 * q + 1]);\n"
    "          acc[4 * q + 2] = fmaf(lm, d.z, acc[4 * q + 2]);\n"
    "          acc[4 * q + 3] = fmaf(lm, d.w, acc[4 * q + 3]);\n"
    "        }\n"
)
DB_ROWS = (
    "    for (int i = tid; i < nm; i += kThreadsB) {\n"
    "      const float db = fmaxf(log_mel(i), floor_db);\n"
    "      put(o + i, fminf(fmaxf((db + 80.0f) * 0.0125f, 0.0f), 1.0f));\n"
    "    }\n"
)


# The route past a cluster of 16, split: each variant leaves out one part
# and still computes what it keeps. (name, text, its replacement); a
# variant is built from each source that holds its text: the span route's
# (span_mfcc_kernel, span_var_kernel, span_rows_kernel), or the earlier
# device memory route (one block a clip, epilogue_kernel<..., true>).
SPAN_DCT = """      acc[0] = fmaf(lm, d0.x, acc[0]);
      acc[1] = fmaf(lm, d0.y, acc[1]);
      acc[2] = fmaf(lm, d0.z, acc[2]);
      acc[3] = fmaf(lm, d0.w, acc[3]);
      acc[4] = fmaf(lm, d1.x, acc[4]);
      acc[5] = fmaf(lm, d1.y, acc[5]);
      acc[6] = fmaf(lm, d1.z, acc[6]);
      acc[7] = fmaf(lm, d1.w, acc[7]);
"""
SPAN_A_DONE = """  cudaError_t launched = cudaLaunchKernel(fa, grid, threads, args_a, smem, stream);
  if (!launched) launched = cudaGetLastError();
  if (launched) return (int)launched;
"""
SPAN_B = "  launched = cudaLaunchKernel((const void*)span_var_kernel,"
SPAN_RESCALE = """  if (kPcen) {  // rescaled where (a) wrote them
    const float lo = fold_spans<kMin>(clip_part, n), hi = fold_spans<kMax>(clip_part + 1, n);
    load_b<false>(o, M, T, g0, a0, a1, [&](int m, int j, float v) {
      put(o + (size_t)m * T + g0 + j, (v - lo) / (hi - lo + 1e-8f));
    });
"""
SPAN_RECOMPUTE = """  if (kPcen) {  // recomputed from the mel
    const float lo = fold_spans<kMin>(clip_part, n), hi = fold_spans<kMax>(clip_part + 1, n);
    float* tile = red + lay.tile;
    load_b(src, M, T, g0, 0, W, [&](int m, int j, float v) { tile[m * W + j] = v; });
    __syncthreads();
    each_b(M, a0, a1, [&](int m, int j) {
      put(o + (size_t)m * T + g0 + j, (pcen_b(tile + m * W + j - 5) - lo) / (hi - lo + 1e-8f));
    });
    __syncthreads();  // the MFCC tile takes the mel tile's first rows
"""
SPLIT = (
    ("span route, pass (a) alone", SPAN_A_DONE, SPAN_A_DONE.replace("  if (launched) return", "  return")),
    ("span route, no pass (b)", SPAN_B, "  if (false)" + SPAN_B),
    ("span route, no PCEN formula (its tile reads kept)",
     "  for (int d = 0; d < 10; ++d) s += row[d];\n  s = s / 10.0f;\n  return sqrtf(row[5] / powf(1e-6f + s, 0.98f) + 2.0f)",
     "  for (int d = 0; d < 10; ++d) s += row[d];\n  s = s / 10.0f;\n  return (row[5] + s)"),
    ("span route, no DCT (its tile reads kept)", SPAN_DCT, "      acc[0] += lm;\n"),
    # Pass (a) writes no PCEN values, pass (c) computes them again from the mel.
    ("span route, PCEN recomputed in (c)", [("      put(o + (size_t)m * T + j, p);\n", ""),
                                            (SPAN_RESCALE, SPAN_RECOMPUTE)]),
    ("span route, no output writes (the raw MFCCs kept)",
     "void put(float* p, float v) { *p = v; }", 'void put(float* p, float v) { asm volatile("" ::"f"(v), "l"(p)); }'),
    ("device memory, no PCEN pass",
     "    const float* raw = kGlobal ? src : tile;\n    for (int t = tid; t < T; t += kThreadsB) {",
     "    const float* raw = kGlobal ? src : tile;\n    for (int t = tid; t < 0; t += kThreadsB) {"),
    ("device memory, no DCT",
     "        for (int m = 0; m < M; ++m) {\n          const float lm = log_mel(m * T + t);\n#pragma unroll\n"
     "          for (int c = 0; c < kC; ++c)\n"
     "            if (c0 + c < C) acc[c] = fmaf(lm, __ldg(dct + m * C + c0 + c), acc[c]);\n        }\n",
     ""),
    ("device memory, no rescale",
     "  if (kPcen) {  // rescale this thread's PCEN values\n", "  if (false) {  // rescale this thread's PCEN values\n"),
    ("device memory, no output writes (the MFCC rows it rereads kept)",
     "void put(float* p, float v) { *p = v; }", 'void put(float* p, float v) { asm volatile("" ::"f"(v), "l"(p)); }'),
)
SPAN_ROUTE = "span_rows_kernel"  # a source with the span route holds it; an earlier one, the device memory route


def split_variants(label: str, src: str) -> dict:
    """The SPLIT variants of `src`'s route past a cluster (the span route's
    where it has one) whose texts it holds, named after `label`. An entry
    is (name, text, its replacement) or (name, [(text, replacement), ...])."""
    span, out = SPAN_ROUTE in src, {}
    for name, *edits in SPLIT:
        edits = edits[0] if len(edits) == 1 else [tuple(edits)]
        if name.startswith("span route") != span or not all(old in src for old, _ in edits):
            continue
        text = src
        for old, new in edits:
            text = text.replace(old, new, 1)
        out[f"{label}: {name}"] = text
    return out


def edit(src: str, old: str, new: str, after: str = "") -> str:
    """src with the first `old` past the text `after` replaced by `new`."""
    start = src.index(after) if after and after in src else 0
    at = src.find(old, start)
    if (after and after not in src) or at < 0:
        raise SystemExit(f"the source no longer holds the text this variant edits: {old[:60]!r}")
    return src[:at] + new + src[at + len(old):]


def variants(src: str) -> dict:
    return {
        "as built": src,
        "no DCT": edit(src, DCT, ""),
        "no output writes": edit(
            src, "void put(float* p, float v) { *p = v; }",
            'void put(float* p, float v) { asm volatile("" ::"f"(v), "l"(p)); }',
        ),
        "no dB rows": edit(src, DB_ROWS, "    if (tid == 0) put(o, floor_db);\n"),
        "no mel loads": edit(src, "v[u] = i < nm ? __ldg(src + i) : 1.0f;", "v[u] = i < nm ? (float)i : 1.0f;"),
        "divide by 80": edit(src, "(db + 80.0f) * 0.0125f", "(db + 80.0f) / 80.0f"),
        "8 loads in flight": edit(src, "constexpr int kLoadB = 16;", "constexpr int kLoadB = 8;"),
        "registers for 6 blocks an SM": edit(
            src, "__launch_bounds__(kThreadsB, 7) epilogue_kernel", "__launch_bounds__(kThreadsB, 6) epilogue_kernel"
        ),
        "fast log (__logf)": edit(src, "kDbScale * logf(fmaxf(v[u], kAmin))", "kDbScale * __logf(fmaxf(v[u], kAmin))"),
    }


def cluster_variants(src: str) -> dict:
    """The cluster route's plan for at most two or four blocks an SM (four
    with registers capped to match), and with portable clusters alone."""
    four = edit(src, BLOCKS_SM, "constexpr int kBlocksSM = 4;")
    return {
        "cluster as built": src,
        "cluster, 2 blocks an SM at most": edit(src, BLOCKS_SM, "constexpr int kBlocksSM = 2;"),
        "cluster, 4 blocks an SM at most": edit(
            four, "__launch_bounds__(kThreadsBC, 3) epilogue_cluster_kernel",
            "__launch_bounds__(kThreadsBC, 4) epilogue_cluster_kernel",
        ),
        "cluster, portable clusters only (8 blocks)": edit(
            src, "constexpr int kMaxCluster = 16;", "constexpr int kMaxCluster = 8;"
        ),
        # plan_b's boundary: every clip past one block on the span route.
        "span route past one block": edit(
            src, "  if (!use_pcen && C <= kMaxClusterMfcc)\n", "  if (false)\n",
        ),
    }


def resources(path: Path) -> list:
    """(kernel, registers and stack) of each launch B kernel in a build."""
    cuobjdump = Path(kernel_build._nvcc()).with_name("cuobjdump")
    out = subprocess.run([str(cuobjdump), "--dump-resource-usage", str(path)],
                         check=True, capture_output=True, text=True).stdout.splitlines()

    def name(kernel: str, line: str) -> str:  # the template arguments of a mangled name, as written
        if kernel + "I" not in line:
            return kernel
        args = re.findall(r"L([bi])(\d+)E", line.split(kernel)[1].split("EEv")[0] + "E")
        return f"{kernel}<{', '.join(('true' if v == '1' else 'false') if t == 'b' else v for t, v in args)}>"

    kernels = ("epilogue_kernel", "epilogue_cluster_kernel", "span_mfcc_kernel", "span_var_kernel", "span_rows_kernel")
    return [
        (name(kernel, line), " ".join(out[i + 1].split()[:2]))
        for i, line in enumerate(out) if "Function" in line
        for kernel in kernels if re.search(rf"\d{kernel}[IE]", line)
    ]


def build_times(sources: dict) -> None:
    """nvcc's seconds for each source, one build at a time, in turns."""
    kernel_build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    names = list(sources)
    for turn, name in enumerate(names + names[::-1]):
        path = kernel_build.BUILD_DIR / f"epilogue_probe_time_{names.index(name)}.cu"
        path.write_text(sources[name])
        cmd = [kernel_build._nvcc(), *kernel_build.NVCC_FLAGS, "-o", str(path.with_suffix(".so")), str(path)]
        t0 = time.perf_counter()
        subprocess.run(cmd, check=True, capture_output=True)
        print(f"build {turn + 1}, {name}: {time.perf_counter() - t0:.1f} s of nvcc", flush=True)


def build_all(sources: dict) -> dict:
    kernel_build.BUILD_DIR.mkdir(parents=True, exist_ok=True)

    def one(item):
        n, (name, text) = item
        path = kernel_build.BUILD_DIR / f"epilogue_probe_{n}.cu"
        path.write_text(text)
        lib = path.with_suffix(".so")
        cmd = [kernel_build._nvcc(), *kernel_build.NVCC_FLAGS, "-o", str(lib), str(path)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode:
            raise SystemExit(f"nvcc failed on {name}:\n{proc.stdout}{proc.stderr}")
        handle = ctypes.CDLL(str(lib))
        p, i = ctypes.c_void_p, ctypes.c_int
        # A source with the span route takes its scratch before the output.
        handle.spans = hasattr(handle, "cdt_frontend_blocks_b")
        handle.cdt_frontend_epilogue.argtypes = [p, i, i, i, p, i, i, i, i] + [p] * (3 if handle.spans else 2)
        for fn in ("plan_b", "blocks_b") if handle.spans else ("plan_b",):
            getattr(handle, f"cdt_frontend_{fn}").argtypes = [i] * 5
        handle.path = lib
        return name, handle

    with ThreadPoolExecutor(len(sources)) as pool:
        return dict(pool.map(one, enumerate(sources.items())))


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument(
        "--baseline", type=Path, action="append", default=[],
        help="another frontend_kernel.cu to time beside this one (repeatable)",
    )
    parser.add_argument("--cluster", action="store_true", help="only the cluster route's section")
    parser.add_argument("--build-times", action="store_true", help="nvcc's seconds, one build at a time")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0], flush=True)

    src = (kernel_build._CSRC / "frontend_kernel.cu").read_text()
    if args.build_times:
        build_times({"as built": src, **{f"baseline {path}": path.read_text() for path in args.baseline}})
        return
    sources = {} if args.cluster else variants(src)
    cluster_names = list(cluster_variants(src))
    sources.update(cluster_variants(src))
    baselines = [f"baseline {path}" for path in args.baseline]
    for name, path in zip(baselines, args.baseline):
        sources[name] = path.read_text()
    split = {}
    for label in ["cluster as built", *baselines]:
        split.update(split_variants(label, sources[label]))
    sources.update(split)
    libs = build_all(sources)
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)

    def setup(cfg: FeatureConfig, batch: int = BATCH):
        # 64 clips repeated to the batch: the times do not depend on the content.
        w = torch.from_numpy((rng.standard_normal((min(batch, 64), cfg.segment_samples)) * 0.3).astype(np.float32))
        w = w.to(dev).repeat(-(-batch // 64), 1)[:batch].contiguous()
        mel = frontend_kernel.power_mel_fused(w, cfg)
        del w
        out = torch.empty((batch, cfg.num_features, cfg.num_frames), device=dev)
        want = frontend_kernel.mel_epilogue_reference(mel, cfg)
        dct = frontend_kernel._dct(cfg.n_mfcc, cfg.n_mels, dev)
        nbytes = 4 * batch * (cfg.n_mels + cfg.num_features) * cfg.num_frames
        return mel, out, want, dct, nbytes

    def time_lib(lib: ctypes.CDLL, cfg: FeatureConfig, state) -> tuple:
        mel, out, want, dct, _ = state
        batch = mel.shape[0]
        b_args = (cfg.num_frames, cfg.n_mels, cfg.n_mfcc, int(cfg.use_pcen), int(cfg.use_delta_delta))
        # The span route's scratch, by this build's own plan: the raw MFCCs,
        # then 4 partials a span.
        buf = None
        if lib.spans and lib.cdt_frontend_plan_b(*b_args) == 0:
            buf = torch.empty(batch * (cfg.n_mfcc * cfg.num_frames + 4 * lib.cdt_frontend_blocks_b(*b_args)),
                              device=dev)
        scratch = [None if buf is None else buf.data_ptr()] if lib.spans else []
        out.fill_(float("nan"))  # an element the build leaves unwritten shows as nan

        def launch() -> None:
            err = lib.cdt_frontend_epilogue(
                mel.data_ptr(), batch, cfg.num_frames, cfg.n_mels, dct.data_ptr(), cfg.n_mfcc,
                int(cfg.use_pcen), int(cfg.use_delta_delta), cfg.num_features, *scratch, out.data_ptr(),
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
        for _ in range(ITERS):
            launch()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / ITERS, err

    if not args.cluster:
        one_block(libs, baselines, setup, time_lib)
    lib = frontend_kernel.build()
    for label, (kw, batch) in CLUSTER.items():
        turns = baselines + ["cluster as built", *cluster_names[::-1][:-1], *(split if label in PAST_CLUSTER else ()),
                             cluster_names[-1], "cluster as built"] + baselines
        cfg = FeatureConfig(**kw)
        state = setup(cfg, batch)
        bound = state[4] / PEAK_HBM_BYTES * 1e3
        b_args = (cfg.num_frames, cfg.n_mels, cfg.n_mfcc, int(cfg.use_pcen), int(cfg.use_delta_delta))
        plan = (f"plan {lib.cdt_frontend_plan_b(*b_args)}, {lib.cdt_frontend_blocks_b(*b_args)} blocks a clip, "
                f"{lib.cdt_frontend_smem_b(*b_args)} B a block")
        for name in turns:
            ms, err = time_lib(libs[name], cfg, state)
            print(
                f"epilogue launch B={batch}, {label} (as built: {plan}), {name}: {ms:.4f} ms ({100 * bound / ms:.1f}% "
                f"of the {bound:.4f} ms bytes bound), max-relative vs plain {err:.2e}",
                flush=True,
            )
        del state
        torch.cuda.empty_cache()
    for name in dict.fromkeys(["cluster as built"] + baselines):
        for kernel, usage in resources(libs[name].path):
            print(f"{name}: {kernel}: {usage} (cuobjdump --dump-resource-usage)", flush=True)


def one_block(libs: dict, baselines: list, setup, time_lib) -> None:
    """The one-block route's section, on the shipped config, n_fft 256 and
    PCEN."""
    shipped = FeatureConfig()
    state = setup(shipped)
    order = baselines + [n for n in libs if n not in baselines and not n.startswith("cluster")] + ["as built"] + baselines
    bound = state[4] / PEAK_HBM_BYTES * 1e3
    for name in order:
        ms, err = time_lib(libs[name], shipped, state)
        print(
            f"epilogue launch B={BATCH}, shipped, {name}: {ms:.4f} ms ({100 * bound / ms:.1f}% of the "
            f"{bound:.4f} ms bytes bound), max-relative vs plain {err:.2e}",
            flush=True,
        )
    for label, cfg in (
        ("n_fft=256", FeatureConfig(n_fft=256, win_length=200, hop_length=80)),
        ("pcen", FeatureConfig(use_pcen=True)),
    ):
        state = setup(cfg)
        bound = state[4] / PEAK_HBM_BYTES * 1e3
        for name in baselines + ["as built"]:
            ms, err = time_lib(libs[name], cfg, state)
            print(
                f"epilogue launch B={BATCH}, {label}, {name}: {ms:.4f} ms ({100 * bound / ms:.1f}% of "
                f"the {bound:.4f} ms bytes bound), max-relative vs plain {err:.2e}",
                flush=True,
            )


if __name__ == "__main__":
    main()
