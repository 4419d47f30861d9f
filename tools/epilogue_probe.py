"""Where the epilogue launch's time goes, on one NVIDIA card.

    python3 tools/epilogue_probe.py [--baseline PATH ...]

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
s at 128 mels with PCEN, pre-emphasis and delta-deltas at B = 64, and, in
device memory past a cluster of 16, 120 s at B = 32; each with the plan
the library returns (blocks a clip, shared memory a block); in turns the
baselines, as built, three variants (at most two blocks an SM, or four
with registers capped to match; portable clusters alone, up to 8 blocks),
as built, the baselines. Then every build's
launch B kernels' registers and stack frame (cuobjdump
--dump-resource-usage).
Prints the card's name and power limit first. Needs a CUDA card and nvcc;
imports no JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import re
import subprocess
import sys
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
    "clip120s_128_pcen_dd": (dict(segment_duration=120.0, n_mels=128, f_max=8000.0, use_pcen=True,
                                  use_delta_delta=True), 32),
}
BLOCKS_SM = "constexpr int kBlocksSM = 3;"

DCT = (
    "          const float4* w = reinterpret_cast<const float4*>(dct_s + m * lay.cp + c0);\n"
    "#pragma unroll\n"
    "          for (int q = 0; q < kC / 4; ++q) {\n"
    "            const float4 d = w[q];\n"
    "            acc[4 * q] = fmaf(lm, d.x, acc[4 * q]);\n"
    "            acc[4 * q + 1] = fmaf(lm, d.y, acc[4 * q + 1]);\n"
    "            acc[4 * q + 2] = fmaf(lm, d.z, acc[4 * q + 2]);\n"
    "            acc[4 * q + 3] = fmaf(lm, d.w, acc[4 * q + 3]);\n"
    "          }\n"
)
DB_ROWS = (
    "    for (int i = tid; i < nm; i += kThreadsB) {\n"
    "      const float db = fmaxf(log_mel(i), floor_db);\n"
    "      put(o + i, fminf(fmaxf((db + 80.0f) * 0.0125f, 0.0f), 1.0f));\n"
    "    }\n"
)


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
    }


def resources(path: Path) -> list:
    """(kernel, registers and stack) of each launch B kernel in a build."""
    cuobjdump = Path(kernel_build._nvcc()).with_name("cuobjdump")
    out = subprocess.run([str(cuobjdump), "--dump-resource-usage", str(path)],
                         check=True, capture_output=True, text=True).stdout.splitlines()

    def name(kernel: str, line: str) -> str:  # the template arguments of a mangled name, as written
        args = re.findall(r"L([bi])(\d+)E", line.split(kernel)[1].split("EEv")[0] + "E")
        return f"{kernel}<{', '.join(('true' if v == '1' else 'false') if t == 'b' else v for t, v in args)}>"

    return [
        (name(kernel, line), " ".join(out[i + 1].split()[:2]))
        for i, line in enumerate(out) if "Function" in line
        for kernel in ("epilogue_kernel", "epilogue_cluster_kernel") if kernel + "I" in line
    ]


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
        handle.cdt_frontend_epilogue.argtypes = [p, i, i, i, p, i, i, i, i, p, p]
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
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0], flush=True)

    src = (kernel_build._CSRC / "frontend_kernel.cu").read_text()
    sources = {} if args.cluster else variants(src)
    sources.update(cluster_variants(src))
    baselines = [f"baseline {path}" for path in args.baseline]
    for name, path in zip(baselines, args.baseline):
        sources[name] = path.read_text()
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

        def launch() -> None:
            err = lib.cdt_frontend_epilogue(
                mel.data_ptr(), batch, cfg.num_frames, cfg.n_mels, dct.data_ptr(), cfg.n_mfcc,
                int(cfg.use_pcen), int(cfg.use_delta_delta), cfg.num_features, out.data_ptr(),
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
    turns = baselines + ["cluster as built", *[n for n in libs if n.startswith("cluster,")],
                         "cluster as built"] + baselines
    for label, (kw, batch) in CLUSTER.items():
        cfg = FeatureConfig(**kw)
        state = setup(cfg, batch)
        bound = state[4] / PEAK_HBM_BYTES * 1e3
        b_args = (cfg.num_frames, cfg.n_mels, cfg.n_mfcc, int(cfg.use_pcen), int(cfg.use_delta_delta))
        plan = f"{lib.cdt_frontend_plan_b(*b_args)} blocks a clip, {lib.cdt_frontend_smem_b(*b_args)} B a block"
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
