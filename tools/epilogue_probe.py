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
Then as built (and the baselines) at n_fft 256 and with PCEN. Prints the
card's name and power limit first. Needs a CUDA card and nvcc; imports no
JAX.
"""

from __future__ import annotations

import argparse
import ctypes
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


def build_all(sources: dict) -> dict:
    kernel_build.BUILD_DIR.mkdir(parents=True, exist_ok=True)

    def one(item):
        n, (name, text) = item
        path = kernel_build.BUILD_DIR / f"epilogue_probe_{n}.cu"
        path.write_text(text)
        lib = path.with_suffix(".so")
        cmd = [kernel_build._nvcc(), *kernel_build.NVCC_FLAGS, "-o", str(lib), str(path)]
        subprocess.run(cmd, check=True, capture_output=True, text=True)
        handle = ctypes.CDLL(str(lib))
        p, i = ctypes.c_void_p, ctypes.c_int
        handle.cdt_frontend_epilogue.argtypes = [p, i, i, i, p, i, i, i, i, p, p]
        return name, handle

    with ThreadPoolExecutor(len(sources)) as pool:
        return dict(pool.map(one, enumerate(sources.items())))


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument(
        "--baseline", type=Path, action="append", default=[],
        help="another frontend_kernel.cu to time beside this one (repeatable)",
    )
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0], flush=True)

    sources = variants((kernel_build._CSRC / "frontend_kernel.cu").read_text())
    baselines = [f"baseline {path}" for path in args.baseline]
    for name, path in zip(baselines, args.baseline):
        sources[name] = path.read_text()
    libs = build_all(sources)
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)

    def setup(cfg: FeatureConfig):
        w = torch.from_numpy((rng.standard_normal((BATCH, cfg.segment_samples)) * 0.3).astype(np.float32))
        mel = frontend_kernel.power_mel_fused(w.to(dev), cfg)
        out = torch.empty((BATCH, cfg.num_features, cfg.num_frames), device=dev)
        want = frontend_kernel.mel_epilogue_reference(mel, cfg)
        dct = frontend_kernel._dct(cfg.n_mfcc, cfg.n_mels, dev)
        nbytes = 4 * BATCH * (cfg.n_mels + cfg.num_features) * cfg.num_frames
        return mel, out, want, dct, nbytes

    def time_lib(lib: ctypes.CDLL, cfg: FeatureConfig, state) -> tuple:
        mel, out, want, dct, _ = state

        def launch() -> None:
            err = lib.cdt_frontend_epilogue(
                mel.data_ptr(), BATCH, cfg.num_frames, cfg.n_mels, dct.data_ptr(), cfg.n_mfcc,
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

    shipped = FeatureConfig()
    state = setup(shipped)
    order = baselines + [n for n in libs if n not in baselines] + ["as built"] + baselines
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
