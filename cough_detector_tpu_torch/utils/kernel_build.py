"""Build the port's CUDA kernels at first use and load them with ctypes.

Each `csrc/<name>.cu` exposes a plain C interface and compiles on its own:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC --split-compile=0 \
         -o build/kernels/lib<name>-<hash>.so csrc/<name>.cu

into `build/kernels/` at the repo root (listed in .gitignore). The file name
carries a hash of the source and the flags, so an edited source is rebuilt
and never served from a stale library. `load` compiles only when that file
is missing; callers keep the handle it returns (ops/frontend_kernel.py::build).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

_CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
    # The kernels' instantiations optimized in parallel, one a core: the
    # front end's 26 take ~13 s so instead of ~45 s on an 8-core host.
    "--split-compile=0",
]


def _nvcc() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError(
            "nvcc not found on PATH or in /usr/local/cuda/bin: the CUDA "
            "kernels build only where the CUDA toolkit is installed"
        )
    return found


def library_path(name: str) -> Path:
    src = (_CSRC / f"{name}.cu").read_bytes()
    tag = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{tag}.so"


def load(name: str) -> ctypes.CDLL:
    """The ctypes handle of `csrc/<name>.cu`, compiled first if its library
    is missing. Raises with nvcc's output on failure."""
    path = library_path(name)
    if not path.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = path.with_suffix(f".{os.getpid()}-{threading.get_ident()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(_CSRC / f"{name}.cu")]
        proc = subprocess.run(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(
                f"nvcc failed on {name}.cu (exit {proc.returncode}):\n{proc.stdout}"
            )
        os.replace(tmp, path)
    return ctypes.CDLL(str(path))
