"""Build the port's C++ libraries at first use and load them with ctypes.

Each `native/<name>.cpp` exposes a plain C interface and compiles on its own:

    g++ -O3 -fPIC -shared -pthread -std=c++17 \
        -o build/native/lib<name>-<hash>.so native/<name>.cpp

into `build/native/` at the repo root (listed in .gitignore). As in
`kernel_build.py`, the file name carries a hash of the source and the
flags, so an edited source is rebuilt and never served from a stale
library, and a build goes to a temporary file that `os.replace` puts in
place, so processes that build at once never read a half-written one.
Callers keep the handle `load` returns (data/native_loader.py,
serve/native_ingest.py).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

_SRC = Path(__file__).resolve().parents[1] / "native"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
GXX_FLAGS = ["-O3", "-fPIC", "-shared", "-pthread", "-std=c++17"]


def library_path(name: str) -> Path:
    src = (_SRC / f"{name}.cpp").read_bytes()
    tag = hashlib.sha256(src + " ".join(GXX_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{tag}.so"


def build(name: str) -> Path:
    """The path of `native/<name>.cpp`'s library, compiled first if it is
    missing. Raises RuntimeError with g++'s output on failure, or when
    there is no g++."""
    path = library_path(name)
    if path.exists():
        return path
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError(f"g++ not found on PATH: cannot build native/{name}.cpp")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(f".{os.getpid()}-{threading.get_ident()}.tmp")
    proc = subprocess.run(
        [gxx, *GXX_FLAGS, "-o", str(tmp), str(_SRC / f"{name}.cpp")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"g++ failed on native/{name}.cpp (exit {proc.returncode}):\n{proc.stdout}"
        )
    os.replace(tmp, path)
    return path


def load(name: str) -> ctypes.CDLL:
    """The ctypes handle of `native/<name>.cpp`'s library (see `build`)."""
    return ctypes.CDLL(str(build(name)))
