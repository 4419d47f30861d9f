"""Build the port's C++ sources at first use: libraries loaded with ctypes,
and programs run as processes.

Each `native/<name>.cpp` compiles on its own. A library exposes a plain C
interface:

    g++ -O3 -fPIC -shared -pthread -std=c++17 \
        -o build/native/lib<name>-<hash>.so native/<name>.cpp

and a program (the bench's load generator, native/cdt_loadgen.cpp) has a
`main`:

    g++ -O3 -pthread -std=c++17 -o build/native/<name>-<hash> native/<name>.cpp

Both go into `build/native/` at the repo root (listed in .gitignore), never
beside the sources. As in `kernel_build.py`, the file name carries a hash
of the source and that mode's flags, so an edited source is rebuilt and
never served from a stale build, and a build goes to a temporary file that
`os.replace` puts in place, so processes that build at once never read a
half-written one. Callers keep the handle `load` returns
(data/native_loader.py, serve/native_ingest.py).
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
EXE_FLAGS = ["-O3", "-pthread", "-std=c++17"]


def _tag(name: str, flags: list) -> str:
    src = (_SRC / f"{name}.cpp").read_bytes()
    return hashlib.sha256(src + " ".join(flags).encode()).hexdigest()[:16]


def library_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}-{_tag(name, GXX_FLAGS)}.so"


def executable_path(name: str) -> Path:
    return BUILD_DIR / f"{name}-{_tag(name, EXE_FLAGS)}"


def _compile(name: str, path: Path, flags: list) -> Path:
    """`path`, compiled from `native/<name>.cpp` with `flags` first if it is
    missing. Raises RuntimeError with g++'s output on failure, or when there
    is no g++."""
    if path.exists():
        return path
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError(f"g++ not found on PATH: cannot build native/{name}.cpp")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f"{path.name}.{os.getpid()}-{threading.get_ident()}.tmp")
    proc = subprocess.run(
        [gxx, *flags, "-o", str(tmp), str(_SRC / f"{name}.cpp")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"g++ failed on native/{name}.cpp (exit {proc.returncode}):\n{proc.stdout}"
        )
    os.replace(tmp, path)
    return path


def build(name: str) -> Path:
    """The path of `native/<name>.cpp`'s library, compiled first if it is
    missing (see `_compile`)."""
    return _compile(name, library_path(name), GXX_FLAGS)


def build_executable(name: str) -> Path:
    """The path of `native/<name>.cpp`'s program, compiled first if it is
    missing (see `_compile`)."""
    return _compile(name, executable_path(name), EXE_FLAGS)


def load(name: str) -> ctypes.CDLL:
    """The ctypes handle of `native/<name>.cpp`'s library (see `build`)."""
    return ctypes.CDLL(str(build(name)))
