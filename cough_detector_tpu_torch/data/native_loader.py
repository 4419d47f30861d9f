"""ctypes bindings for the native (C++) batch loader.

The port of `cough_detector_tpu/data/native_loader.py`. The library is the
port's own copy of the loader, `native/cdt_loader.cpp`, built at first use
into `build/native/` (utils/native_build.py). It decodes, resamples and
center-fits whole batches of WAV files on its own threads, without the
interpreter lock, within 2e-5 of the Python decoder (data/audio_io.py), with
the same quarantine semantics: a clip that fails is a zero row, counted and
named in an error summary.

`available()` is False when the library cannot be built (no g++); it says
so once, and `BatchLoader(backend="auto")` then decodes in Python.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Optional, Sequence, Tuple

import numpy as np

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_error: Optional[str] = None


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    lib.cdt_load_batch_shifted.restype = ctypes.c_int
    lib.cdt_load_batch_shifted.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int,
        ctypes.c_long, ctypes.POINTER(ctypes.c_double),
        ctypes.POINTER(ctypes.c_float), ctypes.c_int,
        ctypes.c_char_p, ctypes.c_int,
    ]
    lib.cdt_load_clip.restype = ctypes.c_long
    lib.cdt_load_clip.argtypes = [
        ctypes.c_char_p, ctypes.c_int,
        ctypes.POINTER(ctypes.c_float), ctypes.c_long,
        ctypes.c_char_p, ctypes.c_int,
    ]
    return lib


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _error
    with _lock:
        if _lib is None and _error is None:
            from ..utils import native_build

            try:
                _lib = _bind(native_build.load("cdt_loader"))
            except (RuntimeError, OSError, AttributeError) as err:
                _error = str(err)
                print(f"native loader unavailable ({_error.splitlines()[0]}); "
                      "using the python decode path")
        return _lib


def available() -> bool:
    return _load() is not None


def require() -> ctypes.CDLL:
    """The library's handle; raises RuntimeError with the build's error
    when it cannot be built."""
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native loader unavailable: {_error}")
    return lib


def load_batch(
    paths: Sequence[str],
    segment_samples: int,
    target_sr: int = 16000,
    n_threads: int = 8,
    shift_fracs: Optional[np.ndarray] = None,
) -> Tuple[np.ndarray, int, str]:
    """Decode, resample and center-fit a batch of WAV paths natively.

    Returns (waves (N, segment) float32, n_ok, error_summary). A failed
    clip is a zero row, and its error is in the summary. `shift_fracs`
    (optional, one per clip) moves each crop window by round(frac *
    clip_len) samples: the crop-time time shift of datasets._crop_window.
    """
    lib = require()
    n = len(paths)
    out = np.zeros((n, segment_samples), np.float32)
    c_paths = (ctypes.c_char_p * n)(*[str(p).encode() for p in paths])
    errbuf = ctypes.create_string_buffer(4096)
    if shift_fracs is not None:
        fr = np.ascontiguousarray(shift_fracs, dtype=np.float64)
        fr_ptr = fr.ctypes.data_as(ctypes.POINTER(ctypes.c_double))
    else:
        fr_ptr = ctypes.POINTER(ctypes.c_double)()
    n_ok = lib.cdt_load_batch_shifted(
        c_paths, n, target_sr, segment_samples, fr_ptr,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        n_threads, errbuf, len(errbuf),
    )
    return out, int(n_ok), errbuf.value.decode(errors="replace")


def load_clip(path: str, target_sr: int = 16000, max_seconds: float = 600.0) -> np.ndarray:
    """Decode and resample one WAV to mono float32 (at most max_seconds);
    raises AudioDecodeError for a file the decoder refuses."""
    lib = require()
    cap = int(target_sr * max_seconds)
    out = np.empty(cap, np.float32)
    errbuf = ctypes.create_string_buffer(1024)
    n = lib.cdt_load_clip(
        str(path).encode(), target_sr,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        cap, errbuf, len(errbuf),
    )
    if n < 0:
        from .audio_io import AudioDecodeError

        raise AudioDecodeError(errbuf.value.decode(errors="replace"))
    return out[:n].copy()
