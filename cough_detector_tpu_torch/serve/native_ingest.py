"""ctypes bindings for the native (C++) serving socket plane.

The port of `cough_detector_tpu/serve/native_ingest.py`. The port's copy of
the plane, `native/cdt_ingest.cpp` (built at first use into `build/native/`
by utils/native_build.py), owns the daemon's whole socket tier: accept,
framing, slot allocation, per-slot ring buffers, event encoding and
writeback, on its own epoll threads with no Python in the per-frame path.
The Python server keeps the device plane and calls `granted()` at each tick
start (new tenants to scrub), `assemble()` to fill the (S, chunk) batch, and
`send_events()` from the delivery router. The wire protocol is the python
socket tier's (docs/PROTOCOL.md).
"""

from __future__ import annotations

import ctypes
import socket
import threading
from typing import List, Optional, Tuple

import numpy as np

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_error: Optional[str] = None


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    lib.cdt_ingest_start.restype = ctypes.c_void_p
    lib.cdt_ingest_start.argtypes = [
        ctypes.c_char_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_long, ctypes.c_int, ctypes.c_char_p, ctypes.c_int,
    ]
    lib.cdt_ingest_port.restype = ctypes.c_int
    lib.cdt_ingest_port.argtypes = [ctypes.c_void_p]
    lib.cdt_ingest_granted.restype = ctypes.c_int
    lib.cdt_ingest_granted.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_uint),
        ctypes.POINTER(ctypes.c_float), ctypes.c_int,
    ]
    lib.cdt_ingest_thresh_updates.restype = ctypes.c_int
    lib.cdt_ingest_thresh_updates.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_float), ctypes.c_int,
    ]
    lib.cdt_ingest_assemble.restype = ctypes.c_int
    lib.cdt_ingest_assemble.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_float)]
    lib.cdt_ingest_assemble_i16.restype = ctypes.c_int
    lib.cdt_ingest_assemble_i16.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_short)]
    lib.cdt_ingest_assemble_u8.restype = ctypes.c_int
    lib.cdt_ingest_assemble_u8.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_ubyte)]
    lib.cdt_ingest_ready.restype = ctypes.c_int
    lib.cdt_ingest_ready.argtypes = [ctypes.c_void_p]
    lib.cdt_ingest_readiness.restype = ctypes.c_int
    lib.cdt_ingest_readiness.argtypes = [ctypes.c_void_p]
    lib.cdt_ingest_send_events.restype = None
    lib.cdt_ingest_send_events.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_uint),
        ctypes.POINTER(ctypes.c_double),
        ctypes.POINTER(ctypes.c_float),
    ]
    lib.cdt_ingest_stats.restype = None
    lib.cdt_ingest_stats.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_longlong), ctypes.c_int]
    lib.cdt_ingest_stop.restype = None
    lib.cdt_ingest_stop.argtypes = [ctypes.c_void_p]
    return lib


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _error
    with _lock:
        if _lib is None and _error is None:
            from ..utils import native_build

            try:
                _lib = _bind(native_build.load("cdt_ingest"))
            except (RuntimeError, OSError, AttributeError) as err:
                _error = str(err)
                print(f"native ingest unavailable ({_error.splitlines()[0]}); "
                      "python socket tier in use")
        return _lib


def available() -> bool:
    """True when the plane's library builds and loads (says once if not)."""
    return _load() is not None


def require() -> ctypes.CDLL:
    """The library's handle; raises RuntimeError with the build's error
    when it cannot be built."""
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native ingest unavailable: {_error}")
    return lib


class NativeIngest:
    """One native socket plane (see module docstring).

    Every call into the C ABI holds one re-entrant lock, so a call racing
    `stop()` (a /stats scrape during shutdown) can never hand the library
    a freed handle; after `stop()` the calls are no-ops and `stats()`
    returns the snapshot taken at stop."""

    def __init__(
        self,
        host: str,
        port: int,
        num_streams: int,
        chunk: int,
        buffer_cap: int,
        num_workers: int = 1,
    ):
        """`num_workers`: the plane's epoll I/O threads. Connections
        partition across them round-robin at accept; the slot registry is
        shared, so assemble(), granted() and send_events() mean the same
        at any count."""
        self._lib = require()
        # The C plane binds with inet_pton (numeric IPv4 only): names such
        # as "localhost" resolve here, as the python tier accepts them.
        try:
            host_ip = socket.getaddrinfo(host, None, socket.AF_INET)[0][4][0]
        except socket.gaierror as err:
            raise OSError(f"cannot resolve host {host!r}: {err}") from err
        errbuf = ctypes.create_string_buffer(256)
        self._h = self._lib.cdt_ingest_start(
            host_ip.encode(), port, num_streams, chunk, buffer_cap,
            int(num_workers), errbuf, len(errbuf),
        )
        if not self._h:
            raise OSError(f"native ingest start failed: {errbuf.value.decode(errors='replace')}")
        self.num_streams = num_streams
        self.chunk = chunk
        self.address = (host, int(self._lib.cdt_ingest_port(self._h)))
        self._ids = np.empty(num_streams, np.int32)
        self._gens = np.empty(num_streams, np.uint32)
        self._thrs = np.empty(num_streams, np.float32)
        self._final_stats: Optional[dict] = None
        self._call_lock = threading.RLock()

    @staticmethod
    def _ptr(a: np.ndarray, ctype):
        return a.ctypes.data_as(ctypes.POINTER(ctype))

    def granted(self) -> List[Tuple[int, int, Optional[float]]]:
        """(slot, generation, threshold) for each slot granted since the
        last call; threshold is the tenant's from its OPEN frame, or None
        for the server default. The call activates the slots for assembly:
        scrub their device lanes before the tick that follows."""
        with self._call_lock:
            if self._h is None:
                return []
            n = self._lib.cdt_ingest_granted(
                self._h, self._ptr(self._ids, ctypes.c_int), self._ptr(self._gens, ctypes.c_uint),
                self._ptr(self._thrs, ctypes.c_float), self.num_streams,
            )
            return [
                (int(self._ids[i]), int(self._gens[i]),
                 None if np.isnan(self._thrs[i]) else float(self._thrs[i]))
                for i in range(n)
            ]

    def thresh_updates(self) -> List[Tuple[int, float]]:
        """(slot, threshold) THRESH retunes since the last call; apply them
        after this tick's grants (a grant and a retune in one tick resolve
        to the retune), scrubbing nothing."""
        with self._call_lock:
            if self._h is None:
                return []
            n = self._lib.cdt_ingest_thresh_updates(
                self._h, self._ptr(self._ids, ctypes.c_int),
                self._ptr(self._thrs, ctypes.c_float), self.num_streams,
            )
            return [(int(self._ids[i]), float(self._thrs[i])) for i in range(n)]

    def assemble(self, dst: np.ndarray) -> int:
        """Fill dst (num_streams, chunk) with one tick of audio, silence
        where a slot underruns; returns the open-slot count. dst is float32
        (the wire samples), int16 (quantized in C++ as serve.quantize_i16
        does) or uint8 (μ-law as serve.quantize_mulaw; silence is 128)."""
        assert dst.shape == (self.num_streams, self.chunk)
        assert dst.dtype in (np.float32, np.int16, np.uint8)
        assert dst.flags.c_contiguous
        with self._call_lock:
            if self._h is None:
                dst[:] = 128 if dst.dtype == np.uint8 else 0
                return 0
            if dst.dtype == np.int16:
                return int(self._lib.cdt_ingest_assemble_i16(self._h, self._ptr(dst, ctypes.c_short)))
            if dst.dtype == np.uint8:
                return int(self._lib.cdt_ingest_assemble_u8(self._h, self._ptr(dst, ctypes.c_ubyte)))
            return int(self._lib.cdt_ingest_assemble(self._h, self._ptr(dst, ctypes.c_float)))

    def ready(self) -> bool:
        """At least one open slot, and every open slot has a full chunk."""
        return self.readiness() == 2

    def readiness(self) -> int:
        """The eager tick's tri-state readiness: 2 = every open slot has a
        full chunk (tick now); 1 = some do and some do not (the liveness
        deadline applies); 0 = none does (do not tick)."""
        with self._call_lock:
            if self._h is None:
                return 0
            return int(self._lib.cdt_ingest_readiness(self._h))

    def send_events(self, slots: np.ndarray, gens: np.ndarray, times: np.ndarray, confs: np.ndarray) -> None:
        """Queue EVENT frames; the plane drops any whose generation is not
        the slot's current one (released or re-granted since)."""
        n = len(slots)
        if n == 0:
            return
        slots = np.ascontiguousarray(slots, np.int32)
        gens = np.ascontiguousarray(gens, np.uint32)
        times = np.ascontiguousarray(times, np.float64)
        confs = np.ascontiguousarray(confs, np.float32)
        with self._call_lock:
            if self._h is None:
                return
            self._lib.cdt_ingest_send_events(
                self._h, n, self._ptr(slots, ctypes.c_int), self._ptr(gens, ctypes.c_uint),
                self._ptr(times, ctypes.c_double), self._ptr(confs, ctypes.c_float),
            )

    def stats(self) -> dict:
        with self._call_lock:
            if self._h is None:
                return dict(self._final_stats or {
                    "connections": 0, "refused": 0, "dropped_samples": 0,
                    "events": 0, "events_dropped": 0, "open_streams": 0,
                })
            out = (ctypes.c_longlong * 6)()
            self._lib.cdt_ingest_stats(self._h, out, 6)
            return {
                "connections": int(out[0]),
                "refused": int(out[1]),
                "dropped_samples": int(out[2]),
                "events": int(out[3]),
                "events_dropped": int(out[4]),
                "open_streams": int(out[5]),
            }

    def stop(self) -> None:
        with self._call_lock:
            if self._h:
                self._final_stats = self.stats()
                self._lib.cdt_ingest_stop(self._h)
                self._h = None
