"""Multi-client detection server over the batched streaming engine.

The port of `cough_detector_tpu/serve/server.py`. One `StreamingDetector`
with a fixed slot capacity serves every connected client: each client
OPENs one or more stream slots, sends f32 PCM, and receives EVENT frames
for detections on its slots (wire format: docs/PROTOCOL.md). All slots
advance in lockstep device ticks; absent audio is silence.

Tick policies:
  * "timer" (production): a tick every chunk duration of wall time on an
    absolute-deadline schedule, zero-filling slots without buffered audio.
  * "eager" (tests / offline drains): tick whenever every open slot has a
    full chunk buffered. Stream clocks freeze while no slot has audio, so a
    drain is deterministic. When readiness is asymmetric (one lane has a
    full chunk, another none) for `liveness_seconds`, the server ticks
    anyway and the starved lanes zero-fill, so a silent tenant never
    stalls a live one.

Isolation and containment:
  * A granted slot's device state rows are scrubbed on the tick thread
    before any of the new tenant's audio is scored; event times are
    relative to the slot's own open; events from windows that overlap
    pre-open zero padding are suppressed.
  * Per-slot audio buffers are bounded (default 30 s); overflow drops the
    oldest audio and counts it (`stats()["dropped_samples"]`).
  * Outbound frames go through bounded per-client queues drained by a
    writer thread, so a stalled client never blocks the tick loop.
  * A protocol violation gets an ERROR frame, then only that connection
    closes.

Socket tiers (`backend`): "python", this module's reader threads, or
"native", the C++ epoll plane (serve/native_ingest.py, native/cdt_ingest.cpp)
that parses frames, buffers each slot's audio and writes events with no
Python in the per-frame path; the tick thread then assembles a tick with one
call. Both speak the same wire protocol and keep the same isolation rules.

Pipeline: the tick thread only assembles and enqueues device ticks. A pool
of fetch workers copies each tick's packed event tensor to the host, and a
router thread re-serializes completions so clients see events in tick
order. `serve/stats_http.py` serves `stats()` over HTTP beside the daemon.
"""

from __future__ import annotations

import queue
import socket
import sys
import threading
import time
from collections import deque
from typing import Dict, List, Optional, Union

import numpy as np
import torch

from ..config import Config
from ..stream import ring
from ..stream.detector import StreamingDetector
from ..utils.observability import LatencyTracker
from . import protocol


class _ProtocolViolation(ConnectionError):
    """Client broke the wire contract; reply ERROR and drop it."""


def quantize_i16(x: np.ndarray) -> np.ndarray:
    """f32 audio → int16 PCM: i = clip(round(x*32768), -32768, 32767),
    rounding half away from zero; inverse of the in-tick dequantization in
    stream/ring.py (x = i/32768). NaN → 0, ±inf → full scale."""
    v = np.clip(np.nan_to_num(x * 32768.0, nan=0.0), -32768.0, 32767.0)
    return np.trunc(v + np.copysign(0.5, v)).astype(np.int16)


# μ-law companding constants (G.711-style continuous μ-law, μ=255).
_MULAW_MU = 255.0
_MULAW_INV_LN = 1.0 / np.log(256.0)


def quantize_mulaw(x: np.ndarray) -> np.ndarray:
    """f32 audio → 8-bit μ-law (μ=255): compand with
    sign(x)·ln(1+255|x|)/ln(256) over x clipped to [-1,1], then map to
    mid-tread codes round(m·127)+128 (half away from zero), so digital
    silence decodes to exactly 0. Computed in float64. NaN → code 128,
    ±inf → full scale. Inverse of the in-tick decoder in stream/ring.py."""
    v = np.clip(
        np.nan_to_num(x, nan=0.0, posinf=1.0, neginf=-1.0), -1.0, 1.0
    ).astype(np.float64)
    m = np.sign(v) * np.log1p(_MULAW_MU * np.abs(v)) * _MULAW_INV_LN
    lvl = np.trunc(m * 127.0 + np.copysign(0.5, m))
    return (lvl + 128.0).astype(np.uint8)


def dequantize_mulaw(u: np.ndarray) -> np.ndarray:
    """Host-side inverse of quantize_mulaw (f64 math, f32 result)."""
    y = (u.astype(np.float64) - 128.0) / 127.0
    x = np.sign(y) * np.expm1(np.abs(y) * np.log(256.0)) / _MULAW_MU
    return x.astype(np.float32)


def h2d_silence(shape, dtype) -> np.ndarray:
    """Digital silence in a tick format: 0 for float32/int16, code 128 for
    μ-law (whose mid-tread zero is not the 0 byte)."""
    fill = 128 if np.dtype(dtype) == np.uint8 else 0
    return np.full(shape, fill, dtype)


class _Slot:
    __slots__ = ("owner", "buffer", "buffered", "lock", "open_sample")

    def __init__(self, owner: "_Client", open_sample: int):
        self.owner = owner
        self.buffer: deque = deque()          # of np.float32 arrays
        self.buffered = 0                     # total samples queued
        self.lock = threading.Lock()
        self.open_sample = open_sample        # server stream-sample at OPEN

    def push(self, samples: np.ndarray, cap: int) -> int:
        """Queue samples; returns how many OLD samples were dropped. On
        overflow exactly (buffered - cap) samples go from the oldest end,
        even out of a single over-cap frame."""
        dropped = 0
        with self.lock:
            self.buffer.append(samples)
            self.buffered += samples.size
            need = self.buffered - cap
            while need > 0:
                head = self.buffer[0]
                take = min(need, head.size)
                if take == head.size:
                    self.buffer.popleft()
                else:
                    self.buffer[0] = head[take:]
                self.buffered -= take
                dropped += take
                need -= take
        return dropped

    def pull(self, n: int) -> np.ndarray:
        """Dequeue exactly n samples, zero-padded if underrun."""
        out = np.zeros(n, np.float32)
        got = 0
        with self.lock:
            while got < n and self.buffer:
                head = self.buffer[0]
                take = min(n - got, head.size)
                out[got : got + take] = head[:take]
                if take == head.size:
                    self.buffer.popleft()
                else:
                    self.buffer[0] = head[take:]
                self.buffered -= take
                got += take
        return out


class _Client:
    """One connection: a reader loop (server-driven) plus a writer thread
    draining a bounded outbox, so sends never block the tick loop."""

    OUTBOX_FRAMES = 1024

    def __init__(self, sock: socket.socket, addr):
        self.sock = sock
        self.addr = addr
        self.slots: List[int] = []
        self.outbox: "queue.Queue[Optional[bytes]]" = queue.Queue(
            maxsize=self.OUTBOX_FRAMES
        )
        self.writer = threading.Thread(target=self._write_loop, daemon=True)
        self.writer.start()

    def send(self, data: bytes) -> bool:
        """Enqueue a frame; False (dropped) if the client isn't draining."""
        try:
            self.outbox.put_nowait(data)
            return True
        except queue.Full:
            return False

    def close(self) -> None:
        try:
            self.outbox.put_nowait(None)  # writer exits after the sentinel
        except queue.Full:
            pass  # writer is stuck in sendall; the shutdown unblocks it
        try:
            # shutdown() wakes any thread blocked in recv/sendall on this
            # socket; close() alone leaves them stuck.
            self.sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self.sock.close()
        except OSError:
            pass

    def _write_loop(self) -> None:
        try:
            while True:
                data = self.outbox.get()
                if data is None:
                    return
                self.sock.sendall(data)
        except (ConnectionError, OSError):
            return


class DetectionServer:
    """See module docstring. Capacity (`num_streams`) is fixed at start."""

    def __init__(
        self,
        *,
        model_path: Optional[str] = None,
        variables=None,
        config: Optional[Config] = None,
        device: Union[str, torch.device] = "cuda",
        host: str = "127.0.0.1",
        port: int = 0,
        num_streams: int = 256,
        chunk_size: int = 1600,
        confidence_threshold: float = 0.5,
        smoothing_window: int = 3,
        debounce_seconds: float = 0.5,
        tick_policy: str = "timer",
        liveness_seconds: Optional[float] = None,
        buffer_seconds: float = 30.0,
        delivery_workers: int = 4,
        backend: str = "auto",
        h2d_dtype: str = "float32",
        ingest_workers: int = 1,
        precision_mode: str = "high",
        mesh=None,
    ):
        """`backend`: "python" (this module's socket tier), "native" (the
        C++ epoll plane; raises if its library cannot be built) or "auto"
        (native when the library builds, else python, said once).

        `ingest_workers` (native only): the plane's epoll I/O threads;
        connections partition across them, and events are the same at any
        count.

        `precision_mode`: the classifier's, "high" or "serve" (TF32 bulk
        convs on the card; models/layers.py).

        `mesh`: the devices the stream slots split over, as
        StreamingDetector takes it (None: every visible card when there
        are several and their count divides num_streams; False: one).

        `h2d_dtype`: the per-tick host→device batch format. "float32"
        (exact), "int16" (16-bit PCM, quantized on assemble, dequantized in
        the tick) or "mulaw" (8-bit μ-law, an approximation for links where
        even int16 saturates).

        `liveness_seconds` (eager policy only): how long one tenant may
        stall the lockstep tick before the server ticks anyway. Default
        (None) is one tick period; float("inf") disables liveness ticks."""
        if tick_policy not in ("timer", "eager"):
            raise ValueError(f"unknown tick_policy {tick_policy!r}")
        if backend not in ("python", "native", "auto"):
            raise ValueError(f"unknown backend {backend!r}")
        if backend != "python":
            from . import native_ingest

            if backend == "native":
                native_ingest.require()
            else:
                backend = "native" if native_ingest.available() else "python"
        _h2d_dtypes = {
            "float32": np.float32, "int16": np.int16, "mulaw": np.uint8,
        }
        if h2d_dtype not in _h2d_dtypes:
            raise ValueError(f"unknown h2d_dtype {h2d_dtype!r}")
        self.h2d_dtype = h2d_dtype
        self._h2d = _h2d_dtypes[h2d_dtype]
        self.backend = backend
        self._ingest_workers = max(1, int(ingest_workers))
        self._detector = StreamingDetector(
            model_path,
            variables=variables,
            config=config,
            device=device,
            num_streams=num_streams,
            chunk_size=chunk_size,
            confidence_threshold=confidence_threshold,
            smoothing_window=smoothing_window,
            debounce_seconds=debounce_seconds,
            precision_mode=precision_mode,
            mesh=mesh,
        )
        self.num_streams = num_streams
        self.chunk_size = chunk_size
        self._sample_rate = self._detector.config.features.sample_rate
        self._tick_seconds = chunk_size / self._sample_rate
        if liveness_seconds is None:
            liveness_seconds = self._tick_seconds
        if not liveness_seconds > 0:
            raise ValueError("liveness_seconds must be > 0")
        self._liveness_seconds = float(liveness_seconds)
        self._buffer_cap = max(chunk_size, int(buffer_seconds * self._sample_rate))
        self._tick_policy = tick_policy

        self._slots: Dict[int, _Slot] = {}
        self._free = list(range(num_streams - 1, -1, -1))
        self._reg_lock = threading.Lock()
        # Every accepted connection, so stop() can close them.
        self._live_clients: set = set()
        # Slots granted but not yet scrubbed, as (slot_id, threshold or
        # None); the tick thread scrubs them before pulling their audio.
        self._pending_resets: List[tuple] = []
        # Mid-stream THRESH retunes, (slot_id, threshold), applied by the
        # tick thread after any resets.
        self._pending_thresholds: List[tuple] = []
        self._stats = {
            "ticks": 0, "events": 0, "events_dropped": 0,
            "dropped_samples": 0, "connections": 0, "refused": 0,
            "tick_errors": 0, "tick_dispatch_errors": 0,
        }
        self._last_tick_error: Optional[str] = None
        # Tick cost on the tick thread, dispatch→delivered pipeline lag.
        self._tick_times = LatencyTracker(maxlen=1024)
        self._lag_times = LatencyTracker(maxlen=1024)
        self._stats_lock = threading.Lock()
        # Ticks in flight between the tick thread and the fetch pool; the
        # router re-serializes completions. Dispatch is also gated on the
        # router (_wait_dispatch_slot), which bounds _fetched.
        self._delivery_workers = max(1, delivery_workers)
        self._inflight: "queue.Queue" = queue.Queue(
            maxsize=2 * self._delivery_workers
        )
        self._fetched: Dict[int, tuple] = {}  # serial → (live, dets, t0)
        self._fetched_cond = threading.Condition()
        self._dispatched = 0  # tick serial, single-writer: tick thread
        self._routed = 0  # ticks claimed by the router, single-writer
        self._max_ahead = 3 * self._delivery_workers + 2
        self._stop = threading.Event()
        self._threads: List[threading.Thread] = []
        self._host, self._port = host, port
        self._ingest = None
        if backend == "native":
            # The C++ plane accepts and grants slots the moment it binds,
            # so it is created in start(), after the warm tick: a client
            # must not stream into a bounded buffer that nothing drains.
            self._listener = None
            self.address = None
            # slot → (generation, open_sample), the router's view for
            # retiming and generation-checked delivery.
            self._slot_meta: Dict[int, tuple] = {}
            # Rotating assembly buffers, one per tick that may sit between
            # dispatch and routing (_wait_dispatch_slot): a buffer is
            # reused only after its tick was routed, so an upload that
            # still reads it is never overwritten.
            self._assemble_bufs = [
                np.zeros((num_streams, chunk_size), self._h2d) for _ in range(self._max_ahead)
            ]
            # Grants and retunes drained from the plane stay here until
            # their device call succeeds, so a failed scrub is retried and
            # never lets a lane serve a new tenant with the old state.
            self._unscrubbed_grants: List[tuple] = []
            self._unapplied_retunes: List[tuple] = []
        else:
            self._listener = socket.create_server((host, port))
            self.address = self._listener.getsockname()

    # -- lifecycle -------------------------------------------------------

    def start(self) -> None:
        # Warm ticks of silence before accepting clients, one for every
        # fill the ring passes through until it cycles: on the card each is
        # the first tick of its key, which captures the tick's graph, and
        # the first that completes windows runs the front-end kernels and
        # the classifier at the full batch (cuDNN's algorithm choice,
        # lazily loaded kernels) for the first time, costs that must not
        # eat a client's real-time budget; the lane scrub and the retune
        # run once too. The accept loop starts (and the native plane binds)
        # after them; earlier connects wait in the python listener's
        # backlog. The reset after them empties the ring in place, so the
        # captured ticks stay valid.
        silence = h2d_silence((self.num_streams, self.chunk_size), self._h2d)
        det = self._detector
        hop = int(det.config.features.sample_rate * det.stream_config.hop_duration)
        for _ in ring.tick_fills(self.chunk_size, det.window_samples, hop):
            det.collect_events(det.tick_async(silence))
        self._detector.reset_streams([])
        self._detector.set_thresholds([], [])
        self._detector.reset()
        if self.backend == "native":
            from .native_ingest import NativeIngest

            self._ingest = NativeIngest(
                self._host, self._port, self.num_streams, self.chunk_size,
                self._buffer_cap, num_workers=self._ingest_workers,
            )
            self.address = self._ingest.address
        self._threads = ([
            threading.Thread(target=self._accept_loop, daemon=True),
        ] if self._ingest is None else []) + [
            threading.Thread(target=self._tick_loop, daemon=True),
            threading.Thread(target=self._router_loop, daemon=True),
        ] + [
            threading.Thread(target=self._fetch_loop, daemon=True)
            for _ in range(self._delivery_workers)
        ]
        for t in self._threads:
            t.start()

    def stop(self) -> None:
        self._stop.set()
        if self._listener is not None:
            try:
                # shutdown() wakes the accept loop's blocked accept();
                # close() alone leaves it blocked until the join times out.
                self._listener.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                self._listener.close()
            except OSError:
                pass
        # Close every live connection: a bare listener close leaves each
        # _client_loop blocked in recv and every remote client hung.
        with self._reg_lock:
            live = list(self._live_clients)
            self._live_clients.clear()
        for c in live:
            c.close()
        for t in self._threads:
            t.join(timeout=5.0)
        if self._ingest is not None:
            self._ingest.stop()  # closes its connections and joins its threads

    def __enter__(self):
        self.start()
        return self

    def __exit__(self, *exc):
        self.stop()

    def _bump(self, key: str, n: int = 1) -> None:
        with self._stats_lock:
            self._stats[key] += n

    def stats(self) -> dict:
        """`ticks` counts DELIVERED ticks (events fetched + routed);
        tick_graphs and tick_replays count the tick's captured CUDA graphs
        (one a key) and their replays (0 while the tick runs eagerly);
        tick_ms_* is the dispatch cost on the tick thread,
        delivery_lag_ms_* the dispatch→routed pipeline latency. On the
        native backend the socket counters (connections, refused,
        dropped_samples, events, events_dropped, open_streams) are the C++
        plane's."""
        if self._ingest is not None:
            socket_side = self._ingest.stats()
        else:
            with self._reg_lock:
                socket_side = {"open_streams": len(self._slots)}
        with self._stats_lock:
            out = {
                **self._stats,
                **socket_side,
                "backend": self.backend,
                "dispatched": self._dispatched,
                "routed": self._routed,
            }
            ticks = self._tick_times.snapshot()
            lags = self._lag_times.snapshot()
        graphed = [p for p in self._detector.tick_programs() if p.graphed]
        out["tick_graphs"] = sum(len(p.keys) for p in graphed)
        out["tick_replays"] = sum(sum(p.replays().values()) for p in graphed)
        if self._last_tick_error is not None:
            out["last_tick_error"] = self._last_tick_error
        if ticks.size:
            out["tick_ms_p50"] = round(float(np.percentile(ticks, 50)) * 1e3, 3)
            out["tick_ms_p99"] = round(float(np.percentile(ticks, 99)) * 1e3, 3)
        if lags.size:
            out["delivery_lag_ms_p50"] = round(
                float(np.percentile(lags, 50)) * 1e3, 3
            )
            out["delivery_lag_ms_p99"] = round(
                float(np.percentile(lags, 99)) * 1e3, 3
            )
        return out

    # -- network side ----------------------------------------------------

    def _accept_loop(self) -> None:
        while not self._stop.is_set():
            try:
                sock, addr = self._listener.accept()
            except OSError:
                return  # listener closed
            self._bump("connections")
            client = _Client(sock, addr)
            with self._reg_lock:
                self._live_clients.add(client)
            t = threading.Thread(
                target=self._client_loop, args=(client,), daemon=True
            )
            t.start()

    def _client_loop(self, client: _Client) -> None:
        try:
            while not self._stop.is_set():
                frame = protocol.read_frame(client.sock)
                if frame is None:
                    return
                self._handle(client, frame)
        except _ProtocolViolation as err:
            client.send(protocol.encode(protocol.ERROR, 0, str(err).encode()))
            time.sleep(0.05)  # give the writer a beat to flush the verdict
        except (ConnectionError, OSError):
            pass
        finally:
            self._release_client(client)

    def _handle(self, client: _Client, frame: protocol.Frame) -> None:
        if frame.type == protocol.OPEN:
            try:
                threshold = protocol.decode_open_threshold(frame)
            except ValueError as err:
                raise _ProtocolViolation(str(err))
            with self._reg_lock:
                if self._free:
                    slot_id = self._free.pop()
                    # open_sample is provisional: the tick thread pins it
                    # when it scrubs the slot.
                    self._slots[slot_id] = _Slot(
                        client, self._dispatched * self.chunk_size
                    )
                    client.slots.append(slot_id)
                    self._pending_resets.append((slot_id, threshold))
                else:
                    slot_id = None
            if slot_id is None:
                self._bump("refused")
                client.send(
                    protocol.encode(protocol.ERROR, 0, b"no free stream slots")
                )
            elif not client.send(protocol.encode(protocol.OPENED, slot_id)):
                # The grant could not be queued, so the client can never
                # CLOSE the slot: release it now.
                self._release_slot(client, slot_id)
                self._bump("refused")
        elif frame.type == protocol.AUDIO:
            slot = self._slots.get(frame.stream)
            if slot is None or slot.owner is not client:
                raise _ProtocolViolation(
                    f"AUDIO for unowned slot {frame.stream}"
                )
            if len(frame.payload) % 4:
                raise _ProtocolViolation(
                    f"AUDIO payload not float32-aligned "
                    f"({len(frame.payload)} bytes)"
                )
            samples = np.frombuffer(frame.payload, np.float32)
            dropped = slot.push(samples.copy(), self._buffer_cap)
            if dropped:
                self._bump("dropped_samples", dropped)
        elif frame.type == protocol.THRESH:
            slot = self._slots.get(frame.stream)
            if slot is None or slot.owner is not client:
                raise _ProtocolViolation(
                    f"THRESH for unowned slot {frame.stream}"
                )
            try:
                thr = protocol.decode_thresh(frame)
            except ValueError as err:
                raise _ProtocolViolation(str(err))
            with self._reg_lock:
                # Last writer wins per slot; bounded at num_streams entries.
                for i, (sid, _) in enumerate(self._pending_thresholds):
                    if sid == frame.stream:
                        self._pending_thresholds[i] = (frame.stream, thr)
                        break
                else:
                    self._pending_thresholds.append((frame.stream, thr))
        elif frame.type == protocol.CLOSE:
            self._release_slot(client, frame.stream)
        else:
            raise _ProtocolViolation(f"unexpected frame type {frame.type}")

    def _release_slot(self, client: _Client, slot_id: int) -> None:
        with self._reg_lock:
            slot = self._slots.get(slot_id)
            if slot is not None and slot.owner is client:
                del self._slots[slot_id]
                self._free.append(slot_id)
                if slot_id in client.slots:
                    client.slots.remove(slot_id)
                # A queued reset or retune of the departing tenant must
                # never apply to the slot's next tenant.
                self._pending_resets = [
                    (sid, t) for sid, t in self._pending_resets
                    if sid != slot_id
                ]
                self._pending_thresholds = [
                    (sid, t) for sid, t in self._pending_thresholds
                    if sid != slot_id
                ]

    def _release_client(self, client: _Client) -> None:
        for slot_id in list(client.slots):
            self._release_slot(client, slot_id)
        with self._reg_lock:
            self._live_clients.discard(client)
        client.close()

    # -- device side -----------------------------------------------------

    def _readiness(self) -> int:
        """Eager readiness: 2 = at least one open slot and every open slot
        has a full chunk (tick now); 1 = some open slot is ready while
        another is not (the liveness deadline applies); 0 = no open slot
        has a full chunk (do not tick)."""
        if self._ingest is not None:
            return self._ingest.readiness()
        with self._reg_lock:
            slots = list(self._slots.values())
        if not slots:
            return 0
        n_ready = sum(1 for s in slots if s.buffered >= self.chunk_size)
        if n_ready == 0:
            return 0
        return 2 if n_ready == len(slots) else 1

    def _tick_loop(self) -> None:
        if self._tick_policy == "eager":
            deadline = None
            while not self._stop.is_set():
                r = self._readiness()
                if r == 2:
                    self._tick_once()
                    deadline = None
                elif r == 1:
                    now = time.monotonic()
                    if deadline is None:
                        deadline = now + self._liveness_seconds
                    elif now >= deadline:
                        self._tick_once()
                        deadline = None
                    else:
                        self._stop.wait(min(0.001, deadline - now))
                else:
                    deadline = None
                    self._stop.wait(0.001)
            return
        # Timer mode: absolute deadlines, so processing time does not
        # stretch the period; more than one period late resyncs.
        next_t = time.monotonic() + self._tick_seconds
        while not self._stop.is_set():
            delay = next_t - time.monotonic()
            if delay > 0:
                if self._stop.wait(delay):
                    return
            next_t += self._tick_seconds
            if next_t < time.monotonic() - self._tick_seconds:
                next_t = time.monotonic() + self._tick_seconds
            if self._ingest is not None:
                any_open = self._ingest.stats()["open_streams"] > 0
            else:
                with self._reg_lock:
                    any_open = bool(self._slots)
            if any_open:
                self._tick_once()

    def _wait_dispatch_slot(self) -> bool:
        """Block until dispatch is fewer than _max_ahead ticks ahead of
        routing; False if the server stopped while waiting."""
        with self._fetched_cond:
            while (
                self._dispatched - self._routed >= self._max_ahead
                and not self._stop.is_set()
            ):
                self._fetched_cond.wait(timeout=0.2)
        return not self._stop.is_set()

    def _dispatch_tick(self, batch, live) -> None:
        """Time the tick's enqueue, claim the next serial, and hand the
        events to the fetch pool."""
        t0 = time.perf_counter()
        events = self._detector.tick_async(batch)
        with self._stats_lock:
            self._tick_times.record(time.perf_counter() - t0)
        serial = self._dispatched
        self._dispatched += 1
        while not self._stop.is_set():
            try:
                self._inflight.put((serial, live, events, t0), timeout=0.5)
                return
            except queue.Full:
                continue  # delivery behind: the missed cadence shows in stats

    def _tick_once(self) -> None:
        """Assemble and dispatch one tick; never fetches. Exceptions are
        contained (counted, surfaced in stats(), logged to stderr) so the
        tick thread keeps running; the serial is claimed only after a
        successful dispatch."""
        if not self._wait_dispatch_slot():
            return
        try:
            if self._ingest is not None:
                self._tick_once_native()
            else:
                self._tick_once_python()
        except Exception as err:
            with self._stats_lock:
                self._stats["tick_dispatch_errors"] += 1
                self._last_tick_error = repr(err)
            print(f"serve: tick dispatch failed: {err!r}", file=sys.stderr)

    def _tick_once_native(self) -> None:
        """The native tick: the C++ plane buffered the audio; scrub newly
        granted lanes, apply retunes, assemble with one call, dispatch.
        Drained grants and retunes are consumed only after their device
        call succeeds (the stashes, see __init__); a slot re-granted while
        its scrub is pending takes its newest tenant."""
        self._unscrubbed_grants.extend(self._ingest.granted())
        granted = list({g[0]: g for g in self._unscrubbed_grants}.values())
        if granted:
            self._detector.reset_streams(
                [sid for sid, _, _ in granted], thresholds=[thr for _, _, thr in granted]
            )
            start_sample = self._dispatched * self.chunk_size
            for sid, gen, _ in granted:
                self._slot_meta[sid] = (gen, start_sample)
            self._unscrubbed_grants = []
            # A retune left from a failed earlier tick belongs to the
            # slot's previous tenant: the fresh grant's scrub supersedes
            # it (this tick's retunes are drained below, after the purge).
            sids = {sid for sid, _, _ in granted}
            self._unapplied_retunes = [r for r in self._unapplied_retunes if r[0] not in sids]
        self._unapplied_retunes.extend(self._ingest.thresh_updates())
        retunes = self._unapplied_retunes
        if retunes:
            self._detector.set_thresholds([sid for sid, _ in retunes], [thr for _, thr in retunes])
            self._unapplied_retunes = []
        buf = self._assemble_bufs[self._dispatched % len(self._assemble_bufs)]
        self._ingest.assemble(buf)
        # A snapshot: the router retimes against the metadata of the tick.
        self._dispatch_tick(buf, dict(self._slot_meta))

    def _tick_once_python(self) -> None:
        chunk = np.zeros((self.num_streams, self.chunk_size), np.float32)
        with self._reg_lock:
            live = dict(self._slots)
            resets = self._pending_resets
            self._pending_resets = []
            retunes = self._pending_thresholds
            self._pending_thresholds = []
        # Scrub reused slots BEFORE pulling their audio: their rows still
        # hold the previous tenant's ring/history/debounce state.
        try:
            if resets:
                self._detector.reset_streams(
                    [sid for sid, _ in resets],
                    thresholds=[thr for _, thr in resets],
                )
                start_sample = self._dispatched * self.chunk_size
                for sid, _ in resets:
                    slot = live.get(sid)
                    if slot is not None:
                        slot.open_sample = start_sample
                resets = []  # applied: a failure below must not requeue
            if retunes:
                # After resets: a grant and a THRESH in the same tick
                # resolve to the retune.
                self._detector.set_thresholds(
                    [sid for sid, _ in retunes],
                    [thr for _, thr in retunes],
                )
                retunes = []
        except Exception:
            # Requeue what was not applied, ahead of anything readers
            # appended meanwhile; entries a newer item supersedes drop.
            with self._reg_lock:
                newer_r = {sid for sid, _ in self._pending_resets}
                self._pending_resets = [
                    r for r in resets if r[0] not in newer_r
                ] + self._pending_resets
                newer_t = {sid for sid, _ in self._pending_thresholds}
                self._pending_thresholds = [
                    r for r in retunes if r[0] not in newer_t
                ] + self._pending_thresholds
            raise
        pulled = 0
        for slot_id, slot in live.items():
            pulled += min(slot.buffered, self.chunk_size)
            chunk[slot_id] = slot.pull(self.chunk_size)
        if self._h2d is np.int16:
            chunk = quantize_i16(chunk)
        elif self._h2d is np.uint8:
            chunk = quantize_mulaw(chunk)
        try:
            self._dispatch_tick(chunk, live)
        except Exception:
            # The pull consumed the audio; a failed dispatch discards it.
            if pulled:
                self._bump("dropped_samples", pulled)
            raise

    def _fetch_loop(self) -> None:
        """Copy one tick's events to the host. A failed fetch still posts
        its serial (with no detections), or the in-order router would wait
        on it forever."""
        while not self._stop.is_set():
            try:
                serial, live, events, t0 = self._inflight.get(timeout=0.2)
            except queue.Empty:
                continue
            try:
                detections = self._detector.collect_events(events)
            except Exception as err:
                detections = []
                self._bump("tick_errors")
                print(
                    f"serve: tick {serial} event fetch failed: {err!r}",
                    file=sys.stderr,
                )
            with self._fetched_cond:
                self._fetched[serial] = (live, detections, t0)
                self._fetched_cond.notify_all()

    def _router_loop(self) -> None:
        """Route fetched ticks to clients strictly in tick order."""
        next_serial = 0
        while not self._stop.is_set():
            with self._fetched_cond:
                while (
                    next_serial not in self._fetched
                    and not self._stop.is_set()
                ):
                    self._fetched_cond.wait(timeout=0.2)
                if self._stop.is_set():
                    return
                live, detections, t_dispatch = self._fetched.pop(next_serial)
                self._routed = next_serial + 1
                self._fetched_cond.notify_all()
            try:
                self._deliver(live, detections)
            except Exception as err:  # never wedge in-order delivery
                self._bump("tick_errors")
                print(
                    f"serve: tick {next_serial} delivery failed: {err!r}",
                    file=sys.stderr,
                )
            with self._stats_lock:
                self._lag_times.record(time.perf_counter() - t_dispatch)
                self._stats["ticks"] += 1
            next_serial += 1

    def _deliver(self, live, detections) -> None:
        if self._ingest is not None:
            self._deliver_native(live, detections)
            return
        window_s = self._detector.stream_config.window_duration
        for det in detections:
            slot = live.get(det.stream)
            if slot is None:
                continue  # slot released mid-tick; stale event
            # Time relative to the slot's own open (exact sample counts).
            t_rel = det.time_seconds - slot.open_sample / self._sample_rate
            # Windows that overlap pre-open zero padding scored silence,
            # not the tenant's signal: suppress them.
            if t_rel < window_s - 1e-9:
                continue
            if slot.owner.send(
                protocol.encode_event(det.stream, t_rel, det.confidence)
            ):
                self._bump("events")
            else:
                self._bump("events_dropped")

    def _deliver_native(self, live, detections) -> None:
        """Route one tick's detections through the C++ plane: retime each
        against its slot's open sample (as of the tick), suppress pre-open
        padding windows, and send the batch; the plane checks each event's
        generation, so a slot released or re-granted meanwhile never gets
        another tenant's event."""
        window_s = self._detector.stream_config.window_duration
        slots, gens, times, confs = [], [], [], []
        for det in detections:
            meta = live.get(det.stream)
            if meta is None:
                continue
            gen, open_sample = meta
            t_rel = det.time_seconds - open_sample / self._sample_rate
            if t_rel < window_s - 1e-9:
                continue
            slots.append(det.stream)
            gens.append(gen)
            times.append(round(t_rel, 6))
            confs.append(det.confidence)
        self._ingest.send_events(
            np.asarray(slots, np.int32), np.asarray(gens, np.uint32),
            np.asarray(times, np.float64), np.asarray(confs, np.float32),
        )
