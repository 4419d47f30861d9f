"""Client for the detection server (serve/server.py).

The PyTorch port's own copy of `cough_detector_tpu/serve/client.py`; it
speaks to the servers of both packages.

Opens stream slots over one socket, sends PCM, and collects detection
events on a reader thread:

    with DetectionClient(host, port) as c:
        sid = c.open_stream()
        c.send_audio(sid, samples)         # float32 PCM at the model rate
        for ev in c.events(timeout=1.0):   # {"stream", "time", "confidence"}
            ...
"""

from __future__ import annotations

import queue
import socket
import threading
from typing import List

import numpy as np

from . import protocol


class ServerRefused(RuntimeError):
    """The server sent an ERROR frame (e.g. no free stream slots)."""


class DetectionClient:
    def __init__(self, host: str, port: int, timeout: float = 10.0):
        self._sock = socket.create_connection((host, port), timeout=timeout)
        # The connect timeout must NOT persist as the recv timeout: events
        # are legitimately rare (idle mics), and a timed-out recv would
        # kill the reader thread silently.
        self._sock.settimeout(None)
        self._events: "queue.Queue[dict]" = queue.Queue()
        self._opened: "queue.Queue[tuple]" = queue.Queue()
        self._pending_opens = 0
        self._pending_lock = threading.Lock()
        # One frame at a time on the wire: sendall of a large AUDIO frame
        # can split across syscalls, and the reader thread also sends
        # (releasing stale grants) — unserialized, its CLOSE bytes could
        # interleave INSIDE the audio payload and corrupt the framing.
        self._send_lock = threading.Lock()
        self.server_errors: list = []  # ERROR frames outside a handshake
        self._closed = threading.Event()
        self._reader = threading.Thread(target=self._read_loop, daemon=True)
        self._reader.start()

    # -- lifecycle -------------------------------------------------------

    def close(self) -> None:
        self._closed.set()
        try:
            # shutdown() before close(): close() alone cannot send FIN (or
            # wake our reader) while the reader thread is blocked in recv —
            # the kernel holds the fd until that recv returns.
            self._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self._sock.close()
        except OSError:
            pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # -- API -------------------------------------------------------------

    def open_stream(
        self, timeout: float = 10.0, threshold: float = None
    ) -> int:
        """Allocate a stream slot. `threshold` (optional) sets THIS
        stream's confidence threshold — multi-tenant sensitivity without
        a separate server; None uses the server's default.

        Replies carry no correlation id on the wire, so concurrent
        open_stream calls from multiple threads may receive each other's
        grants; call it from one thread at a time."""
        with self._pending_lock:
            self._pending_opens += 1
        try:
            self._sendall(protocol.encode_open(threshold))
            kind, value = self._opened.get(timeout=timeout)
        except Exception:
            # The handshake died (send failed or reply never came): retire
            # its pending-open claim so a later out-of-band ERROR frame
            # isn't mis-consumed as the refusal of a handshake that no
            # longer exists, poisoning the next open_stream().
            with self._pending_lock:
                still_pending = self._pending_opens > 0
                if still_pending:
                    self._pending_opens -= 1
            if still_pending:
                raise
            # The claim is gone but we saw no reply: the reader consumed
            # it at the timeout boundary. It decrements and queues the
            # reply ATOMICALLY under _pending_lock, so the reply is
            # already in the queue — take it instead of orphaning it
            # (a stale queued grant would off-by-one-bind every later
            # open_stream, swapping slot ids across tenants).
            try:
                kind, value = self._opened.get_nowait()
            except queue.Empty:
                raise
        if kind == "error":
            raise ServerRefused(value)
        return value

    def _sendall(self, data: bytes) -> None:
        with self._send_lock:
            self._sock.sendall(data)

    def close_stream(self, stream: int) -> None:
        self._sendall(protocol.encode(protocol.CLOSE, stream))

    def set_threshold(self, stream: int, threshold: float) -> None:
        """Retune this stream's confidence threshold MID-STREAM (takes
        effect on the next server tick; audio, smoothing history and the
        debounce clock are untouched — unlike closing and reopening)."""
        self._sendall(protocol.encode_thresh(stream, threshold))

    def send_audio(self, stream: int, samples: np.ndarray) -> None:
        self._sendall(protocol.encode_audio(stream, samples))

    def events(self, timeout: float = 0.0) -> List[dict]:
        """Drain queued events; with timeout > 0, wait up to that long for
        the first one."""
        out: List[dict] = []
        try:
            out.append(self._events.get(timeout=timeout or None)
                       if timeout else self._events.get_nowait())
        except queue.Empty:
            return out
        while True:
            try:
                out.append(self._events.get_nowait())
            except queue.Empty:
                return out

    # -- reader ----------------------------------------------------------

    def _read_loop(self) -> None:
        try:
            while not self._closed.is_set():
                frame = protocol.read_frame(self._sock)
                if frame is None:
                    return
                if frame.type == protocol.OPENED:
                    with self._pending_lock:
                        # >0 guard: a reply landing after its open_stream()
                        # timed out (which already retired the claim) must
                        # not drive the counter negative. Decrement and
                        # enqueue ATOMICALLY: open_stream's timeout path
                        # relies on "claim consumed => reply queued" to
                        # recover a reply that lands at the deadline.
                        claimed = self._pending_opens > 0
                        if claimed:
                            self._pending_opens -= 1
                            self._opened.put(("ok", frame.stream))
                    if not claimed:
                        # A STALE grant (its open_stream already timed
                        # out): queuing it would mis-bind every later
                        # open_stream by one — slot ids and per-stream
                        # thresholds silently swapped across tenants.
                        # Release the orphan server-side instead.
                        try:
                            self.close_stream(frame.stream)
                        except OSError:
                            pass
                elif frame.type == protocol.ERROR:
                    # Only a pending open_stream() may consume an ERROR as
                    # its refusal; out-of-band errors (protocol verdicts)
                    # must not poison a later handshake.
                    with self._pending_lock:
                        pending = self._pending_opens
                        if pending > 0:
                            self._pending_opens -= 1
                            self._opened.put(
                                ("error", frame.payload.decode())
                            )
                    if pending <= 0:
                        self.server_errors.append(frame.payload.decode())
                elif frame.type == protocol.EVENT:
                    ev = protocol.decode_event(frame)
                    ev["stream"] = frame.stream
                    self._events.put(ev)
        except (ConnectionError, OSError):
            pass
