"""Wire protocol for the multi-stream detection server.

The PyTorch port's own copy of `cough_detector_tpu/serve/protocol.py`: the
wire format is unchanged, so clients of either server speak to both.
Normative spec: docs/PROTOCOL.md (frame table, byte layouts, generation
semantics, backpressure rules).

Framing: a fixed 12-byte little-endian header, then the payload.

    magic   u16  0x0CD7
    type    u8   frame type (OPEN/OPENED/AUDIO/EVENT/CLOSE/ERROR)
    flags   u8   reserved, 0
    stream  u32  stream slot id (0 for OPEN)
    length  u32  payload byte length

Payloads: AUDIO carries float32le PCM samples; EVENT carries UTF-8 JSON
{"time": seconds, "confidence": p}; ERROR carries a UTF-8 message;
OPENED / CLOSE are empty. OPEN is empty (server-default sensitivity) OR
carries exactly 4 bytes: a float32le per-stream confidence threshold —
multi-tenant serving lets each stream pick its own trigger point without
a second server (the threshold is a per-lane vector in the device tick,
stream/ring.py). Any other OPEN length is a protocol
error.
"""

from __future__ import annotations

import json
import socket
import struct
from typing import NamedTuple, Optional

import numpy as np

MAGIC = 0x0CD7
_HEADER = struct.Struct("<HBBII")
HEADER_SIZE = _HEADER.size

OPEN = 1      # client -> server: allocate a stream slot
OPENED = 2    # server -> client: slot granted (stream field = slot id)
AUDIO = 3     # client -> server: f32le PCM for the slot
EVENT = 4     # server -> client: a detection on the slot
CLOSE = 5     # client -> server: release the slot
ERROR = 6     # server -> client: refusal / protocol error (then close)
THRESH = 7    # client -> server: set the slot's confidence threshold
#               MID-STREAM (4-byte f32le payload; effective next tick;
#               scrubs nothing — ring audio, smoothing history and the
#               debounce clock survive, unlike a CLOSE+OPEN cycle)

# Bound a single frame to 16 MiB: a malformed length can't balloon memory.
MAX_PAYLOAD = 16 << 20


class Frame(NamedTuple):
    type: int
    stream: int
    payload: bytes


def encode(type_: int, stream: int = 0, payload: bytes = b"") -> bytes:
    if len(payload) > MAX_PAYLOAD:
        raise ValueError(f"payload {len(payload)} exceeds {MAX_PAYLOAD}")
    return _HEADER.pack(MAGIC, type_, 0, stream, len(payload)) + payload


def encode_audio(stream: int, samples: np.ndarray) -> bytes:
    return encode(AUDIO, stream, np.asarray(samples, np.float32).tobytes())


def encode_open(threshold: Optional[float] = None) -> bytes:
    """OPEN frame; `threshold` (optional) is this stream's own confidence
    threshold, overriding the server default for the granted slot."""
    if threshold is None:
        return encode(OPEN)
    return encode(OPEN, 0, struct.pack("<f", float(threshold)))


def decode_open_threshold(frame: Frame) -> Optional[float]:
    """The per-stream threshold carried by an OPEN frame, or None for the
    server default. Raises ValueError on a malformed payload (callers
    turn that into a protocol error)."""
    if not frame.payload:
        return None
    if len(frame.payload) != 4:
        raise ValueError(
            f"OPEN payload must be empty or 4 bytes, got {len(frame.payload)}"
        )
    (thr,) = struct.unpack("<f", frame.payload)
    if not np.isfinite(thr):
        raise ValueError("OPEN threshold must be finite")
    return float(thr)


def encode_thresh(stream: int, threshold: float) -> bytes:
    """THRESH frame: retune `stream`'s confidence threshold mid-stream."""
    return encode(THRESH, stream, struct.pack("<f", float(threshold)))


def decode_thresh(frame: Frame) -> float:
    """The threshold carried by a THRESH frame; ValueError on a malformed
    payload (callers turn that into a protocol error)."""
    if len(frame.payload) != 4:
        raise ValueError(
            f"THRESH payload must be 4 bytes, got {len(frame.payload)}"
        )
    (thr,) = struct.unpack("<f", frame.payload)
    if not np.isfinite(thr):
        raise ValueError("THRESH threshold must be finite")
    return float(thr)


def encode_event(stream: int, time_s: float, confidence: float) -> bytes:
    body = json.dumps(
        {"time": round(time_s, 6), "confidence": round(confidence, 6)}
    ).encode()
    return encode(EVENT, stream, body)


def decode_event(frame: Frame) -> dict:
    return json.loads(frame.payload.decode())


def recv_exact(sock: socket.socket, n: int) -> Optional[bytes]:
    """Read exactly n bytes, or None on orderly EOF before any byte."""
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            return None if not buf else bytes(buf)  # truncated counts too
        buf.extend(chunk)
    return bytes(buf)


def read_frame(sock: socket.socket) -> Optional[Frame]:
    """Blocking read of one frame; None on EOF. Raises on corruption."""
    head = recv_exact(sock, HEADER_SIZE)
    if head is None:
        return None
    if len(head) < HEADER_SIZE:
        raise ConnectionError("truncated frame header")
    magic, type_, _flags, stream, length = _HEADER.unpack(head)
    if magic != MAGIC:
        raise ConnectionError(f"bad magic 0x{magic:04x}")
    if length > MAX_PAYLOAD:
        raise ConnectionError(f"oversized frame ({length} bytes)")
    payload = b""
    if length:
        payload = recv_exact(sock, length)
        if payload is None or len(payload) < length:
            raise ConnectionError("truncated frame payload")
    return Frame(type_, stream, payload)
