"""Streaming detection: the ring-buffer tick and the batched detector."""

from .detector import Detection, StreamingDetector
from .ring import StreamState, init_state, make_stream_step, stream_step

__all__ = [
    "Detection",
    "StreamState",
    "StreamingDetector",
    "init_state",
    "make_stream_step",
    "stream_step",
]
