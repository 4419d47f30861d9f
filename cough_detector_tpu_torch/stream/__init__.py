"""Streaming detection: the ring-buffer tick, the batched detector, the
reference-API facade, offline scoring and microphone capture."""

from .detector import CoughDetectorInference, Detection, MeshDetector, StreamingDetector
from .mic import RealtimeMicrophoneDetector, list_audio_devices
from .offline import OfflineDetection, score_recording
from .ring import StreamState, init_state, make_stream_step, stream_step

__all__ = [
    "CoughDetectorInference",
    "Detection",
    "MeshDetector",
    "OfflineDetection",
    "RealtimeMicrophoneDetector",
    "StreamState",
    "StreamingDetector",
    "init_state",
    "list_audio_devices",
    "make_stream_step",
    "score_recording",
    "stream_step",
]
