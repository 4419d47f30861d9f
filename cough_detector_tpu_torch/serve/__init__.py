"""Multi-client serving over the batched streaming engine."""

from .client import DetectionClient, ServerRefused
from .server import (
    DetectionServer,
    dequantize_mulaw,
    quantize_i16,
    quantize_mulaw,
)

__all__ = [
    "DetectionClient",
    "DetectionServer",
    "ServerRefused",
    "dequantize_mulaw",
    "quantize_i16",
    "quantize_mulaw",
]
