"""Multi-client serving over the batched streaming engine."""

from .client import DetectionClient, ServerRefused
from .server import (
    DetectionServer,
    dequantize_mulaw,
    quantize_i16,
    quantize_mulaw,
)
from .stats_http import StatsHttpServer

__all__ = [
    "DetectionClient",
    "DetectionServer",
    "ServerRefused",
    "StatsHttpServer",
    "dequantize_mulaw",
    "quantize_i16",
    "quantize_mulaw",
]
