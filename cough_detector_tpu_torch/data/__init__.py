"""Training data: the shard corpus reader and the synthetic generators."""

from .shards import (
    INT16_SCALE,
    ShardLoader,
    dequantize,
    dequantize_torch,
    pack_arrays,
    quantize,
)

__all__ = [
    "INT16_SCALE",
    "ShardLoader",
    "dequantize",
    "dequantize_torch",
    "pack_arrays",
    "quantize",
]
