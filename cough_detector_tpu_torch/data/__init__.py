"""Data layer: audio I/O, datasets and loaders, shards, acquisition,
synthesis."""

from . import acquire, audio_io, synth
from .datasets import (
    BatchLoader,
    ClipDataset,
    CombinedDataset,
    CoughDataset,
    ESC50Dataset,
    create_data_loaders,
    prepare_dataset_split,
)
from .shards import (
    INT16_SCALE,
    ShardLoader,
    dequantize,
    dequantize_torch,
    pack_arrays,
    quantize,
    write_shards,
)

__all__ = [
    "acquire",
    "audio_io",
    "synth",
    "BatchLoader",
    "ClipDataset",
    "CombinedDataset",
    "CoughDataset",
    "ESC50Dataset",
    "create_data_loaders",
    "prepare_dataset_split",
    "INT16_SCALE",
    "ShardLoader",
    "dequantize",
    "dequantize_torch",
    "pack_arrays",
    "quantize",
    "write_shards",
]
