"""Device selection shared by the port's entry points."""

from __future__ import annotations

from typing import Union

import torch


def resolve_device(device: Union[str, torch.device]) -> torch.device:
    """`device` as a torch.device; raises if it names CUDA and no card is
    visible. The entry points default to "cuda" and never move to the CPU
    on their own: a caller that wants the CPU passes device="cpu"."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU"
        )
    return dev
