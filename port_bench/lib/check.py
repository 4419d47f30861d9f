"""The comparison that decides `correct`, and the precision it runs in.

The reference (port_bench/reference) runs in float64. The control is the
same reference in the precision just below the one every configuration
states (float32 with TF32 off): float32 with TF32 on for cuBLAS and cuDNN.
A number is a widest gap relative to the reference's largest magnitude
(the repository's max-relative measure) or an exact count; a run is
correct when every number the cell's limits name is at or under its limit.
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, Iterator, List, Tuple

import torch

REFERENCE_DTYPE = torch.float64
CONTROL_DTYPE = torch.float32


@contextlib.contextmanager
def tf32(on: bool) -> Iterator[None]:
    """cuBLAS's and cuDNN's TF32 switches set for the block, restored after."""
    prev = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev


class Gap:
    """A running widest gap |x - ref| over the largest |ref|, fed in parts."""

    def __init__(self):
        self.gap = 0.0
        self.scale = 0.0

    def add(self, x: torch.Tensor, ref: torch.Tensor) -> None:
        x, ref = x.double(), ref.to(x.device).double()
        d = (x - ref).abs().max()
        self.gap = max(self.gap, float(d) if torch.isfinite(d) else math.inf)
        self.scale = max(self.scale, float(ref.abs().max()))

    @property
    def value(self) -> float:
        return self.gap / self.scale if self.scale > 0 else self.gap


def judge(numbers: Dict[str, float], limits: Dict[str, float]) -> Tuple[bool, List[Tuple[str, float, float]]]:
    """(correct, [(name, number, limit)]): every limited number present,
    finite and at or under its limit."""
    rows = [(k, numbers.get(k, math.nan), float(v)) for k, v in limits.items()]
    ok = all(math.isfinite(n) and n <= lim for _, n, lim in rows)
    return ok, rows
