"""The run's surroundings: cache directories, the card, forbidden modules."""

from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path
from typing import List, Optional

ROOT = Path(__file__).resolve().parents[2]

# Top-level module names no process of the benchmark may hold: the JAX
# stack and the JAX package the port was made from. Compared whole, since
# the port's own name starts with the JAX package's.
FORBIDDEN = ("jax", "jaxlib", "flax", "cough_detector_tpu")


def pin_caches(root: Path = ROOT) -> None:
    """Every compiler cache at a fixed path inside the checkout, set before
    torch loads. The port's kernel library builds into build/kernels of
    the checkout by itself."""
    build = root / "build"
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "cuda_cache")):
        os.environ[var] = str(build / sub)
    if str(root) not in sys.path:
        sys.path.insert(0, str(root))


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is a forbidden one."""
    return sorted({m for m in list(sys.modules) if m.split(".", 1)[0] in FORBIDDEN})


def power_limit() -> Optional[str]:
    """The card's name and power limit as nvidia-smi reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=20,
        )
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout.strip() else None
