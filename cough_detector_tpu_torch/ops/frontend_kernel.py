"""Fused front end: raw waveform batch → stacked feature image, in one
hand-written CUDA kernel pair (csrc/frontend_kernel.cu).

The port of `cough_detector_tpu/ops/pallas/frontend_kernel.py`. It covers
every in-kernel branch of the Pallas kernel: the dB and PCEN mel branches,
MFCCs with deltas and optional delta-deltas, and pre-emphasis.

`extract_features_fused` runs the pair through its two wrappers:
`power_mel_fused` (launch A: framing, windowed DFT, power, mel) and
`mel_epilogue_fused` (launch B: log, dB or PCEN, DCT, z-norm, deltas). On
a CUDA tensor each launches its kernel or raises, and adds one to its
counter, `SPECTRAL_LAUNCHES` or `EPILOGUE_LAUNCHES`; on a CPU tensor each
runs its plain version (`power_mel_reference`, `mel_epilogue_reference`):
the same arithmetic in plain torch ops, with the band-limited windowed DFT
as two FP32 matmuls and the shared epilogue of ops/frontend.py.
`frontend_kernel_reference` chains the two plain versions.

Unlike the JAX launcher, a config the kernel does not cover (no MFCC, or a
waveform length other than segment_samples) raises ValueError instead of
running the plain chain, and spectral contrast raises NotImplementedError
until the contrast slice is ported. `kernel_supports` is the predicate
callers route on (ops/frontend.py::extract_features_fast).
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from ..config import FeatureConfig
from . import filters
from .frontend import no_contrast, pre_emphasis, stack_features

# Launches of each kernel since import (or since a caller last set it to 0).
SPECTRAL_LAUNCHES = 0
EPILOGUE_LAUNCHES = 0

_MAX_SMEM = 232448  # bytes of shared memory one block may use on sm_90
_MAX_GRID_Y = 65535


def kernel_supports(cfg: FeatureConfig, n_samples: int) -> bool:
    """Whether the fused kernel computes this config at this length."""
    return (
        cfg.use_mfcc
        and not cfg.use_spectral_contrast
        and n_samples == cfg.segment_samples
    )


def _check_config(cfg: FeatureConfig, n_samples: int) -> None:
    no_contrast(cfg)
    if not kernel_supports(cfg, n_samples):
        raise ValueError(
            f"the fused front-end kernel needs use_mfcc=True and waveforms of "
            f"segment_samples={cfg.segment_samples}; got use_mfcc="
            f"{cfg.use_mfcc} and length {n_samples} "
            f"(ops.frontend.extract_features covers every config)"
        )


class _Constants(NamedTuple):
    cos: torch.Tensor  # (n_fft, n_used) windowed cos
    sin: torch.Tensor  # (n_fft, n_used) windowed -sin
    fb: torch.Tensor   # (n_used, n_mels)
    dct: torch.Tensor  # (n_mels, n_mfcc)
    n_used: int        # DFT bins that feed any mel band
    j0: int            # window support [j0, j1) within the frame
    j1: int


@functools.lru_cache(maxsize=16)
def _constants(cfg: FeatureConfig, device: torch.device) -> _Constants:
    """Band-limited tables: bins past the filterbank's last nonzero row feed
    no mel band, so the DFT stops there (128 of 257 bins at f_max=4 kHz).
    No rounding up: the kernel has no lane width to fill."""
    c, s = filters.dft_matrices(cfg.n_fft, cfg.win_length)
    fb = filters.mel_filterbank(
        cfg.n_fft // 2 + 1, cfg.n_mels, cfg.sample_rate, cfg.f_min, cfg.f_max
    )
    n_used = int(np.max(np.nonzero(np.any(fb != 0, axis=1))[0])) + 1
    support = np.nonzero(np.any(c != 0, axis=1))[0]
    dct = filters.dct_matrix(cfg.n_mfcc, cfg.n_mels)

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(device)

    return _Constants(
        dev(c[:, :n_used]), dev(s[:, :n_used]), dev(fb[:n_used]), dev(dct),
        n_used, int(support[0]), int(support[-1]) + 1,
    )


def _check_mel(cfg: FeatureConfig, mel: torch.Tensor) -> None:
    no_contrast(cfg)
    want = (cfg.n_mels, cfg.num_frames)
    if not cfg.use_mfcc or mel.ndim != 3 or tuple(mel.shape[1:]) != want:
        raise ValueError(
            f"the fused epilogue needs use_mfcc=True and a (B, n_mels, "
            f"num_frames) = (B, {want[0]}, {want[1]}) power mel; got use_mfcc="
            f"{cfg.use_mfcc} and shape {tuple(mel.shape)}"
        )


def power_mel_reference(
    waves: torch.Tensor, cfg: FeatureConfig = FeatureConfig()
) -> torch.Tensor:
    """Launch A's arithmetic in plain torch ops: (B, segment_samples) →
    power mel (B, n_mels, num_frames)."""
    _check_config(cfg, waves.shape[-1])
    k = _constants(cfg, waves.device)
    if cfg.use_pre_emphasis:
        waves = pre_emphasis(waves, cfg.pre_emphasis_coef)
    half = cfg.n_fft // 2
    frames = F.pad(waves, (half, half), mode="reflect").unfold(
        -1, cfg.n_fft, cfg.hop_length
    )
    re = frames @ k.cos
    im = frames @ k.sin
    return ((re * re + im * im) @ k.fb).transpose(1, 2)


def mel_epilogue_reference(
    mel: torch.Tensor, cfg: FeatureConfig = FeatureConfig()
) -> torch.Tensor:
    """Launch B's arithmetic in plain torch ops: power mel
    (B, n_mels, num_frames) → (B, num_features, num_frames)."""
    _check_mel(cfg, mel)
    return stack_features(mel.transpose(1, 2), cfg)


def frontend_kernel_reference(
    waves: torch.Tensor, cfg: FeatureConfig = FeatureConfig()
) -> torch.Tensor:
    """The kernel pair's arithmetic in plain torch ops: (B, segment_samples)
    → (B, num_features, num_frames)."""
    return mel_epilogue_reference(power_mel_reference(waves, cfg), cfg)


@functools.lru_cache(maxsize=1)
def build() -> ctypes.CDLL:
    """The kernel library, built and loaded on first call, with its C
    signatures declared."""
    from ..utils import kernel_build

    lib = kernel_build.load("frontend_kernel")
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.cdt_frontend_spectral.argtypes = [
        p, i, i, i, i, i, i, i, p, p, i, p, i, i, f, p, p,
    ]
    lib.cdt_frontend_spectral.restype = i
    lib.cdt_frontend_epilogue.argtypes = [p, i, i, i, p, i, i, i, i, p, p]
    lib.cdt_frontend_epilogue.restype = i
    lib.cdt_frontend_smem_a.argtypes = [i, i, i]
    lib.cdt_frontend_smem_a.restype = ctypes.c_size_t
    lib.cdt_frontend_smem_b.argtypes = [i, i, i]
    lib.cdt_frontend_smem_b.restype = ctypes.c_size_t
    lib.cdt_error_string.argtypes = [i]
    lib.cdt_error_string.restype = ctypes.c_char_p
    return lib


def _check_cuda(x: torch.Tensor, ndim: int, name: str) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if x.dtype != torch.float32 or x.ndim != ndim:
        raise ValueError(
            f"expected a {ndim}-d float32 tensor for {name}, got "
            f"{tuple(x.shape)} {x.dtype}"
        )
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_smem(smem: int, cfg: FeatureConfig) -> None:
    if smem > _MAX_SMEM:
        raise ValueError(
            f"config needs {smem} bytes of shared memory per block, "
            f"more than the card's {_MAX_SMEM}: {cfg}"
        )


def _raise_on(err: int, lib: ctypes.CDLL, kernel: str) -> None:
    if err:
        raise RuntimeError(
            f"frontend {kernel} kernel launch failed: "
            f"{lib.cdt_error_string(err).decode()} (cudaError {err})"
        )


def power_mel_fused(
    waves: torch.Tensor, cfg: FeatureConfig = FeatureConfig()
) -> torch.Tensor:
    """Launch A: (B, segment_samples) float32 → power mel
    (B, n_mels, num_frames). CUDA tensors launch the kernel on the current
    stream (no synchronise); CPU tensors run power_mel_reference."""
    global SPECTRAL_LAUNCHES
    _check_config(cfg, waves.shape[-1])
    if waves.device.type == "cpu":
        return power_mel_reference(waves, cfg)
    _check_cuda(waves, 2, "waves")
    b = waves.shape[0]
    if b > _MAX_GRID_Y:
        raise ValueError(f"batch {b} exceeds the kernel's {_MAX_GRID_Y} clips")
    t, n_mels = cfg.num_frames, cfg.n_mels
    mel = torch.empty((b, n_mels, t), dtype=torch.float32, device=waves.device)
    if b == 0:
        return mel
    lib = build()
    k = _constants(cfg, waves.device)
    _check_smem(lib.cdt_frontend_smem_a(cfg.n_fft, cfg.hop_length, k.n_used), cfg)
    with torch.cuda.device(waves.device):
        err = lib.cdt_frontend_spectral(
            waves.data_ptr(), b, waves.shape[1], t, cfg.n_fft,
            cfg.hop_length, k.j0, k.j1, k.cos.data_ptr(), k.sin.data_ptr(),
            k.n_used, k.fb.data_ptr(), n_mels, int(cfg.use_pre_emphasis),
            float(cfg.pre_emphasis_coef), mel.data_ptr(),
            torch.cuda.current_stream().cuda_stream,
        )
    _raise_on(err, lib, "spectral")
    SPECTRAL_LAUNCHES += 1
    return mel


def mel_epilogue_fused(
    mel: torch.Tensor, cfg: FeatureConfig = FeatureConfig()
) -> torch.Tensor:
    """Launch B: power mel (B, n_mels, num_frames) float32 →
    (B, num_features, num_frames). CUDA tensors launch the kernel on the
    current stream (no synchronise); CPU tensors run
    mel_epilogue_reference."""
    global EPILOGUE_LAUNCHES
    _check_mel(cfg, mel)
    if mel.device.type == "cpu":
        return mel_epilogue_reference(mel, cfg)
    _check_cuda(mel, 3, "mel")
    b, t = mel.shape[0], cfg.num_frames
    out = torch.empty((b, cfg.num_features, t), dtype=torch.float32, device=mel.device)
    if b == 0:
        return out
    lib = build()
    dct = _constants(cfg, mel.device).dct
    _check_smem(lib.cdt_frontend_smem_b(t, cfg.n_mels, cfg.n_mfcc), cfg)
    with torch.cuda.device(mel.device):
        err = lib.cdt_frontend_epilogue(
            mel.data_ptr(), b, t, cfg.n_mels, dct.data_ptr(), cfg.n_mfcc,
            int(cfg.use_pcen), int(cfg.use_delta_delta), cfg.num_features,
            out.data_ptr(), torch.cuda.current_stream().cuda_stream,
        )
    _raise_on(err, lib, "epilogue")
    EPILOGUE_LAUNCHES += 1
    return out


def extract_features_fused(
    waves: torch.Tensor, cfg: FeatureConfig = FeatureConfig()
) -> torch.Tensor:
    """(B, segment_samples) float32 → (B, num_features, num_frames), through
    both launches on CUDA tensors and both plain versions on CPU tensors.
    The power mel between them is dropped on return: the caching allocator
    hands its memory out again only to work queued after launch B."""
    return mel_epilogue_fused(power_mel_fused(waves, cfg), cfg)
