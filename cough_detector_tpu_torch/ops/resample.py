"""Polyphase windowed-sinc resampling in torch.

The port of `cough_detector_tpu/ops/resample.py`. The kernel bank is built
once per reduced (orig, new) rate pair on the host in float64, as the JAX
package builds it (torchaudio "sinc_interp_hann": lowpass_filter_width 6,
rolloff 0.99, Hann^2 window), so both banks are bit-equal. The application
is a strided `F.conv1d`: stride `orig`, the bank as a (new, 1, K) weight,
then the (B, new, frames) → (B, frames·new) interleave.

The convolution runs with cuDNN's TF32 off: torch leaves it on by default,
and a resample may run before any model has been placed on the card (which
turns TF32 off for the models, `models.no_tf32`).
"""

from __future__ import annotations

import contextlib
import functools
import math

import numpy as np
import torch
import torch.nn.functional as F

_LOWPASS_FILTER_WIDTH = 6
_ROLLOFF = 0.99


@functools.lru_cache(maxsize=32)
def _sinc_kernel(orig_freq: int, new_freq: int):
    """(kernels, width): polyphase bank shaped (new_freq, 1, K), numpy f32."""
    assert orig_freq > 0 and new_freq > 0
    base_freq = min(orig_freq, new_freq) * _ROLLOFF
    width = math.ceil(_LOWPASS_FILTER_WIDTH * orig_freq / base_freq)

    idx = np.arange(-width, width + orig_freq, dtype=np.float64)[None, :] / orig_freq
    t = np.arange(0, -new_freq, -1, dtype=np.float64)[:, None] / new_freq + idx
    t *= base_freq
    t = np.clip(t, -_LOWPASS_FILTER_WIDTH, _LOWPASS_FILTER_WIDTH)

    window = np.cos(t * np.pi / _LOWPASS_FILTER_WIDTH / 2) ** 2
    t *= np.pi
    kernel = np.where(t == 0, 1.0, np.sin(t) / np.where(t == 0, 1.0, t))
    kernel *= window * (base_freq / orig_freq)
    return kernel[:, None, :].astype(np.float32), width


@functools.lru_cache(maxsize=32)
def _bank(orig: int, new: int, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(_sinc_kernel(orig, new)[0]).to(device)


@contextlib.contextmanager
def _fp32_conv(device: torch.device):
    """cuDNN's TF32 off on the card for the duration, restored after."""
    if device.type != "cuda":
        yield
        return
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = prev


def resample(waveform: torch.Tensor, orig_sr: int, new_sr: int) -> torch.Tensor:
    """Resample (B, S) waveforms from orig_sr to new_sr.

    Output length is ceil(new · S / orig) after gcd reduction, as the
    torchaudio resampler the reference relies on gives it."""
    if orig_sr == new_sr:
        return waveform
    gcd = math.gcd(int(orig_sr), int(new_sr))
    orig, new = int(orig_sr) // gcd, int(new_sr) // gcd

    width = _sinc_kernel(orig, new)[1]
    length = waveform.shape[-1]
    target_length = -(-new * length // orig)  # ceil

    x = F.pad(waveform, (width, width + orig))[:, None, :]
    with _fp32_conv(waveform.device):
        out = F.conv1d(x, _bank(orig, new, waveform.device), stride=orig)  # (B, new, frames)
    out = out.transpose(1, 2).reshape(waveform.shape[0], -1)
    return out[:, :target_length]


@functools.lru_cache(maxsize=32)
def make_resample_fn(orig_sr: int, new_sr: int):
    """The resampler for one fixed rate pair, one per pair for the process
    (the reference's per-rate resampler cache, src/preprocessing.py:144-153)."""
    return functools.partial(resample, orig_sr=orig_sr, new_sr=new_sr)
