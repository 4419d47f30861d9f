"""Host-side audio I/O and decode, the port's copy.

A copy of `cough_detector_tpu/data/audio_io.py` (numpy only), kept here
because the port imports nothing of the JAX package. Decode is I/O, not
compute (SURVEY.md §2.8). WAV goes through a self-contained numpy reader/writer
(PCM 8/16/24/32 and float32/64); compressed formats (.webm/.ogg/.mp3/.flac)
shell out to ffmpeg exactly like the reference's COUGHVID ingest
(reference: setup_coughvid.py:242-253) when an ffmpeg binary exists, and
fail LOUDLY otherwise — never silently returning zeros, per the reference's
own postmortem rule (reference: src/dataset.py:140-148,
IMPROVEMENT_PLAN.md:13-29).

Host-side resampling reuses the polyphase kernel bank of the port's
device resampler (ops/resample.py, bit-equal to the JAX package's), so
loader-side and device-side paths compute the same filter.
"""

from __future__ import annotations

import shutil
import struct
import subprocess
from pathlib import Path
from typing import Optional, Tuple, Union

import numpy as np

from ..ops.resample import _sinc_kernel

PathLike = Union[str, Path]

AUDIO_EXTENSIONS = {".wav", ".mp3", ".flac", ".ogg", ".webm"}


class AudioDecodeError(RuntimeError):
    pass


# ---------------------------------------------------------------------------
# WAV
# ---------------------------------------------------------------------------


def read_wav(path: PathLike) -> Tuple[np.ndarray, int]:
    """RIFF/WAVE → ((channels, samples) float32 in [-1, 1], sample_rate).

    Handles PCM 8/16/24/32-bit and IEEE float 32/64, including files with
    extra chunks (LIST/fact/...) and WAVE_FORMAT_EXTENSIBLE.
    """
    raw = Path(path).read_bytes()
    if len(raw) < 12 or raw[:4] != b"RIFF" or raw[8:12] != b"WAVE":
        raise AudioDecodeError(f"Not a RIFF/WAVE file: {path}")

    pos, fmt, data = 12, None, None
    while pos + 8 <= len(raw):
        cid = raw[pos : pos + 4]
        size = struct.unpack_from("<I", raw, pos + 4)[0]
        if pos + 8 + size > len(raw):
            # A chunk whose declared size overruns the file is a truncated
            # download/write. Silently decoding the short payload would hand
            # a partial clip downstream — fail LOUDLY instead (module rule).
            raise AudioDecodeError(
                f"Truncated WAV: chunk {cid!r} declares {size} bytes but only "
                f"{len(raw) - pos - 8} remain: {path}"
            )
        body = raw[pos + 8 : pos + 8 + size]
        if cid == b"fmt ":
            fmt = body
        elif cid == b"data":
            data = body
        pos += 8 + size + (size & 1)
    if fmt is None or data is None:
        raise AudioDecodeError(f"Missing fmt/data chunk: {path}")
    if len(fmt) < 16:
        raise AudioDecodeError(f"Truncated fmt chunk: {path}")

    (audio_fmt, n_ch, sr, _, _, bits) = struct.unpack_from("<HHIIHH", fmt, 0)
    if audio_fmt == 0xFFFE and len(fmt) >= 26:  # EXTENSIBLE: real fmt at +24
        audio_fmt = struct.unpack_from("<H", fmt, 24)[0]
    if n_ch == 0 or sr == 0:
        raise AudioDecodeError(
            f"Invalid fmt (channels={n_ch}, sample_rate={sr}): {path}"
        )

    if audio_fmt == 1:  # PCM
        if bits == 8:
            x = (raw_frombuffer(data, np.uint8).astype(np.float32) - 128.0) / 128.0
        elif bits == 16:
            x = raw_frombuffer(data, np.int16).astype(np.float32) / 32768.0
        elif bits == 24:
            b = np.frombuffer(data, np.uint8)
            b = b[: len(b) - len(b) % 3].reshape(-1, 3)
            x = (
                b[:, 0].astype(np.int32)
                | (b[:, 1].astype(np.int32) << 8)
                | (b[:, 2].astype(np.int32) << 16)
            )
            x = (x << 8 >> 8).astype(np.float32) / 8388608.0
        elif bits == 32:
            x = raw_frombuffer(data, np.int32).astype(np.float32) / 2147483648.0
        else:
            raise AudioDecodeError(f"Unsupported PCM depth {bits}: {path}")
    elif audio_fmt == 3:  # IEEE float
        if bits == 32:
            dt = np.float32
        elif bits == 64:
            dt = np.float64
        else:
            # fmt=3 with any other depth has no IEEE layout to reinterpret —
            # decoding would produce garbage amplitudes, not audio.
            raise AudioDecodeError(f"Unsupported float depth {bits}: {path}")
        x = raw_frombuffer(data, dt).astype(np.float32)
    else:
        raise AudioDecodeError(f"Unsupported WAV format {audio_fmt}: {path}")

    x = x[: len(x) - len(x) % max(n_ch, 1)]
    return x.reshape(-1, n_ch).T.copy(), sr


def raw_frombuffer(data: bytes, dtype) -> np.ndarray:
    item = np.dtype(dtype).itemsize
    return np.frombuffer(data[: len(data) - len(data) % item], dtype)


def write_wav(path: PathLike, wave: np.ndarray, sample_rate: int) -> None:
    """Write float waveform ((S,) or (C, S)) as 16-bit PCM WAV.

    Scale is 32768 (with +1.0 clipping to 32767) — the same convention as
    read_wav, shards.INT16_SCALE and the serve quantizer twins — so a
    decode → write_wav → decode round trip is bit-exact for every code.
    (A 32767 scale perturbed all |k| >= 16385 by one LSB.)"""
    wave = np.asarray(wave, dtype=np.float32)
    if wave.ndim == 1:
        wave = wave[None, :]
    n_ch, n_samples = wave.shape
    pcm = (
        np.clip(np.round(wave.T * 32768.0), -32768, 32767).astype("<i2").tobytes()
    )

    byte_rate = sample_rate * n_ch * 2
    hdr = b"RIFF" + struct.pack("<I", 36 + len(pcm)) + b"WAVE"
    hdr += b"fmt " + struct.pack(
        "<IHHIIHH", 16, 1, n_ch, sample_rate, byte_rate, n_ch * 2, 16
    )
    hdr += b"data" + struct.pack("<I", len(pcm))
    Path(path).write_bytes(hdr + pcm)


# ---------------------------------------------------------------------------
# Compressed formats via ffmpeg (gated)
# ---------------------------------------------------------------------------


def ffmpeg_available() -> bool:
    return shutil.which("ffmpeg") is not None


def _ffprobe_rate(path: PathLike) -> Optional[int]:
    """The first audio stream's native sample rate, or None if ffprobe is
    unavailable or the probe fails (callers fall back gracefully)."""
    if shutil.which("ffprobe") is None:
        return None
    try:
        out = subprocess.run(
            ["ffprobe", "-v", "error", "-select_streams", "a:0",
             "-show_entries", "stream=sample_rate", "-of", "csv=p=0",
             str(path)],
            capture_output=True, check=True,
        ).stdout
        rate = int(out.strip().splitlines()[0])
        return rate or None
    except (subprocess.CalledProcessError, ValueError, IndexError):
        return None


def decode_with_ffmpeg(
    path: PathLike, target_sr: int = None
) -> Tuple[np.ndarray, int]:
    """Decode any format ffmpeg understands → (channels, samples) float32.

    Decodes at the file's NATIVE rate whenever ffprobe can report it, so
    the polyphase bank (resample_np — the same kernels as the device
    path) performs ALL resampling, matching the reference's
    decode-native-then-Resample pipeline (reference: src/dataset.py:
    142-152). Forcing `-ar` here instead would let ffmpeg's own swr
    resampler run first — and with a target above 16 kHz, a hardcoded
    16 kHz decode would silently band-limit every compressed clip.
    Falls back to ffmpeg-side resampling at target_sr only when the
    probe fails."""
    if not ffmpeg_available():
        raise AudioDecodeError(
            f"Failed to load audio file: {path}\n"
            "Compressed formats require an ffmpeg binary on PATH "
            "(install ffmpeg), or pre-convert to .wav."
        )
    sr = _ffprobe_rate(path) or target_sr or 16000
    cmd = [
        "ffmpeg", "-v", "error", "-i", str(path),
        "-f", "f32le", "-acodec", "pcm_f32le", "-ac", "1",
        "-ar", str(sr), "-",
    ]
    try:
        out = subprocess.run(cmd, capture_output=True, check=True).stdout
    except subprocess.CalledProcessError as e:
        raise AudioDecodeError(
            f"ffmpeg failed on {path}: {e.stderr.decode(errors='replace')}"
        ) from e
    return np.frombuffer(out, np.float32).reshape(1, -1).copy(), sr


def decode_audio(
    path: PathLike, target_sr: int = None
) -> Tuple[np.ndarray, int]:
    """(channels, samples) float32 + rate, any supported container.
    `target_sr` is only a FALLBACK hint for compressed formats whose
    native rate cannot be probed — decode is native-rate otherwise, with
    resampling owned by the caller's polyphase path."""
    p = Path(path)
    if p.suffix.lower() == ".wav":
        return read_wav(p)
    return decode_with_ffmpeg(p, target_sr)


# ---------------------------------------------------------------------------
# Host resample (same kernel bank as the device path)
# ---------------------------------------------------------------------------


def resample_np(wave: np.ndarray, orig_sr: int, new_sr: int) -> np.ndarray:
    """Polyphase resample (C, S) on host, numerically matching ops.resample."""
    import math

    if orig_sr == new_sr:
        return wave
    gcd = math.gcd(int(orig_sr), int(new_sr))
    orig, new = int(orig_sr) // gcd, int(new_sr) // gcd
    kernels, width = _sinc_kernel(orig, new)  # (new, 1, K)
    k = kernels[:, 0, :]  # (new, K)
    ksz = k.shape[1]

    length = wave.shape[-1]
    target = -(-new * length // orig)
    padded = np.pad(wave, [(0, 0), (width, width + orig)])
    n_frames = (padded.shape[-1] - ksz) // orig + 1
    idx = np.arange(n_frames)[:, None] * orig + np.arange(ksz)[None, :]
    frames = padded[:, idx]  # (C, frames, K)
    out = np.einsum("cfk,pk->cfp", frames, k).reshape(wave.shape[0], -1)
    return out[:, :target].astype(np.float32)


def load_mono_16k(path: PathLike, target_sr: int = 16000) -> np.ndarray:
    """Decode → mono mean → resample to target: the loader-side prefix of
    the reference pipeline (reference: src/dataset.py:142-152)."""
    wave, sr = decode_audio(path, target_sr)
    mono = wave.mean(axis=0, keepdims=True)
    if sr != target_sr:
        mono = resample_np(mono, sr, target_sr)
    return mono[0]
