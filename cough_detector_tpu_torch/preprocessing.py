"""Reference-API preprocessing facade, the port of
`cough_detector_tpu/preprocessing.py`.

The reference preprocessor's classes and methods (reference:
src/preprocessing.py:13-632) over the port's batched ops, so a reference
user's `AudioPreprocessor(...).process_file(p)` works unchanged and returns
the same (1, n_features, T) numpy geometry. Every call runs on the facade's
`device`: the card unless the caller passes device="cpu", where the
feature stages take the fused kernel (ops.frontend.extract_features_fast).
For throughput, call the batched ops directly.
"""

from __future__ import annotations

from typing import List, Optional, Tuple, Union

import numpy as np
import torch

from .config import FeatureConfig
from .data import audio_io
from .ops import frontend
from .ops.resample import resample as _resample
from .utils.device import resolve_device


class AudioPreprocessor:
    """Offline feature extractor (reference: src/preprocessing.py:13-550).

    The constructor's signature and defaults are the reference's, whose
    defaults enable every optional feature (PCEN, pre-emphasis,
    delta-deltas, spectral contrast); `device` is the torch device every
    call runs on.
    """

    def __init__(
        self,
        sample_rate: int = 16000,
        n_mels: int = 64,
        n_fft: int = 512,
        hop_length: int = 160,
        win_length: int = 400,
        f_min: float = 100.0,
        f_max: float = 4000.0,
        segment_duration: float = 1.0,
        n_mfcc: int = 13,
        use_mfcc: bool = True,
        use_pcen: bool = True,
        use_pre_emphasis: bool = True,
        pre_emphasis_coef: float = 0.97,
        use_delta_delta: bool = True,
        use_spectral_contrast: bool = True,
        n_contrast_bands: int = 6,
        device: Union[str, torch.device] = "cuda",
    ):
        self.device = resolve_device(device)
        self.config = FeatureConfig(
            sample_rate=sample_rate,
            n_mels=n_mels,
            n_fft=n_fft,
            hop_length=hop_length,
            win_length=win_length,
            f_min=f_min,
            f_max=f_max,
            segment_duration=segment_duration,
            n_mfcc=n_mfcc,
            use_mfcc=use_mfcc,
            use_pcen=use_pcen,
            use_pre_emphasis=use_pre_emphasis,
            pre_emphasis_coef=pre_emphasis_coef,
            use_delta_delta=use_delta_delta,
            use_spectral_contrast=use_spectral_contrast,
            n_contrast_bands=n_contrast_bands,
        )

    # the reference's attribute surface (self.n_mels, self.use_pcen, ...)
    def __getattr__(self, name):
        cfg = object.__getattribute__(self, "config")
        if hasattr(cfg, name):
            return getattr(cfg, name)
        raise AttributeError(name)

    @property
    def segment_samples(self) -> int:
        return self.config.segment_samples

    def _tensor(self, waveform) -> torch.Tensor:
        w = np.atleast_2d(np.asarray(waveform, np.float32))
        return torch.from_numpy(np.ascontiguousarray(w)).to(self.device)

    @staticmethod
    def _numpy(x: torch.Tensor) -> np.ndarray:
        return x.cpu().numpy()

    # -- waveform stages (reference: src/preprocessing.py:155-385) --------

    def load_audio(self, path: str) -> Tuple[np.ndarray, int]:
        return audio_io.decode_audio(path)

    def resample(self, waveform: np.ndarray, orig_sr: int) -> np.ndarray:
        if orig_sr == self.config.sample_rate:
            return np.atleast_2d(np.asarray(waveform, np.float32))
        return self._numpy(_resample(self._tensor(waveform), orig_sr, self.config.sample_rate))

    def to_mono(self, waveform: np.ndarray) -> np.ndarray:
        waveform = np.atleast_2d(np.asarray(waveform, np.float32))
        return waveform.mean(axis=0, keepdims=True)

    def normalize(self, waveform: np.ndarray) -> np.ndarray:
        return self._numpy(frontend.peak_normalize(self._tensor(waveform)))

    def pad_or_trim(self, waveform: np.ndarray, length: Optional[int] = None) -> np.ndarray:
        length = length or self.config.segment_samples
        return self._numpy(frontend.pad_or_trim(self._tensor(waveform), length))

    def apply_pre_emphasis(self, waveform: np.ndarray) -> np.ndarray:
        if not self.config.use_pre_emphasis:
            return np.atleast_2d(waveform)
        return self._numpy(
            frontend.pre_emphasis(self._tensor(waveform), self.config.pre_emphasis_coef)
        )

    # -- feature stages (reference: src/preprocessing.py:387-489) ---------

    def extract_mel_spectrogram(self, waveform: np.ndarray) -> np.ndarray:
        mel = frontend.mel_spectrogram(self._tensor(waveform), self.config)
        mel = frontend.pcen(mel) if self.config.use_pcen else frontend.log_mel_norm(mel)
        return self._numpy(mel.transpose(1, 2))

    def extract_mfcc(self, waveform: np.ndarray) -> np.ndarray:
        return self._numpy(frontend.mfcc(self._tensor(waveform), self.config).transpose(1, 2))

    def compute_deltas(self, features: np.ndarray) -> np.ndarray:
        f = torch.from_numpy(np.asarray(features, np.float32)).to(self.device)  # (C, F, T)
        return self._numpy(frontend.compute_deltas(f.transpose(1, 2)).transpose(1, 2))

    def extract_features(self, waveform: np.ndarray) -> np.ndarray:
        """(1, samples) → (1, n_features, T)."""
        return self._numpy(
            frontend.extract_features_fast(self._tensor(waveform), self.config, device=self.device)
        )

    def process(self, waveform: np.ndarray, orig_sr: int) -> np.ndarray:
        """resample → mono → normalize → pad/trim → features
        (reference: src/preprocessing.py:491-517)."""
        w = self.to_mono(self.resample(np.atleast_2d(waveform), orig_sr))
        w = frontend.pad_or_trim(frontend.peak_normalize(self._tensor(w)), self.config.segment_samples)
        return self._numpy(frontend.extract_features_fast(w, self.config, device=self.device))

    def process_file(self, path: str) -> np.ndarray:
        waveform, sr = self.load_audio(path)
        return self.process(waveform, sr)

    def get_expected_time_frames(self) -> int:
        return self.config.num_frames

    def get_num_features(self) -> int:
        return self.config.num_features


class RealtimePreprocessor(AudioPreprocessor):
    """Streaming facade (reference: src/preprocessing.py:553-616): append
    chunks, get one feature tensor per completed window. The windows a call
    completes go to the device as one batch; for many streams use
    stream.StreamingDetector, which keeps the whole tick on the device."""

    def __init__(self, window_duration: float = 1.0, hop_duration: float = 0.5, **kwargs):
        kwargs["segment_duration"] = window_duration
        super().__init__(**kwargs)
        self.window_duration = window_duration
        self.hop_duration = hop_duration
        self.window_samples = int(self.config.sample_rate * window_duration)
        self.hop_samples = int(self.config.sample_rate * hop_duration)
        self.buffer = np.zeros((1, 0), np.float32)

    def add_audio(self, audio_chunk: np.ndarray) -> List[np.ndarray]:
        chunk = np.atleast_2d(np.asarray(audio_chunk, np.float32))
        self.buffer = np.concatenate([self.buffer, chunk], axis=1)
        windows = []
        while self.buffer.shape[1] >= self.window_samples:
            windows.append(self.buffer[:, : self.window_samples])
            self.buffer = self.buffer[:, self.hop_samples :]
        if not windows:
            return []
        batch = frontend.peak_normalize(self._tensor(np.concatenate(windows, axis=0)))
        feats = self._numpy(frontend.extract_features_fast(batch, self.config, device=self.device))
        return [feats[i : i + 1] for i in range(len(windows))]

    def reset(self) -> None:
        self.buffer = np.zeros((1, 0), np.float32)


def create_preprocessor(realtime: bool = False, **kwargs) -> AudioPreprocessor:
    """Factory (reference: src/preprocessing.py:619-632)."""
    if realtime:
        return RealtimePreprocessor(**kwargs)
    return AudioPreprocessor(**kwargs)
