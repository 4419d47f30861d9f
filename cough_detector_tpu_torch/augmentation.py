"""Reference-API augmentation facade, the port of
`cough_detector_tpu/augmentation.py`.

The reference augmentors' classes (reference: src/augmentation.py) over
the port's batched ops in augment/. Each object owns a `torch.Generator`
on its device, seeded from `seed`, and every call draws from it, so a run
repeats for a seed and varies from call to call like the reference's.
Inputs and outputs are numpy arrays; the work runs on `device` (the card
unless the caller passes device="cpu").
"""

from __future__ import annotations

from pathlib import Path
from typing import List, Optional, Tuple, Union

import numpy as np
import torch

from .augment import spec as _spec
from .augment import waveform as _wave
from .data import audio_io
from .utils.device import resolve_device


class AudioAugmentor:
    """Waveform-domain augmentation chain
    (reference: src/augmentation.py:19-268)."""

    def __init__(
        self,
        sample_rate: int = 16000,
        noise_dir: Optional[str] = None,
        p_augment: float = 0.5,
        seed: int = 0,
        device: Union[str, torch.device] = "cuda",
    ):
        self.sample_rate = sample_rate
        self.p_augment = p_augment
        self.device = resolve_device(device)
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self.noise_samples: List[np.ndarray] = []
        self._noise_bank: Optional[torch.Tensor] = None
        if noise_dir and Path(noise_dir).exists():
            self._load_noise_samples(noise_dir)

    def _load_noise_samples(self, noise_dir: str, max_samples: int = 100):
        """Load at most 100 noise clips, resampled and made mono
        (reference: src/augmentation.py:56-75), into a fixed-shape bank on
        the device: each clip tiled to the longest one (at least 1 s)."""
        files = sorted(
            f for f in Path(noise_dir).iterdir()
            if f.suffix.lower() in audio_io.AUDIO_EXTENSIONS
        )[:max_samples]
        for f in files:
            try:
                self.noise_samples.append(audio_io.load_mono_16k(f, self.sample_rate))
            except Exception:
                continue
        if self.noise_samples:
            width = max(max(len(n) for n in self.noise_samples), self.sample_rate)
            bank = np.zeros((len(self.noise_samples), width), np.float32)
            for i, n in enumerate(self.noise_samples):
                reps = -(-width // max(len(n), 1))
                bank[i] = np.tile(n, reps)[:width]
            self._noise_bank = torch.from_numpy(bank).to(self.device)

    def _batched(self, fn, waveform, *args, **kw) -> np.ndarray:
        w = np.atleast_2d(np.asarray(waveform, np.float32))
        x = torch.from_numpy(np.ascontiguousarray(w)).to(self.device)
        return fn(x, self.generator, *args, **kw).cpu().numpy()

    def time_shift(self, waveform, shift_limit: float = 0.2):
        return self._batched(_wave.time_shift, waveform, self.p_augment, shift_limit)

    def speed_perturbation(self, waveform, speed_range=(0.9, 1.1)):
        """A no-op, as the reference's is (src/augmentation.py:107-117)."""
        return np.atleast_2d(np.asarray(waveform, np.float32))

    def add_noise(self, waveform, snr_range: Tuple[float, float] = (5, 20)):
        if self._noise_bank is None:
            return np.atleast_2d(np.asarray(waveform, np.float32))
        return self._batched(
            _wave.add_file_noise, waveform, self.p_augment, self._noise_bank, snr_range
        )

    def add_gaussian_noise(self, waveform, snr_range=(10, 30)):
        return self._batched(_wave.add_gaussian_noise, waveform, self.p_augment, snr_range)

    def volume_perturbation(self, waveform, gain_range=(0.7, 1.3)):
        return self._batched(_wave.volume_perturbation, waveform, self.p_augment, gain_range)

    def pitch_shift(self, waveform, shift_range: Tuple[int, int] = (-2, 2)):
        """Resample-based pitch shift, one draw for the whole call; the
        reference's sox path is a silent no-op without sox
        (src/augmentation.py:215-247)."""
        w = np.atleast_2d(np.asarray(waveform, np.float32))
        gen = self.generator
        if float(torch.rand((), generator=gen, device=self.device)) > self.p_augment:
            return w
        steps = int(torch.randint(shift_range[0], shift_range[1] + 1, (), generator=gen, device=self.device))
        x = torch.from_numpy(np.ascontiguousarray(w)).to(self.device)
        return _wave.pitch_shift_semitones(x, steps, self.sample_rate).cpu().numpy()

    def augment(self, waveform) -> np.ndarray:
        """The reference chain (src/augmentation.py:249-268)."""
        return self._batched(
            _wave.augment_waveforms, waveform, p=self.p_augment,
            noise_bank=self._noise_bank, sample_rate=self.sample_rate,
        )


class SpecAugment:
    """Time and frequency masking (reference: src/augmentation.py:271-331)."""

    def __init__(
        self,
        freq_mask_param: int = 10,
        time_mask_param: int = 20,
        n_freq_masks: int = 2,
        n_time_masks: int = 2,
        p: float = 0.5,
        seed: int = 0,
        device: Union[str, torch.device] = "cuda",
    ):
        self.freq_mask_param = freq_mask_param
        self.time_mask_param = time_mask_param
        self.n_freq_masks = n_freq_masks
        self.n_time_masks = n_time_masks
        self.p = p
        self.device = resolve_device(device)
        self.generator = torch.Generator(device=self.device).manual_seed(seed)

    def __call__(self, spectrogram: np.ndarray) -> np.ndarray:
        spec = np.asarray(spectrogram, np.float32)
        squeeze = spec.ndim == 3  # one (C, F, T) sample
        batch = spec[None] if squeeze else spec
        b, c, f, t = batch.shape  # channels fold into the batch for masking
        x = torch.from_numpy(np.ascontiguousarray(batch.reshape(b * c, f, t))).to(self.device)
        out = _spec.spec_augment(
            x, self.generator,
            freq_mask_param=self.freq_mask_param,
            time_mask_param=self.time_mask_param,
            n_freq_masks=self.n_freq_masks,
            n_time_masks=self.n_time_masks,
            p=self.p,
        ).cpu().numpy().reshape(b, c, f, t)
        return out[0] if squeeze else out


class MixUp:
    """Pairwise MixUp (reference: src/augmentation.py:334-369); λ ~ Beta(α, α)
    from a numpy Generator seeded with `seed`."""

    def __init__(self, alpha: float = 0.2, seed: int = 0):
        self.alpha = alpha
        self._rng = np.random.default_rng(seed)

    def __call__(self, x1, y1, x2, y2):
        lam = float(self._rng.beta(self.alpha, self.alpha))
        x = lam * np.asarray(x1) + (1 - lam) * np.asarray(x2)
        y = lam * np.asarray(y1) + (1 - lam) * np.asarray(y2)
        return x, y


def create_augmentation_pipeline(
    sample_rate: int = 16000,
    noise_dir: Optional[str] = None,
    p_augment: float = 0.5,
    use_spec_augment: bool = True,
    device: Union[str, torch.device] = "cuda",
) -> Tuple[AudioAugmentor, Optional[SpecAugment]]:
    """Factory (reference: src/augmentation.py:372-398)."""
    audio_aug = AudioAugmentor(
        sample_rate=sample_rate, noise_dir=noise_dir, p_augment=p_augment, device=device
    )
    spec_aug = SpecAugment(p=p_augment, device=device) if use_spec_augment else None
    return audio_aug, spec_aug
