"""Batched waveform-domain augmentation on the device.

The port of `cough_detector_tpu/augment/waveform.py`. Every clip draws its
own decisions and parameters, from an explicit `torch.Generator` on the
batch's device (the train loop seeds it from (seed, epoch, step), so a
resumed run draws what an uninterrupted one drew). Each op is split into a
draw part (`*_draws`, the random numbers) and an apply part (`*_apply`, a
pure function of the batch and those numbers), so a test can feed the apply
part the draws another generator made.

Semantics per op (reference: src/augmentation.py:19-268):
  time_shift     — ±20% shift, zero-filled (not circular), prob p
  volume         — gain U[0.7, 1.3], prob p
  gaussian noise — SNR U[10, 30] dB, prob p
  file noise     — random bank clip at SNR U[5, 20] dB, prob p
Chain order: shift → volume → gaussian → file noise. A clip takes an op
iff its U[0, 1) gate draw is <= p.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch


def _rand(gen: torch.Generator, *shape: int) -> torch.Tensor:
    return torch.rand(shape, generator=gen, device=gen.device)


def _uniform(gen: torch.Generator, b: int, lo: float, hi: float) -> torch.Tensor:
    return _rand(gen, b) * (hi - lo) + lo


def _gate(gen: torch.Generator, p: float, b: int) -> torch.Tensor:
    return _rand(gen, b) <= p


# -- time shift ------------------------------------------------------------------


def time_shift_draws(
    gen: torch.Generator, b: int, s: int, p: float, shift_limit: float = 0.2
) -> torch.Tensor:
    """(B,) int64 shifts in samples, round(U[-limit, limit) * s) where the
    clip's gate opens and 0 elsewhere."""
    apply = _gate(gen, p, b)
    amt = torch.round(_uniform(gen, b, -shift_limit, shift_limit) * s).to(torch.int64)
    return torch.where(apply, amt, 0)


def time_shift_apply(waves: torch.Tensor, amt: torch.Tensor) -> torch.Tensor:
    """out[b, n] = waves[b, n - amt[b]], zero where n - amt[b] leaves the
    clip (the reference's pad-then-trim, reference: src/augmentation.py:95-104)."""
    s = waves.shape[1]
    src = torch.arange(s, device=waves.device)[None, :] - amt[:, None]
    inside = (src >= 0) & (src < s)
    return torch.where(inside, waves.gather(1, src.clamp(0, s - 1)), 0.0)


def time_shift(
    waves: torch.Tensor, gen: torch.Generator, p: float, shift_limit: float = 0.2
) -> torch.Tensor:
    b, s = waves.shape
    return time_shift_apply(waves, time_shift_draws(gen, b, s, p, shift_limit))


# -- volume ----------------------------------------------------------------------


def volume_draws(
    gen: torch.Generator, b: int, p: float, gain_range: Tuple[float, float] = (0.7, 1.3)
) -> torch.Tensor:
    """(B,) gains, U[gain_range) where the gate opens and 1.0 elsewhere."""
    apply = _gate(gen, p, b)
    gain = _uniform(gen, b, *gain_range)
    return torch.where(apply, gain, 1.0)


def volume_apply(waves: torch.Tensor, gain: torch.Tensor) -> torch.Tensor:
    return waves * gain[:, None]


def volume_perturbation(
    waves: torch.Tensor,
    gen: torch.Generator,
    p: float,
    gain_range: Tuple[float, float] = (0.7, 1.3),
) -> torch.Tensor:
    return volume_apply(waves, volume_draws(gen, waves.shape[0], p, gain_range))


# -- gaussian noise --------------------------------------------------------------


class NoiseDraws(NamedTuple):
    apply: torch.Tensor   # (B,) bool gate
    snr_db: torch.Tensor  # (B,) target SNR in dB
    noise: torch.Tensor   # (B, S) standard normal


def gaussian_noise_draws(
    gen: torch.Generator, b: int, s: int, p: float,
    snr_range: Tuple[float, float] = (10.0, 30.0),
) -> NoiseDraws:
    apply = _gate(gen, p, b)
    snr_db = _uniform(gen, b, *snr_range)
    noise = torch.randn((b, s), generator=gen, device=gen.device)
    return NoiseDraws(apply, snr_db, noise)


def _powers(waves, noise, snr_db) -> tuple:
    """(B,) each: the clips' mean power, the noise's, and the linear SNR."""
    sig_pow = (waves * waves).mean(dim=1)
    noise_pow = (noise * noise).mean(dim=1)
    return sig_pow, noise_pow, 10.0 ** (snr_db / 10.0)


def gaussian_noise_apply(waves: torch.Tensor, d: NoiseDraws) -> torch.Tensor:
    sig_pow, noise_pow, snr_lin = _powers(waves, d.noise, d.snr_db)
    scale = torch.where(d.apply, torch.sqrt(sig_pow / (snr_lin * noise_pow)), 0.0)
    return waves + scale[:, None] * d.noise


def add_gaussian_noise(
    waves: torch.Tensor, gen: torch.Generator, p: float,
    snr_range: Tuple[float, float] = (10.0, 30.0),
) -> torch.Tensor:
    b, s = waves.shape
    return gaussian_noise_apply(waves, gaussian_noise_draws(gen, b, s, p, snr_range))


# -- file noise ------------------------------------------------------------------


class FileNoiseDraws(NamedTuple):
    apply: torch.Tensor   # (B,) bool gate
    pick: torch.Tensor    # (B,) int64 bank row
    start: torch.Tensor   # (B,) int64 crop start within the bank row
    snr_db: torch.Tensor  # (B,) target SNR in dB


def file_noise_draws(
    gen: torch.Generator, b: int, s: int, p: float, bank_shape: Tuple[int, int],
    snr_range: Tuple[float, float] = (5.0, 20.0),
) -> FileNoiseDraws:
    n, bank_len = bank_shape
    apply = _gate(gen, p, b)
    pick = torch.randint(0, n, (b,), generator=gen, device=gen.device)
    start = torch.randint(0, max(bank_len - s, 0) + 1, (b,), generator=gen, device=gen.device)
    return FileNoiseDraws(apply, pick, start, _uniform(gen, b, *snr_range))


def file_noise_apply(
    waves: torch.Tensor, d: FileNoiseDraws, noise_bank: torch.Tensor
) -> torch.Tensor:
    """Mix bank row `pick`, cropped to the clip length from `start`, at
    `snr_db`; a silent crop adds nothing."""
    s = waves.shape[1]
    cols = d.start[:, None] + torch.arange(s, device=waves.device)[None, :]
    noise = noise_bank[d.pick[:, None], cols]
    sig_pow, noise_pow, snr_lin = _powers(waves, noise, d.snr_db)
    scale = torch.sqrt(sig_pow / (snr_lin * noise_pow.clamp_min(1e-12)))
    scale = torch.where(d.apply & (noise_pow > 0), scale, 0.0)
    return waves + scale[:, None] * noise


def add_file_noise(
    waves: torch.Tensor, gen: torch.Generator, p: float, noise_bank: torch.Tensor,
    snr_range: Tuple[float, float] = (5.0, 20.0),
) -> torch.Tensor:
    """Mix a random clip of a (N, S_bank >= S) noise bank at random SNR
    (reference: src/augmentation.py:119-163)."""
    b, s = waves.shape
    d = file_noise_draws(gen, b, s, p, tuple(noise_bank.shape), snr_range)
    return file_noise_apply(waves, d, noise_bank)


# -- resampling ops --------------------------------------------------------------


def speed_perturbation(waves, gen, p, factors=(0.9, 0.95, 1.05, 1.1), sample_rate=16000):
    """Needs the port of ops/resample.py, which is not done yet."""
    raise NotImplementedError(
        "speed_perturbation needs ops/resample.py, not ported yet (ROADMAP Queue 1 item 10b)"
    )


def pitch_shift_semitones(waves, semitones, sample_rate=16000):
    """Needs the port of ops/resample.py, which is not done yet."""
    raise NotImplementedError(
        "pitch_shift_semitones needs ops/resample.py, not ported yet (ROADMAP Queue 1 item 10b)"
    )


# -- chain -----------------------------------------------------------------------


def augment_waveforms(
    waves: torch.Tensor,
    gen: torch.Generator,
    p: float = 0.3,
    noise_bank: Optional[torch.Tensor] = None,
    use_speed_perturbation: bool = False,
    use_time_shift: bool = True,
    sample_rate: int = 16000,
) -> torch.Tensor:
    """The reference chain (reference: src/augmentation.py:249-268) on a
    (B, S) batch. p <= 0 returns the batch unchanged and draws nothing."""
    if use_speed_perturbation:
        speed_perturbation(waves, gen, p, sample_rate=sample_rate)
    if p <= 0:
        return waves
    if use_time_shift:
        waves = time_shift(waves, gen, p)
    waves = volume_perturbation(waves, gen, p)
    waves = add_gaussian_noise(waves, gen, p)
    if noise_bank is not None and noise_bank.shape[0] > 0:
        waves = add_file_noise(waves, gen, p, noise_bank)
    return waves
