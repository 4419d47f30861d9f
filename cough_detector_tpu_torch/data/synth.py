"""Deterministic synthetic audio generators, the port's copy.

A copy of `cough_detector_tpu/data/synth.py` (numpy and scipy only, clip
for clip the same output for the same seed), kept here because the port
imports nothing of the JAX package. The training smoke corpus and the
tests draw from it.

Capability port of the reference's synthetic data path
(reference: setup_data.py:95-164, prepare_data.py:118-172): cough-like bursts
(sharp attack + exponential decay over broadband noise with chest-resonance
sines) and non-cough sounds (silence / white noise / mains hum / clicks).

Unlike the reference — which draws from the global numpy RNG — every
generator here takes an explicit seed, so the same clip doubles as a golden
test fixture and a reproducible dataset sample.
"""

from __future__ import annotations

import numpy as np

SAMPLE_RATE = 16000

# Negative-sample menu: the union of the reference's setup_data.py
# silence/white/hum/clicks kinds (setup_data.py:95-164) and
# prepare_data.py's pink-noise + ambient multi-sine kinds
# (prepare_data.py:138-162). synthetic_non_cough draws its kind from
# this tuple with the seed's FIRST rng call — tests replay that draw
# to know which kind a given seed produces.
NON_COUGH_KINDS = (
    "silence", "white_noise", "hum", "clicks", "pink_noise", "ambient"
)


def synthetic_cough(
    seed: int,
    duration_s: float = 2.0,
    sample_rate: int = SAMPLE_RATE,
) -> np.ndarray:
    """A cough-like burst: 20 ms linear attack, exponential decay envelope
    over broadband noise mixed with 80-150 Hz and 200-400 Hz resonances."""
    rng = np.random.default_rng(seed)
    n = int(sample_rate * duration_s)
    t = np.linspace(0, duration_s, n)

    burst_dur = rng.uniform(0.3, min(0.8, duration_s * 0.6))
    start_lo = min(0.3, duration_s * 0.1)
    start_hi = max(start_lo + 0.01, min(1.0, duration_s - burst_dur - 0.05))
    burst_start = rng.uniform(start_lo, start_hi)

    envelope = np.zeros(n)
    start_idx = int(burst_start * sample_rate)
    burst_samples = int(burst_dur * sample_rate)
    attack = np.linspace(0, 1, int(0.02 * sample_rate))
    decay = np.exp(-np.linspace(0, 5, burst_samples - len(attack)))
    env = np.concatenate([attack, decay])
    end = min(start_idx + len(env), n)
    envelope[start_idx:end] = env[: end - start_idx]

    noise = rng.standard_normal(n)
    low = np.sin(2 * np.pi * rng.uniform(80, 150) * t)
    mid = np.sin(2 * np.pi * rng.uniform(200, 400) * t)

    audio = envelope * (0.7 * noise + 0.2 * low + 0.1 * mid)
    audio = audio / (np.abs(audio).max() + 1e-8) * 0.8
    audio += rng.standard_normal(n) * 0.01
    return audio.astype(np.float32)


def synthetic_non_cough(
    seed: int,
    duration_s: float = 2.0,
    sample_rate: int = SAMPLE_RATE,
) -> np.ndarray:
    """Deterministic synthetic negative, kind chosen by seed.

    Covers the union of both reference menus: setup_data.py's
    silence/white/hum/clicks (setup_data.py:95-164) plus prepare_data.py's
    pink-noise (cumulative-sum 1/f approximation) and ambient multi-sine
    mixes (reference: prepare_data.py:138-162).
    """
    rng = np.random.default_rng(seed)
    n = int(sample_rate * duration_s)
    t = np.linspace(0, duration_s, n)

    kind = rng.choice(list(NON_COUGH_KINDS))
    if kind == "silence":
        audio = rng.standard_normal(n) * 0.005
    elif kind == "white_noise":
        audio = rng.standard_normal(n) * rng.uniform(0.02, 0.1)
    elif kind == "hum":
        freq = rng.choice([50, 60, 100, 120])
        audio = np.sin(2 * np.pi * freq * t) * 0.1
        audio += rng.standard_normal(n) * 0.02
    elif kind == "clicks":
        audio = rng.standard_normal(n) * 0.01
        for _ in range(rng.integers(1, 5)):
            pos = rng.integers(0, n - 100)
            audio[pos : pos + 50] = rng.uniform(-0.3, 0.3)
    elif kind == "pink_noise":
        pink = np.cumsum(rng.standard_normal(n))
        pink = pink / (np.abs(pink).max() + 1e-8)
        audio = pink * rng.uniform(0.01, 0.1)
    else:  # ambient: 1-3 low sines over a noise floor
        freqs = rng.choice([60, 120, 240, 500, 1000], size=rng.integers(1, 4),
                           replace=False)
        audio = np.zeros(n)
        for f in freqs:
            audio += np.sin(2 * np.pi * f * t) * rng.uniform(0.01, 0.03)
        audio += rng.standard_normal(n) * 0.005

    audio = audio / (np.abs(audio).max() + 1e-8) * 0.5
    return audio.astype(np.float32)


def _resonator(x: np.ndarray, freq: float, bandwidth: float,
               sample_rate: int) -> np.ndarray:
    """Second-order all-pole resonance (a formant): poles at `freq` with
    the given -3 dB bandwidth — the standard source-filter building block
    (Klatt-style formant synthesis)."""
    from scipy.signal import lfilter

    r = np.exp(-np.pi * bandwidth / sample_rate)
    theta = 2 * np.pi * freq / sample_rate
    a = [1.0, -2 * r * np.cos(theta), r * r]
    return lfilter([1.0 - r], a, x)


def _voiced_source(
    rng: np.random.Generator, n: int, f0: float, sample_rate: int,
    contour: float = 0.0, jitter: float = 0.01,
) -> np.ndarray:
    """Glottal-like source: harmonic-rich pulse train at a pitch contour
    f0·(1+contour·t/T) with cycle jitter, plus a little aspiration noise."""
    t = np.arange(n) / sample_rate
    T = max(t[-1], 1e-6)
    inst_f0 = f0 * (1.0 + contour * t / T) * (
        1.0 + jitter * rng.standard_normal(n).cumsum() / max(n, 1)
    )
    phase = 2 * np.pi * np.cumsum(inst_f0) / sample_rate
    src = np.zeros(n)
    for k in range(1, 11):  # 10 harmonics, -6 dB/oct rolloff
        src += np.sin(k * phase) / k
    return src + 0.05 * rng.standard_normal(n)


def synthetic_speech(
    seed: int,
    duration_s: float = 2.0,
    sample_rate: int = SAMPLE_RATE,
) -> np.ndarray:
    """Voiced/harmonic speech proxy (r3 VERDICT #5): a syllable stream of
    pitch-contoured glottal harmonics under two formant resonances, with
    unvoiced fricative syllables and occasional plosive onsets — the
    structures (harmonics, formants, transients) the old AM-noise babble
    lacked, which is what makes it a real discriminator for the <1 FP/min
    speech target (reference protocol: IMPROVEMENT_PLAN.md:321)."""
    rng = np.random.default_rng([seed, 51])
    n = int(sample_rate * duration_s)
    out = np.zeros(n)
    f0_base = rng.uniform(95, 220)  # one "speaker" per clip
    pos = 0
    while pos < n:
        syl = int(rng.uniform(0.10, 0.28) * sample_rate)
        gap = int(rng.uniform(0.02, 0.15) * sample_rate)
        seg_n = min(syl, n - pos)
        if seg_n <= 64:
            break
        if rng.uniform() < 0.75:  # voiced syllable
            src = _voiced_source(
                rng, seg_n, f0_base * rng.uniform(0.85, 1.25),
                sample_rate, contour=rng.uniform(-0.25, 0.25),
            )
            f1 = rng.uniform(300, 850)
            f2 = rng.uniform(900, 2300)
            seg = _resonator(src, f1, rng.uniform(60, 120), sample_rate)
            seg += 0.5 * _resonator(src, f2, rng.uniform(90, 180),
                                    sample_rate)
            if rng.uniform() < 0.3:  # plosive onset (p/t/k burst)
                # Like the envelope below, the burst must fit a
                # tail-clipped syllable (seg_n can be as short as 65).
                burst = min(int(0.015 * sample_rate), seg_n)
                seg[:burst] += rng.standard_normal(burst) * np.linspace(
                    2.5, 0.0, burst
                )
        else:  # unvoiced fricative (s/sh-like high band noise)
            seg = _resonator(
                rng.standard_normal(seg_n),
                rng.uniform(2500, 5500), rng.uniform(800, 1500),
                sample_rate,
            ) * 0.6
        env = np.ones(seg_n)
        # Attack/release windows must fit the (possibly tail-clipped)
        # syllable: seg_n can be as short as 65 samples when the last
        # syllable hits the end of the clip, while 15 ms is 240.
        a = min(max(int(0.015 * sample_rate), 1), seg_n // 2)
        env[:a] = np.linspace(0, 1, a)
        env[-a:] *= np.linspace(1, 0.2, a)
        out[pos : pos + seg_n] += seg * env
        pos += seg_n + gap
    out = out / (np.abs(out).max() + 1e-8) * 0.3
    out += rng.standard_normal(n) * 0.002  # room floor
    return out.astype(np.float32)


def synthetic_laugh(
    seed: int,
    duration_s: float = 2.0,
    sample_rate: int = SAMPLE_RATE,
) -> np.ndarray:
    """Laughter burst train — a cough-CONFUSABLE negative (r3 VERDICT #5):
    4-8 short voiced 'ha' bursts at ~4-6 Hz, each a sharp-attack
    exponentially-decaying harmonic burst with breath noise. Shares the
    cough's transient envelope but keeps voicing and formant structure."""
    rng = np.random.default_rng([seed, 52])
    n = int(sample_rate * duration_s)
    out = rng.standard_normal(n) * 0.003
    rate = rng.uniform(4.0, 6.0)  # bursts per second
    period = int(sample_rate / rate)
    n_bursts = int(rng.integers(4, 9))
    start = int(rng.uniform(0.05, 0.2) * sample_rate)
    f0 = rng.uniform(180, 320)
    for b in range(n_bursts):
        pos = start + b * period
        dur = int(rng.uniform(0.08, 0.16) * sample_rate)
        if pos + dur >= n:
            break
        src = _voiced_source(rng, dur, f0 * rng.uniform(0.9, 1.15),
                             sample_rate, contour=-0.3)
        seg = _resonator(src, rng.uniform(500, 900), 90, sample_rate)
        seg += 0.6 * rng.standard_normal(dur)  # breathy
        a = max(int(0.008 * sample_rate), 1)
        env = np.exp(-np.linspace(0, 4.5, dur))
        env[:a] *= np.linspace(0, 1, a)
        out[pos : pos + dur] += seg * env * rng.uniform(0.7, 1.0)
    out = out / (np.abs(out).max() + 1e-8) * 0.5
    return out.astype(np.float32)


def synthetic_throat_clear(
    seed: int,
    duration_s: float = 2.0,
    sample_rate: int = SAMPLE_RATE,
) -> np.ndarray:
    """Throat clear — a cough-confusable negative (r3 VERDICT #5): 1-3
    low-frequency rumbling noise bursts with a slower attack than a true
    cough and energy concentrated in the 100-400 Hz laryngeal band."""
    rng = np.random.default_rng([seed, 53])
    n = int(sample_rate * duration_s)
    out = rng.standard_normal(n) * 0.003
    pos = int(rng.uniform(0.1, 0.3) * sample_rate)
    for _ in range(int(rng.integers(1, 4))):
        dur = int(rng.uniform(0.25, 0.5) * sample_rate)
        if pos + dur >= n:
            break
        src = rng.standard_normal(dur)
        seg = _resonator(src, rng.uniform(110, 220), 80, sample_rate)
        seg += 0.5 * _resonator(src, rng.uniform(250, 420), 120,
                                sample_rate)
        a = int(0.06 * sample_rate)  # slow-ish attack (vs cough's 20 ms)
        env = np.exp(-np.linspace(0, 3.0, dur))
        env[:a] *= np.linspace(0, 1, a)
        out[pos : pos + dur] += seg * env
        pos += dur + int(rng.uniform(0.1, 0.3) * sample_rate)
    out = out / (np.abs(out).max() + 1e-8) * 0.55
    return out.astype(np.float32)


# The cough-CONFUSABLE negative vocabulary (the structures the r4
# behavioral protocol measures FP/min against). synthetic_hard_negative
# draws its kind from this tuple with the seed's FIRST rng call — same
# replayable-draw contract as NON_COUGH_KINDS.
HARD_NEGATIVE_KINDS = ("speech", "laugh", "throat_clear")


def synthetic_hard_negative(
    seed: int,
    duration_s: float = 2.0,
    sample_rate: int = SAMPLE_RATE,
    kind_weights=None,
) -> np.ndarray:
    """Cough-confusable negative, kind chosen by seed: voiced speech, a
    laugh burst train, or a throat clear. This is the training-side twin
    of the r4 behavioral protocol's confusables scenario
    (cli/evaluate.py) — mix a fraction of these into the negative class
    (`acquire.generate_synthetic_dataset(hard_negative_frac=...)`) so
    models are not blind to transient/voiced negatives. Implements the
    reference's hard-negative data-curation step (IMPROVEMENT_PLAN.md:
    81-85 marks foreground speech / throat clearing / laughing as the
    missing critical+high negative classes; 142-144 plans their
    collection) on the synthetic path.

    `kind_weights` ({kind: weight} over HARD_NEGATIVE_KINDS, normalized
    here) skews the kind mix — e.g. laugh-heavy curation when laughs are
    the measured FP residue (BASELINE.md r5 matrix). None keeps the
    uniform draw AND its exact rng stream, so existing corpora replay
    bit-identically."""
    rng = np.random.default_rng([seed, 54])
    if kind_weights is None:
        kind = rng.choice(list(HARD_NEGATIVE_KINDS))
    else:
        unknown = set(kind_weights) - set(HARD_NEGATIVE_KINDS)
        if unknown:
            raise ValueError(
                f"unknown hard-negative kinds {sorted(unknown)}; "
                f"choose from {HARD_NEGATIVE_KINDS}"
            )
        w = np.array(
            [float(kind_weights.get(k, 0.0)) for k in HARD_NEGATIVE_KINDS]
        )
        if w.sum() <= 0 or (w < 0).any():
            raise ValueError(
                f"kind_weights must be non-negative with a positive sum, "
                f"got {kind_weights!r}"
            )
        kind = rng.choice(list(HARD_NEGATIVE_KINDS), p=w / w.sum())
    fn = {
        "speech": synthetic_speech,
        "laugh": synthetic_laugh,
        "throat_clear": synthetic_throat_clear,
    }[kind]
    return fn(seed, duration_s, sample_rate)


def sine_sweep(
    seed: int = 0,
    duration_s: float = 1.0,
    f0: float = 100.0,
    f1: float = 7000.0,
    sample_rate: int = SAMPLE_RATE,
) -> np.ndarray:
    """Deterministic log chirp — a classic DSP golden-test signal."""
    n = int(sample_rate * duration_s)
    t = np.linspace(0, duration_s, n)
    k = (f1 / f0) ** (1 / duration_s)
    phase = 2 * np.pi * f0 * (k**t - 1) / np.log(k)
    amp = 0.9 if seed == 0 else np.random.default_rng(seed).uniform(0.3, 0.9)
    return (amp * np.sin(phase)).astype(np.float32)


def impulse(
    position: int = 8000,
    duration_s: float = 1.0,
    sample_rate: int = SAMPLE_RATE,
) -> np.ndarray:
    n = int(sample_rate * duration_s)
    out = np.zeros(n, dtype=np.float32)
    out[position] = 1.0
    return out


def fixture_batch(
    n_clips: int = 8,
    duration_s: float = 1.0,
    sample_rate: int = SAMPLE_RATE,
    seed: int = 0,
) -> np.ndarray:
    """(n_clips, samples) batch mixing coughs, non-coughs, sweeps, impulses."""
    clips = []
    for i in range(n_clips):
        kind = i % 4
        if kind == 0:
            clips.append(synthetic_cough(seed + i, duration_s, sample_rate))
        elif kind == 1:
            clips.append(synthetic_non_cough(seed + i, duration_s, sample_rate))
        elif kind == 2:
            clips.append(sine_sweep(seed + i, duration_s, sample_rate=sample_rate))
        else:
            clips.append(
                impulse(
                    position=(seed + i * 997) % (int(sample_rate * duration_s)),
                    duration_s=duration_s,
                    sample_rate=sample_rate,
                )
            )
    return np.stack(clips)
