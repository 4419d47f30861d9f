"""How far the port's torch chain lies from a float64 chain on this host's CPU.

    python3 tools/host_numerics_probe.py

The batch of tests/test_torch_frontend.py::test_sine_sweep_in_band (the
fixture batch of data/synth.py, 8 clips, seed 3: coughs, non-coughs,
impulses and sine sweeps to 7 kHz) at f_max 8 kHz through the port's
plain chain (ops/frontend.py::extract_features, on the CPU) and through a
float64 numpy chain of the same stages (reflect pad, Hann window, rfft
power, mel, dB, DCT, z-norm, deltas). Prints the host's CPU and library
versions, each stage's max-relative deviation from float64 (the power
and mel as a share of their maxima, and as the largest share of any one
mel value, which float32 FFT rounding dominates in the bins the sweeps
leave near zero), and a SHA-256 digest of the chain's features: two hosts
that print the same digest compute the same float32 features. On the CPU
the chain's mel_spectrogram takes its power from a float64 FFT; the power
stage printed is power_spectrogram's, in float32. Imports no JAX; runs on
the CPU only.
"""

from __future__ import annotations

import hashlib
import platform
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from cough_detector_tpu_torch.config import FeatureConfig  # noqa: E402
from cough_detector_tpu_torch.data import synth  # noqa: E402
from cough_detector_tpu_torch.ops import filters, frontend  # noqa: E402


def sweep_batch() -> np.ndarray:
    return synth.fixture_batch(8, 1.0, seed=3)


def float64_chain(w: np.ndarray, cfg: FeatureConfig) -> dict:
    """The stages in float64: power (B, T, freqs), mel, dB, MFCC (z-normed)
    and the features (B, num_features, T), log-mel and deltas included."""
    half = cfg.n_fft // 2
    x = np.pad(w.astype(np.float64), ((0, 0), (half, half)), mode="reflect")
    idx = np.arange(cfg.num_frames)[:, None] * cfg.hop_length + np.arange(cfg.n_fft)[None]
    spec = np.fft.rfft(x[:, idx] * filters.padded_window(cfg.win_length, cfg.n_fft).astype(np.float64), axis=-1)
    power = spec.real**2 + spec.imag**2
    fb = filters.mel_filterbank(cfg.n_fft // 2 + 1, cfg.n_mels, cfg.sample_rate, cfg.f_min, cfg.f_max)
    mel = power @ fb.astype(np.float64)
    db = 10.0 / np.log(10.0) * np.log(np.maximum(mel, 1e-10))
    mf = db @ filters.dct_matrix(cfg.n_mfcc, cfg.n_mels).astype(np.float64)
    mean = mf.mean(axis=(1, 2), keepdims=True)
    std = np.sqrt(((mf - mean) ** 2).sum(axis=(1, 2), keepdims=True) / (mf.shape[1] * mf.shape[2] - 1))
    mfcc = (mf - mean) / (std + 1e-8)
    top = np.maximum(db, db.max(axis=(1, 2), keepdims=True) - 80.0)
    log_mel = np.clip((top + 80.0) / 80.0, 0.0, 1.0)
    padded = np.concatenate([mfcc[:, :1], mfcc, mfcc[:, -1:]], axis=1)
    deltas = (padded[:, 2:] - padded[:, :-2]) / 2.0
    feats = np.concatenate([log_mel, mfcc, deltas], axis=2).transpose(0, 2, 1)
    return dict(power=power, mel=mel, db=db, mfcc=mfcc, features=feats)


def torch_chain(w: np.ndarray, cfg: FeatureConfig) -> dict:
    """The port's chain, stage by stage, on the CPU."""
    x = torch.from_numpy(w)
    power = frontend.power_spectrogram(x, cfg.n_fft, cfg.hop_length, cfg.win_length)
    mel = frontend.mel_spectrogram(x, cfg)
    return dict(
        power=power.numpy(), mel=mel.numpy(), db=frontend.power_to_db(mel).numpy(),
        mfcc=frontend.mfcc_from_mel(mel, cfg).numpy(), features=frontend.extract_features(x, cfg).numpy(),
    )


def rel(got: np.ndarray, want: np.ndarray) -> float:
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-8))


def deviations(got: dict, want: dict) -> dict:
    """Each stage's max-relative deviation; the mel's also per value, and
    the dB's in dB."""
    out = {k: rel(got[k], want[k]) for k in ("power", "mel", "mfcc", "features")}
    out["mel per value"] = float((np.abs(got["mel"] - want["mel"]) / np.maximum(want["mel"], 1e-10)).max())
    out["dB abs"] = float(np.abs(got["db"] - want["db"]).max())
    return out


def main() -> None:
    torch.set_num_threads(1)
    cfg = FeatureConfig(f_max=8000.0)
    w = sweep_batch()
    got, want = torch_chain(w, cfg), float64_chain(w, cfg)
    cpu = next((line.split(":", 1)[1].strip() for line in Path("/proc/cpuinfo").read_text().splitlines()
                if line.startswith("model name")), platform.processor())
    print(f"host: {cpu}; torch {torch.__version__} (MKL {torch.backends.mkl.is_available()}, CPU capability "
          f"{torch.backends.cpu.get_cpu_capability()}); numpy {np.__version__}", flush=True)
    print("port chain vs float64 at f_max 8 kHz, the sweep batch: "
          + ", ".join(f"{k} {v:.4e}" for k, v in deviations(got, want).items()), flush=True)
    print(f"features digest {hashlib.sha256(np.ascontiguousarray(got['features']).tobytes()).hexdigest()[:32]}",
          flush=True)


if __name__ == "__main__":
    main()
