"""PyTorch port's front end against the JAX package, on the CPU.

The same numpy inputs go through the JAX chain (`extract_features`), the
JAX Pallas kernel in interpret mode, the port's torch chain and the port's
kernel plain version (`frontend_kernel_reference`, what the fused wrapper
runs for CPU tensors). Budget: ≤1e-3 max-relative (docs/PARITY.md).
"""

import numpy as np
import pytest
import torch

from cough_detector_tpu.config import FeatureConfig as JaxFeatureConfig
from cough_detector_tpu.data import synth
from cough_detector_tpu.ops import frontend as jax_frontend
from cough_detector_tpu.ops.pallas.frontend_kernel import (
    extract_features_fused as jax_fused,
)
from cough_detector_tpu_torch.config import FeatureConfig
from cough_detector_tpu_torch.ops import frontend, frontend_kernel
from test_torch_models import one_torch_thread  # noqa: F401

TOL = 1e-3

CONFIGS = {
    "shipped": {},
    "pcen": dict(use_pcen=True),
    "pre_emphasis_delta_delta": dict(use_pre_emphasis=True, use_delta_delta=True),
    "narrow_mels": dict(n_mels=32, n_mfcc=8),
    "full_band": dict(f_max=8000.0),
    "n_fft_256": dict(n_fft=256, win_length=200, hop_length=80),
}


def _launches():
    return frontend_kernel.SPECTRAL_LAUNCHES, frontend_kernel.EPILOGUE_LAUNCHES


def _rel(got, want) -> float:
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-8))


def _clips(n: int, seed: int, pcen: bool = False) -> np.ndarray:
    """n clips of fixture_batch's coughs, non-coughs and impulses.

    Its sine sweeps are left out: they run to 7 kHz, so past f_max = 4 kHz
    their frames reach every mel band only through window leakage, those
    frames' MFCCs are float32 FFT rounding noise, and the JAX jnp path is
    itself 1.1-1.35e-3 from the torch golden there. PCEN batches hold only
    coughs and non-coughs: its per-clip min-max on a single impulse
    normalizes float noise (tests/test_pallas_kernel.py, TestPCENInKernel).
    """
    if pcen:
        clips = [
            (synth.synthetic_cough if i % 2 == 0 else synth.synthetic_non_cough)(
                seed + i, 1.0
            )
            for i in range(n)
        ]
        return np.stack(clips)
    batch = synth.fixture_batch(2 * n, 1.0, seed=seed)
    return batch[[i for i in range(2 * n) if i % 4 != 2][:n]]


@pytest.fixture(scope="module")
def jax_outputs():
    """Per config name: (input batch, JAX jnp chain, JAX Pallas interpret)."""
    cache = {}

    def get(name):
        if name not in cache:
            kw = CONFIGS[name]
            w = _clips(9, seed=4, pcen=kw.get("use_pcen", False))
            cfg = JaxFeatureConfig(**kw)
            cache[name] = (
                w,
                np.asarray(jax_frontend.make_feature_fn(cfg)(w)),
                np.asarray(jax_fused(w, cfg, interpret=True)),
            )
        return cache[name]

    return get


def _port(impl: str, w: np.ndarray, cfg: FeatureConfig) -> np.ndarray:
    x = torch.from_numpy(w)
    if impl == "chain":
        return frontend.extract_features(x, cfg).numpy()
    return frontend_kernel.extract_features_fused(x, cfg).numpy()


@pytest.mark.parametrize("impl", ["chain", "kernel_plain"])
@pytest.mark.parametrize("name", list(CONFIGS))
def test_config_parity_vs_jax(jax_outputs, name, impl):
    w, jnp_out, pallas_out = jax_outputs(name)
    got = _port(impl, w, FeatureConfig(**CONFIGS[name]))
    assert got.shape == jnp_out.shape == pallas_out.shape
    assert _rel(got, jnp_out) < TOL
    assert _rel(got, pallas_out) < TOL


@pytest.mark.parametrize("b", [1, 5, 9, 17])
def test_batch_sizes_vs_pallas_interpret(jax_outputs, b):
    """Batches that are not a multiple of the Pallas tile (16): the JAX
    launcher pads them; the CUDA kernel takes any B."""
    if b <= 9:
        w, _, want = jax_outputs("shipped")
    else:
        w = _clips(b, seed=8)
        want = np.asarray(jax_fused(w, JaxFeatureConfig(), interpret=True))
    got = _port("kernel_plain", w[:b], FeatureConfig())
    assert got.shape == (b, 90, 101)
    assert _rel(got, want[:b]) < TOL
    chain = _port("chain", w[:b], FeatureConfig())
    assert _rel(chain, want[:b]) < TOL


def test_sine_sweep_in_band():
    """With f_max = 8 kHz the sweeps stay inside the mel bands and the full
    fixture batch holds the budget."""
    w = synth.fixture_batch(8, 1.0, seed=3)
    want = np.asarray(jax_frontend.extract_features(w, JaxFeatureConfig(f_max=8000.0)))
    cfg = FeatureConfig(f_max=8000.0)
    assert _rel(_port("chain", w, cfg), want) < TOL
    assert _rel(_port("kernel_plain", w, cfg), want) < TOL


@pytest.mark.parametrize(
    "kw, n, exc",
    [
        (dict(use_mfcc=False), 16000, ValueError),
        ({}, 12000, ValueError),
        (dict(use_spectral_contrast=True), 16000, NotImplementedError),
    ],
)
def test_unsupported_config_raises(kw, n, exc):
    """Where the JAX launcher falls back to the jnp chain (or runs its
    contrast hybrid), the port's fused wrapper raises."""
    w = np.zeros((2, n), np.float32)
    w[:, ::97] = 0.5
    jax_out = np.asarray(jax_fused(w, JaxFeatureConfig(**kw), interpret=True))
    assert np.isfinite(jax_out).all()
    before = _launches()
    with pytest.raises(exc):
        frontend_kernel.extract_features_fused(
            torch.from_numpy(w), FeatureConfig(**kw)
        )
    assert _launches() == before


@pytest.mark.parametrize(
    "kw, shape, exc",
    [
        (dict(use_mfcc=False), (2, 64, 101), ValueError),
        ({}, (2, 101, 64), ValueError),
        ({}, (2, 64, 90), ValueError),
        (dict(use_spectral_contrast=True), (2, 64, 101), NotImplementedError),
    ],
)
def test_epilogue_rejects_what_it_does_not_cover(kw, shape, exc):
    """Launch B's wrapper takes only a (B, n_mels, num_frames) power mel of
    a config with MFCCs, and launches nothing otherwise."""
    before = _launches()
    with pytest.raises(exc):
        frontend_kernel.mel_epilogue_fused(torch.ones(shape), FeatureConfig(**kw))
    assert _launches() == before


def _jax_power_mel(w: np.ndarray, cfg: JaxFeatureConfig) -> np.ndarray:
    """JAX's power mel of the (pre-emphasized) clips, as (B, n_mels, T)."""
    if cfg.use_pre_emphasis:
        w = np.asarray(jax_frontend.pre_emphasis(w, cfg.pre_emphasis_coef))
    return np.asarray(jax_frontend.mel_spectrogram(w, cfg)).transpose(0, 2, 1)


@pytest.mark.parametrize(
    "name", ["shipped", "pre_emphasis_delta_delta", "full_band", "n_fft_256"]
)
def test_power_mel_stage_vs_jax(name):
    """Launch A's wrapper on CPU tensors (its plain version) against the JAX
    power mel spectrogram of the same clips."""
    w = _clips(3, seed=6)
    cfg = FeatureConfig(**CONFIGS[name])
    want = _jax_power_mel(w, JaxFeatureConfig(**CONFIGS[name]))
    got = frontend_kernel.power_mel_fused(torch.from_numpy(w), cfg).numpy()
    assert got.shape == want.shape == (3, cfg.n_mels, cfg.num_frames)
    assert _rel(got, want) < TOL


@pytest.mark.parametrize("name", ["shipped", "pcen", "pre_emphasis_delta_delta", "narrow_mels"])
def test_mel_epilogue_stage_vs_jax(jax_outputs, name):
    """Launch B's wrapper on CPU tensors (its plain version), fed JAX's own
    power mel, gives JAX's feature image."""
    w, jnp_out, _ = jax_outputs(name)
    mel = _jax_power_mel(w, JaxFeatureConfig(**CONFIGS[name]))
    got = frontend_kernel.mel_epilogue_fused(
        torch.from_numpy(np.ascontiguousarray(mel)), FeatureConfig(**CONFIGS[name])
    ).numpy()
    assert got.shape == jnp_out.shape
    assert _rel(got, jnp_out) < TOL


def test_no_mfcc_config_routes_to_chain():
    """extract_features_fast runs the chain for configs the kernel does not
    cover, as the JAX launcher does."""
    cfg = FeatureConfig(use_mfcc=False)
    w = _clips(3, seed=1)
    got = frontend.extract_features_fast(w, cfg, device="cpu").numpy()
    want = np.asarray(jax_frontend.extract_features(w, JaxFeatureConfig(use_mfcc=False)))
    assert got.shape == (3, 64, 101)
    assert _rel(got, want) < TOL


def test_fast_on_cpu_is_plain_and_launches_nothing():
    w = _clips(2, seed=2)
    before = _launches()
    fast = frontend.extract_features_fast(w, FeatureConfig(), device="cpu")
    chain = frontend.extract_features(torch.from_numpy(w), FeatureConfig())
    assert torch.equal(fast, chain)
    assert _launches() == before


def test_fast_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present; the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        frontend.extract_features_fast(np.zeros((1, 16000), np.float32), FeatureConfig())


@pytest.mark.parametrize("n", [15999, 16000, 16001, 20000])
def test_process_pad_or_trim_vs_jax(n):
    """peak normalize → center pad/trim (odd pads included) → features."""
    rng = np.random.default_rng(n)
    w = (rng.standard_normal((2, n)) * 0.3).astype(np.float32)
    want = np.asarray(jax_frontend.process(w, JaxFeatureConfig()))
    got = frontend.process(torch.from_numpy(w), FeatureConfig()).numpy()
    assert _rel(got, want) < TOL


def test_waveform_stages_vs_jax():
    rng = np.random.default_rng(5)
    stereo = rng.standard_normal((2, 2, 1000)).astype(np.float32)
    mono = frontend.to_mono(torch.from_numpy(stereo)).numpy()
    np.testing.assert_allclose(mono, np.asarray(jax_frontend.to_mono(stereo)), atol=1e-7)
    x = stereo[:, 0]
    x[1] = 0.0  # a silent clip passes peak normalization unchanged
    np.testing.assert_allclose(
        frontend.peak_normalize(torch.from_numpy(x)).numpy(),
        np.asarray(jax_frontend.peak_normalize(x)), atol=1e-7,
    )
    np.testing.assert_allclose(
        frontend.pre_emphasis(torch.from_numpy(x), 0.97).numpy(),
        np.asarray(jax_frontend.pre_emphasis(x, 0.97)), atol=1e-6,
    )
