"""PyTorch port's front end against the JAX package, on the CPU.

The same numpy inputs go through the JAX chain (`extract_features`), the
JAX Pallas kernel in interpret mode, the port's torch chain and the port's
kernel plain version (`frontend_kernel_reference`, what the fused wrapper
runs for CPU tensors). Budget: ≤1e-3 max-relative (docs/PARITY.md).
"""

import jax.numpy as jnp
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
# Configs the epilogue's stage test holds beside CONFIGS: the widest mel
# count the spectral launch takes.
WIDE = {"wide_mels": dict(n_mels=128, f_max=8000.0)}


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
            kw = {**CONFIGS, **WIDE}[name]
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


def test_sine_sweep_stages_vs_float64():
    """The sine-sweep batch of test_sine_sweep_in_band, stage by stage,
    through the port's chain and the JAX jnp chain against a float64 numpy
    chain (tools/host_numerics_probe.py): each is within the budget of the
    float64 features on its own, power and mel within 1e-6 of their
    maxima. Their deviations are float32 FFT rounding in the mel values
    the sweeps leave near zero, which dB and the DCT lift into the MFCCs;
    the two chains round differently there, and where their errors add the
    two may lie past the budget from each other on a host (ROADMAP Queue
    3, deviations)."""
    import importlib.util
    from pathlib import Path

    spec = importlib.util.spec_from_file_location(
        "host_numerics_probe", Path(__file__).resolve().parents[1] / "tools" / "host_numerics_probe.py")
    probe = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(probe)
    cfg, jcfg = FeatureConfig(f_max=8000.0), JaxFeatureConfig(f_max=8000.0)
    w = probe.sweep_batch()
    np.testing.assert_array_equal(w, synth.fixture_batch(8, 1.0, seed=3))
    want = probe.float64_chain(w, cfg)
    x = jnp.asarray(w)
    jax_mel = np.asarray(jax_frontend.mel_spectrogram(x, jcfg))
    jax_stages = dict(
        power=np.asarray(jax_frontend.power_spectrogram(x, cfg.n_fft, cfg.hop_length, cfg.win_length)),
        mel=jax_mel, db=np.asarray(jax_frontend.power_to_db(jax_mel)), mfcc=np.asarray(jax_frontend.mfcc(x, jcfg)),
        features=np.asarray(jax_frontend.extract_features(x, jcfg)),
    )
    for name, got in (("port", probe.torch_chain(w, cfg)), ("jax", jax_stages)):
        dev = probe.deviations(got, want)
        print(name, dev)
        assert dev["power"] < 1e-6 and dev["mel"] < 1e-6, (name, dev)
        assert dev["mfcc"] < TOL and dev["features"] < TOL, (name, dev)


@pytest.mark.parametrize(
    "kw, n, exc",
    [
        (dict(use_mfcc=False), 16000, ValueError),
        ({}, 12000, ValueError),
        (dict(use_spectral_contrast=True), 16000, None),
    ],
)
def test_unsupported_config_raises(kw, n, exc):
    """Where the JAX launcher falls back to the jnp chain, the port's fused
    wrapper raises. A contrast config runs the hybrid, as the JAX
    launcher's does: on CPU tensors it equals extract_features and
    launches nothing."""
    w = np.zeros((2, n), np.float32)
    w[:, ::97] = 0.5
    jax_out = np.asarray(jax_fused(w, JaxFeatureConfig(**kw), interpret=True))
    assert np.isfinite(jax_out).all()
    before = _launches()
    if exc is None:
        got = frontend_kernel.extract_features_fused(torch.from_numpy(w), FeatureConfig(**kw))
        want = frontend.extract_features(torch.from_numpy(w), FeatureConfig(**kw))
        assert got.shape == want.shape == (2, 97, 101)
        assert _rel(got.numpy(), want.numpy()) < TOL
        assert _rel(got.numpy(), jax_out) < TOL
    else:
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
        (dict(use_spectral_contrast=True), (2, 64, 101), ValueError),
    ],
)
def test_epilogue_rejects_what_it_does_not_cover(kw, shape, exc):
    """Launch B's wrapper takes only a (B, n_mels, num_frames) power mel of
    a config with MFCCs and without spectral contrast (the launch computes
    no contrast rows; the launcher appends them), and launches nothing
    otherwise."""
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


@pytest.mark.parametrize(
    "name",
    [
        "shipped", "pcen", "pre_emphasis_delta_delta", "narrow_mels", "n_fft_256",
        "full_band", "wide_mels",
    ],
)
def test_mel_epilogue_stage_vs_jax(jax_outputs, name):
    """Launch B's wrapper on CPU tensors (its plain version), fed JAX's own
    power mel, gives JAX's feature image: 32 to 128 mels, 101 and 201
    frames, PCEN and delta-deltas."""
    w, jnp_out, _ = jax_outputs(name)
    kw = {**CONFIGS, **WIDE}[name]
    mel = _jax_power_mel(w, JaxFeatureConfig(**kw))
    got = frontend_kernel.mel_epilogue_fused(
        torch.from_numpy(np.ascontiguousarray(mel)), FeatureConfig(**kw)
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


def _split_features(w: np.ndarray, cfg: FeatureConfig, passes: int = 3) -> np.ndarray:
    """Features from launch A's TF32 arithmetic (power_mel_split_reference)
    through launch B's plain version."""
    mel = frontend_kernel.power_mel_split_reference(torch.from_numpy(w), cfg, passes)
    return frontend_kernel.mel_epilogue_reference(mel, cfg).numpy()


@pytest.mark.parametrize("target", ["jnp", "pallas_interpret"])
@pytest.mark.parametrize("name", list(CONFIGS))
def test_split_model_vs_jax(jax_outputs, name, target):
    """The CUDA spectral launch's 3xTF32 arithmetic holds the budget against
    the JAX jnp chain and the Pallas kernel on the parity clips."""
    w, jnp_out, pallas_out = jax_outputs(name)
    want = jnp_out if target == "jnp" else pallas_out
    got = _split_features(w, FeatureConfig(**CONFIGS[name]))
    assert got.shape == want.shape
    assert _rel(got, want) < TOL


def test_split_model_sine_sweeps_in_band():
    """The fixture batch with its sine sweeps, in band at f_max = 8 kHz: the
    hardest input for the split (near-empty mel bands after the log)."""
    w = synth.fixture_batch(8, 1.0, seed=3)
    jcfg = JaxFeatureConfig(f_max=8000.0)
    got = _split_features(w, FeatureConfig(f_max=8000.0))
    assert _rel(got, np.asarray(jax_frontend.extract_features(w, jcfg))) < TOL
    assert _rel(got, np.asarray(jax_fused(w, jcfg, interpret=True))) < TOL


@pytest.mark.parametrize("name", list(CONFIGS))
def test_one_pass_tf32_breaks_the_budget(jax_outputs, name):
    """Why the spectral launch splits its operands: a single TF32 product
    (11 significant bits) misses the budget on the parity clips of every
    config, because the DFT cancels."""
    w, jnp_out, _ = jax_outputs(name)
    assert _rel(_split_features(w, FeatureConfig(**CONFIGS[name]), passes=1), jnp_out) > TOL


def test_tf32_round_is_cvt_rna():
    """Round to nearest, ties away from zero, at 10 mantissa bits; the
    hi + lo split rebuilds x to 2^-21 of it."""
    ulp = 2.0**-10
    x = torch.tensor(
        [1.0, 1 + ulp / 2, 1 + ulp / 2 - 2.0**-23, -(1 + ulp / 2), 1 + 1.5 * ulp, 3.0e-5],
        dtype=torch.float32,
    )
    got = frontend_kernel.tf32_round(x)
    want = [1.0, 1 + ulp, 1.0, -(1 + ulp), 1 + 2 * ulp]
    assert got[:5].tolist() == want
    assert (got.view(torch.int32) & 0x1FFF == 0).all()
    v = torch.from_numpy(np.random.default_rng(0).standard_normal(1000).astype(np.float32))
    hi = frontend_kernel.tf32_round(v)
    lo = frontend_kernel.tf32_round(v - hi)
    assert ((hi + lo - v).abs() <= v.abs() * 2.0**-21).all()


@pytest.mark.parametrize("name", ["shipped", "full_band", "narrow_mels", "n_fft_256"])
def test_table_stream_holds_the_plain_tables(name):
    """Launch A's chunk stream of hi/lo tiles, decoded the way the kernel
    reads it, gives the windowed DFT (cos and -sin interleaved bin by bin,
    zero past n_used) and the filterbank (zero past n_used and n_mels)."""
    cfg = FeatureConfig(**CONFIGS[name])
    k = frontend_kernel._constants(cfg, torch.device("cpu"))
    taps, ks, n = k.j1 - k.j0, k.kpad // 8, 8 * k.mel_tiles
    # Per pass: ks DFT chunks, then the filterbank's 16 k-steps; each k-step
    # a hi and a lo tile of column groups x 2 row groups x 8 columns x 4 rows.
    passes = k.table.reshape(-1, (ks + n // 16) * 4096)
    v = passes[:, : ks * 4096].reshape(-1, ks, 2, 32, 2, 8, 4)
    dft = (v[:, :, 0] + v[:, :, 1]).permute(1, 3, 5, 0, 2, 4).reshape(k.kpad, -1)
    np.testing.assert_allclose(dft[:taps, 0 : 2 * k.n_used : 2], k.cos[k.j0 : k.j1], atol=2e-7)
    np.testing.assert_allclose(dft[:taps, 1 : 2 * k.n_used : 2], k.sin[k.j0 : k.j1], atol=2e-7)
    assert not dft[taps:].any() and not dft[:, 2 * k.n_used :].any()
    v = passes[:, ks * 4096 :].reshape(-1, 16, 2, n // 8, 2, 8, 4)
    fb = (v[:, :, 0] + v[:, :, 1]).permute(0, 1, 3, 5, 2, 4).reshape(-1, n)
    np.testing.assert_allclose(fb[: k.n_used, : cfg.n_mels], k.fb, atol=2e-7)
    assert not fb[k.n_used :].any() and not fb[:, cfg.n_mels :].any()


def test_wide_mel_config_runs_plain_on_cpu():
    """More mels than one mel group of the spectral kernel (128): its
    tables are built in two groups of 80 mels (in 16 n-tiles of 8), and a
    CPU tensor runs the plain version."""
    cfg = FeatureConfig(n_mels=160, f_max=8000.0)
    w = torch.from_numpy(_clips(2, seed=7))
    got = frontend_kernel.power_mel_fused(w, cfg)
    assert got.shape == (2, 160, cfg.num_frames)
    assert torch.equal(got, frontend_kernel.power_mel_reference(w, cfg))
    k = frontend_kernel._constants(cfg, torch.device("cpu"))
    assert (k.mel_tiles, k.n_groups) == frontend_kernel.mel_groups(160) == (16, 2)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_card_supports_the_parity_configs(name):
    """Both launches take every parity config on the card in their first
    plans (the span staged, one block a clip), as far as the config alone
    can tell (no library, no card); the route is the JAX launcher's."""
    cfg = FeatureConfig(**CONFIGS[name])
    assert frontend_kernel.kernel_supports(cfg, cfg.segment_samples)
    assert not frontend_kernel.kernel_supports(cfg, cfg.segment_samples - 1)
    kpad = frontend_kernel._support(cfg)[2]
    assert frontend_kernel.spectral_staged(cfg.hop_length, kpad)
    assert frontend_kernel.epilogue_blocks(cfg) == 1


@pytest.mark.parametrize(
    "kw", [dict(n_mels=160, f_max=8000.0), dict(hop_length=4)], ids=["160_mels", "hop_4"]
)
def test_card_refuses_what_the_spectral_launch_cannot_take(kw):
    """The JAX launcher runs its Pallas kernel for these configs, and the
    spectral launch now takes them too, so the card refuses nothing: 160
    mels in two mel groups, a hop of 4 with no bank skew (32 row tiles of
    its 4001 frames), each with its span staged. The card route is
    kernel_supports alone (card_supports is gone)."""
    cfg = FeatureConfig(**kw)
    assert frontend_kernel.kernel_supports(cfg, cfg.segment_samples)
    assert not hasattr(frontend_kernel, "card_supports")
    kpad = frontend_kernel._support(cfg)[2]
    assert frontend_kernel.spectral_staged(cfg.hop_length, kpad)
    groups = frontend_kernel.mel_groups(cfg.n_mels)[1]
    assert frontend_kernel.spectral_grid(3, cfg.num_frames, groups) == 3 * -(-cfg.num_frames // 128) * groups


def test_fast_runs_a_wide_mel_config_vs_jax():
    """extract_features_fast with 160 mels (more than the spectral launch
    takes) matches the JAX chain."""
    cfg = FeatureConfig(n_mels=160, f_max=8000.0)
    w = _clips(3, seed=9)
    before = _launches()
    got = frontend.extract_features_fast(w, cfg, device="cpu").numpy()
    want = np.asarray(
        jax_frontend.extract_features(w, JaxFeatureConfig(n_mels=160, f_max=8000.0))
    )
    assert got.shape == want.shape == (3, cfg.num_features, cfg.num_frames)
    assert _rel(got, want) < TOL
    assert _launches() == before


def test_epilogue_smem_at_the_shipped_config():
    """Launch B's shared memory (its Python mirror) stays under the 48 KB a
    block gets without opting in, so many clips share an SM."""
    assert frontend_kernel.epilogue_smem_bytes(FeatureConfig()) < 48 * 1024


_BIG = dict(n_mels=128, f_max=8000.0, n_fft=256, win_length=200, hop_length=80, n_mfcc=20)


@pytest.mark.parametrize(
    "kw",
    [*CONFIGS.values(), _BIG, {**_BIG, "use_pcen": True},
     {**_BIG, "use_pcen": True, "use_delta_delta": True}],
    ids=[*CONFIGS, "128x201x20", "128x201x20_pcen", "128x201x20_pcen_delta_delta"],
)
def test_epilogue_smem_fits_the_card(kw):
    """Launch B's shared memory never limits a config the spectral launch
    takes: the parity configs and 128 mels x 201 frames x 20 MFCCs (the
    widest of each), with and without PCEN, fit the card's 232,448 B."""
    cfg = FeatureConfig(**kw)
    assert cfg.num_frames in (101, 201)
    assert frontend_kernel.epilogue_smem_bytes(cfg) <= 232448
    assert frontend_kernel.epilogue_blocks(cfg) == 1
