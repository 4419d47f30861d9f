"""PyTorch port's spectral contrast and the fused launcher's contrast hybrid
against the JAX package, on the CPU.

The same numpy clips (fixture_batch's coughs, non-coughs and impulses; its
sine sweeps are left out, as in test_torch_frontend.py) go through the JAX
`spectral_contrast` and the port's, for both STFT formulations ("fft",
"gemm") and both tail selections ("select", "rank"). Budget: 1e-3
max-relative. Measured on an x86 CPU: 9.3e-7 (fft) and 9.7e-7
(gemm) for either tail; the all-flags feature image 9.3e-7; the hybrid's
CPU path 9.7e-7 from the plain chain.
"""

import dataclasses

import numpy as np
import pytest
import torch

from cough_detector_tpu.config import FeatureConfig as JaxFeatureConfig
from cough_detector_tpu.ops import frontend as jax_frontend
from cough_detector_tpu.ops.pallas.frontend_kernel import (
    extract_features_fused as jax_fused,
)
from cough_detector_tpu_torch.config import FeatureConfig
from cough_detector_tpu_torch.ops import frontend, frontend_kernel
from test_torch_frontend import _clips, _rel
from test_torch_models import one_torch_thread  # noqa: F401

TOL = 1e-3
CONTRAST = dict(use_spectral_contrast=True)
ALL_FLAGS = dict(use_pcen=True, use_pre_emphasis=True, use_delta_delta=True, use_spectral_contrast=True)


@pytest.fixture(scope="module")
def clips():
    return _clips(9, seed=4)


def _port_contrast(w, kw=None, **opts):
    return frontend.spectral_contrast(torch.from_numpy(w), FeatureConfig(**(kw or {})), **opts).numpy()


def _jax_contrast(w, kw=None, **opts):
    return np.asarray(jax_frontend.spectral_contrast(w, JaxFeatureConfig(**(kw or {})), **opts))


@pytest.mark.parametrize("tails", ["select", "rank"])
@pytest.mark.parametrize("method", ["fft", "gemm"])
def test_spectral_contrast_vs_jax(clips, method, tails):
    got = _port_contrast(clips, method=method, tails=tails)
    want = _jax_contrast(clips, method=method, tails=tails)
    assert got.shape == want.shape == (9, 101, 7)
    assert _rel(got, want) < TOL


@pytest.mark.parametrize("tails", ["auto", "bogus"])
def test_tails_other_than_rank_select(clips, tails):
    """"auto", and any value other than "rank", is the selection, as in JAX."""
    np.testing.assert_array_equal(
        _port_contrast(clips[:3], tails=tails), _port_contrast(clips[:3], tails="select")
    )


def test_band_edges_and_the_single_bin_band(clips):
    """The log-spaced edges truncate as numpy's int64 cast does; band 0 is
    one bin and contributes 0 before the z-norm, so after it the row is one
    value per clip."""
    edges = frontend.contrast_band_edges(257, 6)
    assert edges.tolist() == [1, 2, 4, 10, 23, 52, 116, 257]
    got = _port_contrast(clips)
    row0 = got[:, :, 0]
    np.testing.assert_array_equal(row0, np.broadcast_to(row0[:, :1], row0.shape))
    assert _rel(row0, _jax_contrast(clips)[:, :, 0]) < TOL


def test_silence_is_finite_and_its_centroid_is_zero():
    """A silent clip: every row is 0 before the z-norm, whose std is then 0,
    and 0 / (0 + 1e-8) is 0. A clip silent in its first half: the centroid
    of its silent frames is 0, not torchaudio's 0/0, and the rows stay
    finite and equal to JAX's."""
    w = np.zeros((2, 16000), np.float32)
    w[1, 8000:] = np.random.default_rng(0).standard_normal(8000).astype(np.float32) * 0.1
    for method in ("fft", "gemm"):
        got = _port_contrast(w, method=method)
        want = _jax_contrast(w, method=method)
        assert np.isfinite(got).all()
        np.testing.assert_array_equal(got[0], 0.0)
        assert _rel(got[1], want[1]) < TOL


@pytest.mark.parametrize("kind", ["random", "ties", "sorted", "reverse", "constant", "zeros"])
def test_tail_sums_rank_exact(kind):
    """The stable-rank tail sums against a float64 sort oracle on
    adversarial bands, as the JAX package's own test holds its copy."""
    rng = np.random.default_rng(3)
    w = 23
    band = {
        "random": rng.standard_normal((4, 5, w)),
        "ties": rng.integers(0, 3, (4, 5, w)).astype(np.float64),
        "sorted": np.broadcast_to(np.arange(w, dtype=np.float64), (4, 5, w)),
        "reverse": np.broadcast_to(np.arange(w, 0, -1, dtype=np.float64), (4, 5, w)),
        "constant": np.full((4, 5, w), 0.5),
        "zeros": np.zeros((4, 5, w)),
    }[kind].astype(np.float32)
    n_top, n_bot = 5, 4
    top, bot = frontend._tail_sums_rank(torch.from_numpy(band.copy()), n_top, n_bot)
    srt = np.sort(band.astype(np.float64), axis=-1)
    np.testing.assert_allclose(top.numpy(), srt[..., -n_top:].sum(-1), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(bot.numpy(), srt[..., :n_bot].sum(-1), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("name, kw", [("contrast", CONTRAST), ("all_flags", ALL_FLAGS)])
def test_extract_features_with_contrast_vs_jax(clips, name, kw):
    """The plain chain's feature image with the contrast rows stacked last:
    (97, 101) for the shipped config with contrast, (110, 101) with every
    flag."""
    want = np.asarray(jax_frontend.extract_features(clips, JaxFeatureConfig(**kw)))
    got = frontend.extract_features(torch.from_numpy(clips), FeatureConfig(**kw)).numpy()
    assert got.shape == want.shape == (9, FeatureConfig(**kw).num_features, 101)
    assert _rel(got, want) < TOL


@pytest.mark.parametrize("name, kw", [("contrast", CONTRAST), ("all_flags", ALL_FLAGS)])
def test_hybrid_cpu_path_vs_chain_and_jax_launcher(clips, name, kw):
    """The fused launcher on CPU tensors runs the pair's plain versions on
    the config without contrast and appends the gemm contrast rows: equal
    to the plain chain and to the JAX launcher's hybrid (Pallas in
    interpret mode), and it launches nothing on the CPU."""
    cfg = FeatureConfig(**kw)
    before = (frontend_kernel.SPECTRAL_LAUNCHES, frontend_kernel.EPILOGUE_LAUNCHES)
    got = frontend_kernel.extract_features_fused(torch.from_numpy(clips), cfg).numpy()
    assert (frontend_kernel.SPECTRAL_LAUNCHES, frontend_kernel.EPILOGUE_LAUNCHES) == before
    chain = frontend.extract_features(torch.from_numpy(clips), cfg).numpy()
    jax_hybrid = np.asarray(jax_fused(clips, JaxFeatureConfig(**kw), interpret=True))
    assert got.shape == chain.shape == jax_hybrid.shape
    assert _rel(got, chain) < TOL
    assert _rel(got, jax_hybrid) < TOL
    base = dataclasses.replace(cfg, use_spectral_contrast=False)
    np.testing.assert_array_equal(
        got[:, : base.num_features],
        frontend_kernel.extract_features_fused(torch.from_numpy(clips), base).numpy(),
    )


def test_card_route_takes_a_contrast_config_with_its_base():
    """The card route (`kernel_supports`) takes a contrast config exactly
    when it takes the config without contrast; without MFCCs it does not,
    and extract_features_fast runs the plain chain for it."""
    for kw in (dict(), dict(n_mels=160, f_max=8000.0), dict(use_mfcc=False)):
        base = FeatureConfig(**kw)
        cfg = dataclasses.replace(base, use_spectral_contrast=True)
        assert frontend_kernel.kernel_supports(cfg, 16000) == frontend_kernel.kernel_supports(base, 16000)
    assert not frontend_kernel.kernel_supports(FeatureConfig(use_mfcc=False, **CONTRAST), 16000)
    w = _clips(2, seed=9)
    cfg = FeatureConfig(use_mfcc=False, **CONTRAST)
    got = frontend.extract_features_fast(w, cfg, device="cpu").numpy()
    want = np.asarray(jax_frontend.extract_features(w, JaxFeatureConfig(use_mfcc=False, **CONTRAST)))
    assert got.shape == (2, 64 + 7, 101) and _rel(got, want) < TOL


def test_featurize_cli_takes_a_contrast_config(tmp_path, capsys):
    """cli.featurize --config (a config JSON) writes the 97x101 features of
    that config, within 1e-3 of the JAX chain on the same decoded clips."""
    import json

    from cough_detector_tpu_torch.cli import featurize
    from cough_detector_tpu_torch.config import Config
    from cough_detector_tpu_torch.data import BatchLoader, CoughDataset, audio_io, synth

    data = tmp_path / "clips"
    for sub, gen in (("cough", synth.synthetic_cough), ("non_cough", synth.synthetic_non_cough)):
        (data / sub).mkdir(parents=True)
        for i in range(3):
            audio_io.write_wav(data / sub / f"{i}.wav", gen(40 + i, 1.2), 16000)
    (tmp_path / "contrast.json").write_text(Config(features=FeatureConfig(**CONTRAST)).to_json())
    featurize.main(["--data-dir", str(data), "--output", str(tmp_path / "f.npz"), "--batch-size", "6",
                    "--num-workers", "2", "--config", str(tmp_path / "contrast.json"), "--device", "cpu"])
    report = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert report["feature_shape"] == [97, 101]
    waves, _ = next(iter(BatchLoader(CoughDataset(str(data)), 6, FeatureConfig(**CONTRAST), num_workers=2)))
    want = np.asarray(jax_frontend.process(waves, JaxFeatureConfig(**CONTRAST)))
    assert _rel(np.load(tmp_path / "f.npz")["features"], want) < TOL
