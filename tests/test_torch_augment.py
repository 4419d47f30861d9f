"""PyTorch port's augmentation against the JAX package, on the CPU.

Each op's apply part, fed the draws that the JAX op's key chain makes for
the same key (replayed here with jax.random), must reproduce the JAX op's
output within 1e-6. The port's own draws are checked by semantics: gate
rates, SNR, gain and mask bands, p = 0, the same (seed, epoch, step) giving
the same draws, and MixUp never mixing a real row with padding.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cough_detector_tpu.augment import spec as jspec
from cough_detector_tpu.augment import waveform as jwave
from cough_detector_tpu_torch.augment import spec, waveform
from cough_detector_tpu_torch.augment.spec import MaskDraws
from cough_detector_tpu_torch.augment.waveform import FileNoiseDraws, NoiseDraws
from cough_detector_tpu_torch.data import synth
from cough_detector_tpu_torch.train import StepRandom
from test_torch_models import one_torch_thread  # noqa: F401

TOL = 1e-6
P = 0.6  # both gated and ungated clips in a batch of 8


@pytest.fixture(scope="module")
def waves() -> np.ndarray:
    return synth.fixture_batch(n_clips=8, seed=5).astype(np.float32)


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x))


def _close(got: torch.Tensor, want) -> None:
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=TOL)


def _gate(key, b, p=P):
    return jax.random.uniform(key, (b,)) <= p


def test_time_shift_apply_matches_jax(waves):
    key = jax.random.PRNGKey(1)
    b, s = waves.shape
    k_gate, k_amt = jax.random.split(key)
    amt = jnp.round(jax.random.uniform(k_amt, (b,), minval=-0.2, maxval=0.2) * s)
    amt = jnp.where(_gate(k_gate, b), amt.astype(jnp.int32), 0)
    assert 0 < int(jnp.sum(amt != 0)) < b
    got = waveform.time_shift_apply(_t(waves), _t(amt).long())
    _close(got, jwave.time_shift(jnp.asarray(waves), key, P))


def test_volume_apply_matches_jax(waves):
    key = jax.random.PRNGKey(2)
    b = waves.shape[0]
    k_gate, k_gain = jax.random.split(key)
    gain = jax.random.uniform(k_gain, (b,), minval=0.7, maxval=1.3)
    gain = jnp.where(_gate(k_gate, b), gain, 1.0)
    got = waveform.volume_apply(_t(waves), _t(gain))
    _close(got, jwave.volume_perturbation(jnp.asarray(waves), key, P))


def test_gaussian_noise_apply_matches_jax(waves):
    key = jax.random.PRNGKey(3)
    b, s = waves.shape
    k_gate, k_snr, k_noise = jax.random.split(key, 3)
    draws = NoiseDraws(
        _t(_gate(k_gate, b)),
        _t(jax.random.uniform(k_snr, (b,), minval=10.0, maxval=30.0)),
        _t(jax.random.normal(k_noise, (b, s))),
    )
    got = waveform.gaussian_noise_apply(_t(waves), draws)
    _close(got, jwave.add_gaussian_noise(jnp.asarray(waves), key, P))


def test_file_noise_apply_matches_jax(waves):
    key = jax.random.PRNGKey(4)
    b, s = waves.shape
    bank = np.random.default_rng(0).standard_normal((5, s + 3000)).astype(np.float32) * 0.1
    bank[2] = 0.0  # a silent bank clip adds nothing
    k_gate, k_pick, k_snr, k_start = jax.random.split(key, 4)
    draws = FileNoiseDraws(
        _t(_gate(k_gate, b)),
        _t(jax.random.randint(k_pick, (b,), 0, 5)).long(),
        _t(jax.random.randint(k_start, (b,), 0, 3001)).long(),
        _t(jax.random.uniform(k_snr, (b,), minval=5.0, maxval=20.0)),
    )
    got = waveform.file_noise_apply(_t(waves), draws, _t(bank))
    _close(got, jwave.add_file_noise(jnp.asarray(waves), key, P, jnp.asarray(bank)))


def _jax_bands(key, n, b, param, dim):
    starts, widths = [], []
    for _ in range(n):
        key, k = jax.random.split(key)
        k_w, k_s = jax.random.split(k)
        width = jax.random.uniform(k_w, (b,)) * param
        start = jax.random.uniform(k_s, (b,)) * (dim - width)
        starts.append(np.asarray(start.astype(jnp.int32)))
        widths.append(np.asarray(width.astype(jnp.int32)))
    return key, _t(np.stack(starts)).long(), _t(np.stack(widths)).long()


@pytest.mark.parametrize("n_masks", [(2, 2), (1, 3)])
def test_spec_augment_apply_matches_jax(n_masks):
    key = jax.random.PRNGKey(5)
    feats = np.random.default_rng(1).standard_normal((8, 90, 101)).astype(np.float32)
    n_f, n_t = n_masks
    k_gate, k = jax.random.split(key)
    k, f_start, f_width = _jax_bands(k, n_f, 8, 8, 90)
    _, t_start, t_width = _jax_bands(k, n_t, 8, 15, 101)
    draws = MaskDraws(_t(_gate(k_gate, 8)), f_start, f_width, t_start, t_width)
    want = jspec.spec_augment(
        jnp.asarray(feats), key, freq_mask_param=8, time_mask_param=15,
        n_freq_masks=n_f, n_time_masks=n_t, p=P,
    )
    _close(spec.spec_augment_apply(_t(feats), draws), want)


@pytest.mark.parametrize("masked", [False, True])
def test_mixup_apply_matches_jax(masked):
    key = jax.random.PRNGKey(6)
    rng = np.random.default_rng(2)
    x = rng.standard_normal((8, 90, 101)).astype(np.float32)
    y = np.eye(2, dtype=np.float32)[rng.integers(0, 2, 8)]
    mask = np.array([1, 1, 1, 1, 1, 1, 0, 0], np.float32) if masked else None
    k_lam, k_perm = jax.random.split(key)
    lam = jax.random.beta(k_lam, 0.2, 0.2, (8,))
    perm = jax.random.permutation(k_perm, 8)
    want_x, want_y = jspec.mixup(
        jnp.asarray(x), jnp.asarray(y), key, 0.2,
        mask=None if mask is None else jnp.asarray(mask),
    )
    got_x, got_y = spec.mixup_apply(
        _t(x), _t(y), _t(lam), _t(perm).long(), None if mask is None else _t(mask)
    )
    _close(got_x, want_x)
    _close(got_y, want_y)


def _gen(seed: int) -> torch.Generator:
    return torch.Generator().manual_seed(seed)


def test_gate_rate_is_near_p():
    n, p = 10000, 0.3
    gain = waveform.volume_draws(_gen(0), n, p)
    noise = waveform.gaussian_noise_draws(_gen(1), n, 4, p)
    masks = spec.spec_augment_draws(_gen(2), (n, 90, 101), p=p)
    # Binomial sd at n = 10k is 0.0046: 0.02 is over four of them.
    for rate in ((gain != 1.0).float().mean(), noise.apply.float().mean(), masks.apply.float().mean()):
        assert abs(float(rate) - p) < 0.02


def test_draws_stay_in_their_bands():
    n, s = 2000, 1600
    gain = waveform.volume_draws(_gen(3), n, 1.0)
    assert float(gain.min()) >= 0.7 and float(gain.max()) <= 1.3
    amt = waveform.time_shift_draws(_gen(4), n, s, 1.0)
    assert int(amt.abs().max()) <= round(0.2 * s)

    x = torch.from_numpy(np.random.default_rng(3).standard_normal((n, s)).astype(np.float32))
    for draws, lo, hi, noisy in (
        (waveform.gaussian_noise_draws(_gen(5), n, s, 1.0), 10.0, 30.0, None),
        (waveform.file_noise_draws(_gen(6), n, s, 1.0, (4, s + 400)), 5.0, 20.0, True),
    ):
        if noisy:
            bank = torch.from_numpy(np.random.default_rng(4).standard_normal((4, s + 400)).astype(np.float32))
            added = waveform.file_noise_apply(x, draws, bank) - x
        else:
            added = waveform.gaussian_noise_apply(x, draws) - x
        snr = 10 * torch.log10((x * x).mean(1) / (added * added).mean(1))
        assert float(snr.min()) >= lo - 1e-3 and float(snr.max()) <= hi + 1e-3
        np.testing.assert_allclose(snr.numpy(), draws.snr_db.numpy(), atol=1e-3)

    m = spec.spec_augment_draws(_gen(7), (n, 90, 101), p=1.0)
    for start, width, param, dim in ((m.f_start, m.f_width, 8, 90), (m.t_start, m.t_width, 15, 101)):
        assert int(width.min()) >= 0 and int(width.max()) < param
        assert int(start.min()) >= 0 and int((start + width).max()) <= dim


def test_p_zero_is_the_identity(waves):
    w = _t(waves)
    feats = torch.randn(8, 90, 101, generator=_gen(0))
    bank = torch.randn(3, 16000, generator=_gen(1))
    assert torch.equal(waveform.augment_waveforms(w, _gen(2), p=0.0, noise_bank=bank), w)
    assert torch.equal(spec.spec_augment(feats, _gen(3), p=0.0), feats)


def test_same_step_key_gives_same_draws(waves):
    w = _t(waves)
    bank = torch.randn(3, 17000, generator=_gen(1))

    def run(seed, epoch, step):
        r = StepRandom("cpu").key(seed, epoch, step)
        out = waveform.augment_waveforms(w, r.aug, p=0.5, noise_bank=bank)
        feats = spec.spec_augment(out[:, :9090].reshape(8, 90, 101), r.aug, p=0.5)
        return feats, spec.mixup_draws(r.mixup, 8)

    a, b, c = run(1, 2, 3), run(1, 2, 3), run(1, 2, 4)
    assert torch.equal(a[0], b[0]) and not torch.equal(a[0], c[0])
    assert all(np.array_equal(x, y) for x, y in zip(a[1], b[1]))


def test_mixup_protects_real_rows_from_padded_partners():
    x = torch.randn(8, 90, 101, generator=_gen(4))
    y = torch.eye(2)[torch.tensor([0, 1, 0, 1, 0, 1, 0, 1])]
    mask = torch.tensor([1, 1, 1, 1, 1, 0, 0, 0], dtype=torch.float32)
    protected = 0
    for seed in range(20):
        lam, perm = spec.mixup_draws(np.random.default_rng(seed), 8)
        lam_t, perm_t = torch.from_numpy(lam), torch.from_numpy(perm)
        got_x, got_y = spec.mixup_apply(x, y, lam_t, perm_t, mask)
        for i in range(5):
            if mask[perm_t[i]] == 0:
                protected += 1
                assert torch.equal(got_x[i], x[i]) and torch.equal(got_y[i], y[i])
    assert protected > 0


def test_resampling_ops_are_not_ported_yet(waves):
    with pytest.raises(NotImplementedError):
        waveform.augment_waveforms(_t(waves), _gen(0), use_speed_perturbation=True)
    with pytest.raises(NotImplementedError):
        waveform.pitch_shift_semitones(_t(waves), 2)
