"""The yardstick's arithmetic against hand counts at the shipped shapes,
and the same count whichever plan the port's launches choose."""

import dataclasses
import math

import numpy as np
import pytest

from cough_detector_tpu_torch.config import FeatureConfig
from cough_detector_tpu_torch.ops import filters, frontend_kernel
from port_bench.lib import peaks, spec, work

SHIPPED = dataclasses.asdict(FeatureConfig())
REALTIME = spec.configuration(spec.benchmark(), {"config": "small_realtime"})["features"]


def _taps(cfg):
    fb = filters.mel_filterbank(cfg["n_fft"] // 2 + 1, cfg["n_mels"], cfg["sample_rate"], cfg["f_min"], cfg["f_max"])
    return int(np.count_nonzero(fb))


def test_launches_a_and_b_hand_count_shipped():
    taps = _taps(SHIPPED)
    w = work.frontend_launches(SHIPPED, 1)
    assert w["A"] == (101 * (400 + 5 * 512 * 9 + 3 * 257 + 2 * taps), 4 * (16000 + 101 * 64))
    b_ops = 101 * 64 * 7 + 101 * (2 * 64 + 2 * 64 * 13) + 6 * 101 * 13 + 2 * 101 * 13
    assert w["B"] == (b_ops, 4 * (101 * 64 + 101 * 90))
    assert "C" not in w
    assert work.frontend_launches(SHIPPED, 16384)["A"] == tuple(16384 * x for x in w["A"])


def test_contrast_launch_hand_count_realtime():
    w = work.frontend_launches(REALTIME, 1)
    widths = [1, 2, 6, 13, 29, 64]  # bands 1-2, 2-4, 4-10, 10-23, 23-52, 52-116 of 257 bins
    per_frame = 400 + 512 + 2 * 5 * 512 * 9 + 3 * 257 + 4 * 257 + sum(2 * x + 3 for x in widths) + 3 * 257 + 2
    assert w["C"] == (101 * per_frame + 6 * 101 * 7, 4 * (16000 + 101 * 7))
    assert w["A"][0] == 101 * (400 + 5 * 512 * 9 + 3 * 257 + 2 * _taps(REALTIME)) + 2 * 16000
    assert w["B"][1] == 4 * (101 * 64 + 101 * (64 + 39))


def test_classifier_hand_counts():
    def conv(cin, cout, k, ho, wo, groups=1):
        return (2 * cin // groups * k * k + 1) * cout * ho * wo

    res = (conv(1, 32, 7, 45, 51) + 3 * 32 * 45 * 51 + 3 * 32 * 22 * 25
           + conv(32, 64, 3, 11, 13) + conv(64, 64, 3, 11, 13) + conv(32, 64, 1, 11, 13) + 9 * 64 * 11 * 13
           + conv(64, 128, 3, 6, 7) + conv(128, 128, 3, 6, 7) + conv(64, 128, 1, 6, 7) + 9 * 128 * 6 * 7
           + 128 * 6 * 7 + 2 * 128 * 2 + 2)
    assert work.classifier_ops("residual", 90, 101) == res
    assert 43.3e6 < res < 43.5e6  # the convs 42.86 M, the norms, activations, pools and biases the rest
    small = (conv(1, 16, 3, 110, 101) + 3 * 16 * 110 * 101 + 3 * 16 * 55 * 50
             + conv(16, 16, 3, 55, 50, 16) + conv(16, 32, 1, 55, 50) + 3 * 32 * 55 * 50 + 3 * 32 * 27 * 25
             + conv(32, 32, 3, 27, 25, 32) + conv(32, 64, 1, 27, 25) + 3 * 64 * 27 * 25 + 3 * 64 * 13 * 12
             + conv(64, 64, 3, 13, 12, 64) + conv(64, 128, 1, 13, 12) + 3 * 128 * 13 * 12 + 128 * 13 * 12
             + 2 * 128 * 64 + 64 + 64 + 2 * 64 * 2 + 2)
    assert work.classifier_ops("small", 110, 101) == small
    ops, nbytes = work.classifier("residual", SHIPPED, 16384)
    bn_stats = 2 * (32 + 3 * 64 + 3 * 128)  # running means and variances are read too
    assert ops == 16384 * res and nbytes == 4 * (16384 * (90 * 101 + 2) + 290370 + bn_stats)


@pytest.mark.parametrize("n_fft", [512, 1024, 2048])
def test_launch_a_count_is_the_same_for_either_plan(monkeypatch, n_fft):
    cfg = dict(SHIPPED, n_fft=n_fft, win_length=min(400, n_fft), use_spectral_contrast=True)
    fc = FeatureConfig(**cfg)
    chosen = frontend_kernel.spectral_plan(fc)
    assert (chosen == frontend_kernel.PLAN_FFT) == (n_fft >= 640)
    before = work.frontend_launches(cfg, 64)
    for plan in (frontend_kernel.PLAN_GEMM_UNSTAGED, frontend_kernel.PLAN_FFT):
        monkeypatch.setattr(frontend_kernel, "spectral_plan", lambda c, plan=plan: plan)
        assert work.frontend_launches(cfg, 64) == before
    nf = n_fft // 2 + 1
    t = work.ref.num_frames(cfg)
    assert before["A"][0] == 64 * t * (cfg["win_length"] + 5 * n_fft * math.log2(n_fft) + 3 * nf + 2 * _taps(cfg))


def test_least_seconds_takes_the_larger_bound():
    assert peaks.least_seconds(67e12, 0) == pytest.approx(1.0)
    assert peaks.least_seconds(0, 3.35e12) == pytest.approx(1.0)
    assert peaks.least_seconds(67e12, 6.7e12) == pytest.approx(2.0)
