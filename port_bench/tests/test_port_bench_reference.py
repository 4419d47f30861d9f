"""The plain reference against the port's plain CPU path at a tiny size:
the feature image stage by stage and the logits, for both configurations,
on the benchmark's own weights and audio."""

import pytest
import torch

from cough_detector_tpu_torch.config import FeatureConfig, ModelConfig
from cough_detector_tpu_torch.models import model_from_config
from cough_detector_tpu_torch.ops import frontend
from port_bench.lib import audio, check, spec, weights
from port_bench.reference import frontend as ref_frontend
from port_bench.reference import models as ref_models
from port_bench.reference import stream as ref_stream

BENCH = spec.benchmark()
PARAMS = spec.traffic("offline")["audio"]


@pytest.mark.parametrize("config", ["residual", "small_realtime"])
def test_reference_matches_the_port_on_the_cpu(config):
    cfg = spec.configuration(BENCH, {"config": config})
    pcm = audio.pcm(6, 16000, 5, "test", PARAMS, "cpu")
    waves = pcm.float() / 32768.0
    ours = frontend.extract_features(waves, FeatureConfig(**cfg["features"]))
    ref = ref_frontend.features(waves.double(), cfg["features"])
    assert ours.shape == ref.shape == (6, *cfg["feature_shape"])
    for name, (lo, hi) in ref_frontend.row_blocks(cfg["features"]).items():
        gap = check.Gap()
        gap.add(ours[:, lo:hi], ref[:, lo:hi])
        assert gap.value < 2e-5, name
    model_type = cfg["model"]["model_type"]
    state = weights.make(model_type, 5, "cpu")
    model = model_from_config(ModelConfig(model_type=model_type)).eval()
    model.load_state_dict(state)
    with torch.no_grad():
        got = model(ours)
    gap = check.Gap()
    gap.add(got, ref_models.logits(ref, state, model_type))
    assert gap.value < 2e-5


def test_weights_are_the_seeds_and_fit_the_port():
    a = weights.make("residual", 2**40 + 3, "cpu")
    b = weights.make("residual", 2**40 + 3, "cpu")
    c = weights.make("residual", 2**40 + 4, "cpu")
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["conv1.0.weight"], c["conv1.0.weight"])
    model_from_config(ModelConfig(model_type="small")).load_state_dict(weights.make("small", 1, "cpu"))


def test_stream_rules():
    p = torch.tensor([[0.2, 0.9, 0.9, 0.9, 0.9, 0.1]]).numpy()
    sm = ref_stream.smooth(p, 3)
    assert sm[0].tolist() == pytest.approx([0.2, 0.55, 2.0 / 3, 0.9, 0.9, 1.9 / 3])
    assert ref_stream.fire(sm, 0.7, 2)[0].tolist() == [False, False, False, True, False, False]
    assert ref_stream.debounce_windows(0.5, 16000, 4000) == 2
    assert ref_stream.expected({"window": 16000, "hop": 4000, "chunk": 1600}, 15) == {9: 0, 12: 1, 14: 2}
