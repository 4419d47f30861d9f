"""PyTorch port's offline scoring, reference-API facade and microphone
listener against the JAX package, on the CPU.

The same weights (`from_jax_variables`, or one reference `.pt` both
packages load) and the same recording: `score_recording`'s window
probabilities within 1e-3 of JAX's and its events at threshold 0 equal
(times exact, confidences 1e-4); offline equals streaming inside the port;
`frame_windows` geometry and short recordings as in tests/test_stream.py.
The facade's `predict` within 1e-4 of JAX's, its `process_audio_chunk`
events equal, its threshold live and kept across `reset`, and "auto"
meaning the card. `RealtimeMicrophoneDetector` on `ArrayCapture` gives
JAX's detections; engine and callback errors are recorded, not fatal; no
thread outlives a session.
"""

import threading
import time

import numpy as np
import pytest
import torch

from cough_detector_tpu.config import default_config as jax_default_config
from cough_detector_tpu.stream import offline as joffline
from cough_detector_tpu.stream.detector import CoughDetectorInference as JaxInference
from cough_detector_tpu.stream.mic import ArrayCapture as JaxArrayCapture
from cough_detector_tpu.stream.mic import RealtimeMicrophoneDetector as JaxMic
from cough_detector_tpu.train.checkpoint import export_torch_checkpoint
from cough_detector_tpu_torch.config import default_config
from cough_detector_tpu_torch.data import synth
from cough_detector_tpu_torch.stream import CoughDetectorInference, StreamingDetector, mic, offline
from test_torch_models import one_torch_thread  # noqa: F401
from test_torch_stream import audio, weights  # noqa: F401

SR = 16000


@pytest.fixture(scope="module")
def recording(audio):  # noqa: F811
    """12.5 s: the stream fixture's three rows around two more coughs."""
    rng = np.random.default_rng(21)
    parts = [audio[0], synth.synthetic_cough(31, 1.5), audio[1],
             (rng.standard_normal(SR) * 0.05).astype(np.float32), synth.synthetic_cough(32, 1.5), audio[2]]
    return np.concatenate(parts).astype(np.float32)


@pytest.fixture(scope="module")
def jax_probs(weights, recording):  # noqa: F811
    """JAX's probability of every window: its events at threshold 0 with
    no smoothing and no debounce are every window with its score."""
    events = joffline.score_recording(
        recording, weights[0], jax_default_config("small"), threshold=0.0,
        smoothing_window=1, debounce_seconds=0.0, mesh=False,
    )
    return np.array([e.confidence for e in events], np.float32)


def _port_probs(weights, wave, **kw):  # noqa: F811
    return offline.window_probs(wave, weights[1], default_config("small"), device="cpu", **kw)


def test_window_probs_match_jax(weights, recording, jax_probs):  # noqa: F811
    got = _port_probs(weights, recording)
    assert got.shape == jax_probs.shape == ((len(recording) - SR) // 4000 + 1,)
    assert np.abs(got - jax_probs).max() < 1e-3
    assert jax_probs.std() > 0.05  # the scores spread, so the events below mean something
    # Batches of 16 (the JAX rule pads the tail) give the same scores.
    assert np.abs(_port_probs(weights, recording, batch_size=16) - got).max() < 1e-6


@pytest.mark.parametrize("smoothing,debounce", [(3, 0.5), (1, 1.0)])
def test_events_at_threshold_zero_match_jax(weights, recording, jax_probs, smoothing, debounce):  # noqa: F811
    got = offline.score_recording(
        recording, weights[1], default_config("small"), threshold=0.0,
        smoothing_window=smoothing, debounce_seconds=debounce, device="cpu",
    )
    want = joffline.smooth_and_debounce(jax_probs, 4000, SR, SR, 0.0, smoothing, debounce)
    assert [e.time_seconds for e in got] == [e.time_seconds for e in want] and len(got) > 5
    np.testing.assert_allclose([e.confidence for e in got], [e.confidence for e in want], atol=1e-4)


def test_offline_equals_streaming(weights, recording):  # noqa: F811
    probs = _port_probs(weights, recording)
    thr = float(np.median(probs))
    got = offline.score_recording(
        recording, weights[1], default_config("small"), threshold=thr, device="cpu",
    )
    det = StreamingDetector(
        variables=weights[1], config=default_config("small"), device="cpu",
        chunk_size=1600, confidence_threshold=thr,
    )
    want = det.process_chunk(recording)
    assert 0 < len(got) == len(want)
    assert [e.time_seconds for e in got] == [d.time_seconds for d in want]
    np.testing.assert_allclose([e.confidence for e in got], [d.confidence for d in want], atol=1e-5)


def test_frame_windows_geometry_and_short_recordings(weights):  # noqa: F811
    w = torch.arange(SR * 2, dtype=torch.float32)
    f = offline.frame_windows(w, SR, 4000)
    assert f.shape == (5, SR) and float(f[1, 0]) == 4000.0 and float(f[4, -1]) == 2 * SR - 1
    assert offline.frame_windows(torch.zeros(1000), SR, 4000).shape == (0, SR)
    assert offline.score_recording(np.zeros(1000, np.float32), weights[1], default_config("small"), device="cpu") == []


def test_score_recording_loads_checkpoints_and_refuses_a_mesh(weights, recording, tmp_path):  # noqa: F811
    pt = tmp_path / "m.pt"
    export_torch_checkpoint(str(pt), weights[0], jax_default_config("small"))
    short = recording[: 4 * SR]
    kw = dict(threshold=0.0, device="cpu")
    want = offline.score_recording(short, weights[1], default_config("small"), **kw)
    assert offline.score_recording(short, model_path=str(pt), **kw) == want
    with pytest.raises(NotImplementedError):
        offline.score_recording(short, weights[1], default_config("small"), mesh=object(), device="cpu")
    with pytest.raises(ValueError):
        offline.score_recording(short, device="cpu")


# -- the reference-API facade ------------------------------------------------------


@pytest.fixture(scope="module")
def pt_path(weights, tmp_path_factory):  # noqa: F811
    path = tmp_path_factory.mktemp("facade") / "model.pt"
    export_torch_checkpoint(str(path), weights[0], jax_default_config("small"), 3, {"f1": 0.5})
    return str(path)


@pytest.fixture(scope="module")
def jax_facade(pt_path):
    return JaxInference(pt_path, confidence_threshold=0.5, verbose=False)


def test_predict_matches_jax(pt_path, jax_facade):
    ours = CoughDetectorInference(pt_path, device="cpu", verbose=False)
    rng = np.random.default_rng(22)
    for shape in ((1, 90, 101), (3, 1, 90, 101)):
        feats = rng.standard_normal(shape).astype(np.float32)
        (hit, p), (jhit, jp) = ours.predict(feats), jax_facade.predict(feats)
        assert abs(p - jp) < 1e-4 and hit == jhit


def _feed(facade, wave, block=4000):
    out = []
    facade.on_cough_detected = lambda when, conf: out.append(conf)
    for lo in range(0, len(wave), block):
        facade.process_audio_chunk(wave[lo : lo + block])
    return out


def test_process_audio_chunk_events_match_jax(pt_path, jax_facade, recording):
    ours = CoughDetectorInference(pt_path, device="cpu", verbose=False)
    assert ours.config == jax_facade.config and ours.device.type == "cpu"
    for thr in (0.0, 0.5):
        ours.confidence_threshold = jax_facade.confidence_threshold = thr
        ours.reset()
        jax_facade.reset()
        got, want = _feed(ours, recording), _feed(jax_facade, recording)
        assert len(got) == len(want) > 0, thr
        np.testing.assert_allclose(got, want, atol=1e-4)
    # (channels, samples) is averaged to mono.
    mono = recording[: SR * 2]
    ours.reset()
    from_stereo = ours.process_audio_chunk(np.stack([mono, mono]))
    ours.reset()
    from_mono = ours.process_audio_chunk(mono)
    assert from_stereo is not None and from_stereo[1] == from_mono[1]


def test_threshold_is_live_and_survives_reset(pt_path):
    ours = CoughDetectorInference(pt_path, device="cpu", confidence_threshold=0.4, verbose=False)
    ours.confidence_threshold = 0.9
    assert ours.confidence_threshold == 0.9
    assert ours._engine.current_thresholds()[0] == np.float32(0.9)
    ours.reset()
    assert ours._engine.current_thresholds()[0] == np.float32(0.9)


@pytest.mark.parametrize("device", ["auto", "cuda"])
def test_the_card_is_the_default_and_raises_without_one(pt_path, device, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        CoughDetectorInference(pt_path, device=device, verbose=False)
    with pytest.raises(RuntimeError, match="CUDA"):
        CoughDetectorInference(pt_path, verbose=False)


# -- the microphone listener ------------------------------------------------------------


def test_microphone_detections_match_jax(pt_path, jax_facade, recording):
    ours = CoughDetectorInference(pt_path, device="cpu", confidence_threshold=0.5, verbose=False)
    jax_facade.confidence_threshold = 0.5
    hits = {}
    for name, engine, capture, listener in (
        ("ours", ours, mic.ArrayCapture, mic.RealtimeMicrophoneDetector),
        ("jax", jax_facade, JaxArrayCapture, JaxMic),
    ):
        det = listener(engine, capture=capture(recording, block_size=1600))
        got = []
        det.on_detection = lambda when, conf, got=got: got.append(conf)
        det.start()
        det.drain_until_idle(timeout=60)
        det.stop()
        assert not det.errors and not det.running
        hits[name] = got
    assert len(hits["ours"]) == len(hits["jax"]) > 0
    np.testing.assert_allclose(hits["ours"], hits["jax"], atol=1e-4)


class _StubEngine:
    """An inference engine that 'detects' any block peaking above 0.5."""

    def __init__(self):
        self.resets = 0
        self.blocks = []

    def reset(self):
        self.resets += 1

    def process_audio_chunk(self, samples):
        import datetime

        self.blocks.append(len(samples))
        if np.abs(samples).max() > 0.5:
            return datetime.datetime.now(), float(np.abs(samples).max())
        return None


class _Exploding(_StubEngine):
    def process_audio_chunk(self, samples):
        raise ValueError("boom")


def _session(engine, wave, on_detection=None):
    before = threading.active_count()
    det = mic.RealtimeMicrophoneDetector(engine, capture=mic.ArrayCapture(wave, 1600))
    det.on_detection = on_detection
    det.start()
    det.drain_until_idle()
    det.stop()
    assert not det.running
    _threads_back_to(before)  # the capture and the worker joined
    return det


def _threads_back_to(n: int, timeout: float = 10.0) -> None:
    deadline = time.monotonic() + timeout
    while threading.active_count() != n and time.monotonic() < deadline:
        time.sleep(0.01)
    assert threading.active_count() == n


def test_listener_records_engine_and_callback_errors():
    det = _session(_Exploding(), np.ones(4800, np.float32))
    assert len(det.errors) == 3 and all("scoring failed" in e for e in det.errors)

    wave = np.zeros(SR, np.float32)
    wave[1600:3200] = 0.9
    wave[12800:14400] = 0.8
    engine, calls = _StubEngine(), []

    def exploding(when, conf):
        calls.append(conf)
        raise RuntimeError("user callback bug")

    det = _session(engine, wave, exploding)
    assert sum(engine.blocks) == SR and calls == pytest.approx([0.9, 0.8])
    assert any("callback failed" in e for e in det.errors)


def test_listener_restarts_with_one_worker_and_names_its_backend(monkeypatch):
    engine = _StubEngine()
    det = mic.RealtimeMicrophoneDetector(engine, capture=mic.ArrayCapture(np.zeros(8000, np.float32), 1600))
    assert det.backend == "array"
    for _ in range(2):
        det.start()
        det.drain_until_idle()
        det.stop()
    assert engine.resets == 2 and sum(engine.blocks) == 16000
    monkeypatch.setattr(mic, "_stack", lambda name: None)
    with pytest.raises(RuntimeError, match="capture stack"):
        mic.RealtimeMicrophoneDetector(_StubEngine())
    mic.list_audio_devices()
