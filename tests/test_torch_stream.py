"""PyTorch port's streaming tick and detector against the JAX package, on
the CPU.

The JAX `StreamingDetector` and the port's run the same audio with carried
weights, as f32, int16 PCM and μ-law ticks: `valid`, `fired` and
`window_index` must be equal, and `smoothed` within 1e-3. The threshold is
placed more than that tolerance away from every smoothed value, so a
rounding difference cannot flip a fire.
"""

import jax
import numpy as np
import pytest
import torch

from cough_detector_tpu.config import default_config as jax_default_config
from cough_detector_tpu.data import synth
from cough_detector_tpu.serve.server import quantize_i16, quantize_mulaw
from cough_detector_tpu.stream.detector import StreamingDetector as JaxDetector
from cough_detector_tpu_torch.config import FeatureConfig, StreamConfig, default_config
from cough_detector_tpu_torch.models import from_jax_variables
from cough_detector_tpu_torch.serve import dequantize_mulaw
from cough_detector_tpu_torch.stream import (
    MeshDetector,
    StreamingDetector,
    init_state,
    make_stream_step,
    ring,
)
from cough_detector_tpu_torch.stream.detector import Detection
from test_torch_models import one_torch_thread, randomized_jax_variables  # noqa: F401

TOL = 1e-3
CHUNK = 1600
N_STREAMS = 3


@pytest.fixture(scope="module")
def audio():
    """(3, 40000): a cough, a non-cough and noise, 2.5 s each."""
    rng = np.random.default_rng(11)
    rows = [
        np.concatenate([synth.synthetic_cough(3, 1.5), synth.synthetic_cough(4, 1.0)]),
        np.concatenate([synth.synthetic_non_cough(5, 1.5), synth.synthetic_cough(6, 1.0)]),
        (rng.standard_normal(40000) * 0.2).astype(np.float32),
    ]
    return np.stack(rows).astype(np.float32)


@pytest.fixture(scope="module")
def weights(audio):
    """(Flax variables, port state dict) of a randomized small model whose
    last layer is rescaled so the logit difference over this audio's
    windows has mean 0 and std 3: random weights otherwise put every
    probability within 0.01 of each other, with no room for a threshold."""
    variables = randomized_jax_variables("small", seed=7)
    windows = np.concatenate(
        [audio[:, p : p + 16000] for p in range(0, 24001, 4000)]
    )
    det = _port_detector(from_jax_variables(variables, "small"), 0.5)
    p = det.scores_for(windows).astype(np.float64)
    d = np.log(p) - np.log1p(-p)
    scale = 3.0 / d.std()
    fc2 = variables["params"]["fc2"]
    fc2["kernel"] = np.asarray(fc2["kernel"]) * scale
    fc2["bias"] = np.asarray(fc2["bias"]) * scale + np.array(
        [0.0, -scale * d.mean()], np.float32
    )
    return variables, from_jax_variables(variables, "small")


def _ticks(audio, fmt):
    ticks = [audio[:, i : i + CHUNK] for i in range(0, audio.shape[1], CHUNK)]
    if fmt == "int16":
        return [quantize_i16(t) for t in ticks]
    if fmt == "mulaw":
        return [quantize_mulaw(t) for t in ticks]
    return ticks


def _port_detector(port_weights, threshold):
    return StreamingDetector(
        variables=port_weights, config=default_config("small"), device="cpu",
        num_streams=N_STREAMS, chunk_size=CHUNK,
        confidence_threshold=threshold, smoothing_window=3,
        debounce_seconds=0.5,
    )


def _run(det, ticks, to_numpy):
    out = {"valid": [], "window_index": [], "fired": [], "smoothed": []}
    for t in ticks:
        ev = det.tick_async(t)
        for key in out:
            out[key].append(to_numpy(ev[key]))
    return {k: np.concatenate(v, axis=-1) for k, v in out.items()}


def _threshold_between(smoothed: np.ndarray) -> float:
    """The midpoint of the widest gap among the middle smoothed values,
    asserted to sit more than the tolerance from each of them."""
    vals = np.unique(smoothed)
    lo, hi = len(vals) // 4, 3 * len(vals) // 4
    gaps = np.diff(vals[lo : hi + 1])
    i = int(np.argmax(gaps))
    thr = float((vals[lo + i] + vals[lo + i + 1]) / 2)
    assert np.abs(vals - thr).min() > 2 * TOL
    return thr


@pytest.mark.parametrize("fmt", ["float32", "int16", "mulaw"])
def test_events_match_jax_detector(weights, audio, fmt):
    jax_vars, port_weights = weights
    ticks = _ticks(audio, fmt)

    probe = _run(_port_detector(port_weights, 0.0), ticks, lambda t: t.numpy())
    thr = _threshold_between(probe["smoothed"][:, probe["valid"]])

    jax_det = JaxDetector(
        variables=jax_vars, config=jax_default_config("small"),
        num_streams=N_STREAMS, chunk_size=CHUNK, confidence_threshold=thr,
        smoothing_window=3, debounce_seconds=0.5, mesh=False,
    )
    want = _run(jax_det, ticks, np.asarray)
    got = _run(_port_detector(port_weights, thr), ticks, lambda t: t.numpy())

    valid = want["valid"]
    assert valid.sum() == 7
    np.testing.assert_array_equal(got["valid"], valid)
    np.testing.assert_array_equal(got["window_index"], want["window_index"])
    np.testing.assert_array_equal(got["fired"][:, valid], want["fired"][:, valid])
    assert np.abs(got["smoothed"] - want["smoothed"])[:, valid].max() < TOL
    assert np.abs(want["smoothed"][:, valid] - thr).min() > TOL
    assert 0 < want["fired"].sum() < valid.sum() * N_STREAMS


def test_process_chunk_detections_match_jax(weights, audio):
    jax_vars, port_weights = weights
    jax_det = JaxDetector(
        variables=jax_vars, config=jax_default_config("small"),
        num_streams=N_STREAMS, chunk_size=CHUNK, confidence_threshold=0.0,
        mesh=False,
    )
    want = jax_det.process_chunk(audio[:, :30000])
    got = _port_detector(port_weights, 0.0).process_chunk(audio[:, :30000])
    assert [(d.stream, d.time_seconds) for d in got] == [
        (d.stream, d.time_seconds) for d in want
    ]
    np.testing.assert_allclose(
        [d.confidence for d in got], [d.confidence for d in want], atol=TOL
    )


def _mean_step(chunk, num_streams, stream_cfg):
    step = make_stream_step(lambda w: w.mean(dim=1), FeatureConfig(), stream_cfg)
    state = init_state(
        num_streams, chunk, 16000, stream_cfg.smoothing_window,
        stream_cfg.confidence_threshold, device="cpu",
    )
    return step, state


@pytest.mark.parametrize("chunk", [1600, 4000, 16000])
def test_windows_match_offline_slicing(chunk):
    """Chunks of any size emit exactly the windows offline slicing gives
    (window 1 s, hop 0.25 s)."""
    step, state = _mean_step(chunk, 2, StreamConfig(confidence_threshold=2.0))
    signal = np.random.default_rng(0).standard_normal((2, 48000)).astype(np.float32)
    got = []
    for i in range(0, 48000, chunk):
        state, ev = step(state, signal[:, i : i + chunk])
        for k in np.nonzero(ev["valid"].numpy())[0]:
            got.append(ev["probs"][:, k].numpy())
    want = [signal[:, p : p + 16000].mean(axis=1) for p in range(0, 32001, 4000)]
    np.testing.assert_allclose(np.stack(got), np.stack(want), atol=1e-5)


def test_debounce_and_packed_window_index():
    """Debounce in window indices, and win_idx past 2^15 survives the
    packed tensor's two 15-bit halves exactly."""
    step, state = _mean_step(
        4000, 1, StreamConfig(confidence_threshold=0.5, smoothing_window=1,
                              debounce_seconds=0.6)
    )
    state = state._replace(windows_emitted=(1 << 15) + 5)
    fires = []
    for _ in range(16):
        state, ev = step(state, np.ones((1, 4000), np.float32))
        packed = ev["packed"].numpy()
        win = packed[1].astype(np.int64) * 32768 + packed[2].astype(np.int64)
        np.testing.assert_array_equal(win, ev["window_index"].numpy())
        fires += [int(w) for w, f in zip(win, packed[3 + 1]) if f > 0.5]
    assert len(fires) >= 4
    assert (np.diff(fires) >= 3).all()  # ceil(0.6 s / 0.25 s) windows


def test_reset_streams_and_thresholds(weights):
    _, port_weights = weights
    det = _port_detector(port_weights, 0.5)
    det.process_chunk(np.ones((N_STREAMS, 30000), np.float32) * 0.1)
    det.set_thresholds([1], [0.9])
    np.testing.assert_allclose(det.current_thresholds(), [0.5, 0.9, 0.5])
    buf_before = det._state.buffer.clone()
    det.reset_streams([0, 2], thresholds=[0.2, None])
    st = det._state
    np.testing.assert_allclose(det.current_thresholds(), [0.2, 0.9, 0.5])
    assert st.buffer[[0, 2]].abs().sum() == 0 and st.history[[0, 2]].abs().sum() == 0
    assert torch.equal(st.buffer[1], buf_before[1])
    assert st.history_len.tolist() == [0, 3, 0]
    assert st.last_fire_window[0] == ring.NEVER_FIRED


def test_mulaw_dequantization_matches_host_decoder():
    codes = np.arange(256, dtype=np.uint8)[None]
    got = ring.dequantize(torch.from_numpy(codes)).numpy()
    np.testing.assert_allclose(got, dequantize_mulaw(codes), atol=1e-6)
    assert got[0, 128] == 0.0


def test_reference_pt_checkpoint_loads(weights, audio, tmp_path):
    """A .pt written by the JAX package's exporter (reference layout, flat
    config inside) serves in the port with the same scores as the carried
    weights; a directory that holds no checkpoint is refused."""
    from cough_detector_tpu.train.checkpoint import export_torch_checkpoint

    jax_vars, port_weights = weights
    pt = tmp_path / "model.pt"
    export_torch_checkpoint(str(pt), jax_vars, jax_default_config("small"))
    det = StreamingDetector(str(pt), device="cpu")
    assert det.config == default_config("small").replace(
        model=default_config("small").model
    )
    windows = audio[:, :16000]
    np.testing.assert_allclose(
        det.scores_for(windows),
        _port_detector(port_weights, 0.5).scores_for(windows),
        atol=1e-6,
    )
    with pytest.raises(FileNotFoundError):
        StreamingDetector(str(tmp_path), device="cpu")


def test_trainer_checkpoint_directory_loads(weights, audio, tmp_path):
    """A checkpoint directory written by the port's trainer (state.pt and
    meta.json's config_full) serves with the carried weights' scores."""
    from cough_detector_tpu_torch.models import create_model
    from cough_detector_tpu_torch.train import checkpoint, make_optimizer

    _, port_weights = weights
    model = create_model("small")
    model.load_state_dict(port_weights)
    cfg = default_config("small")
    path = checkpoint.save_checkpoint(
        str(tmp_path), "best_model", model, make_optimizer(model.parameters(), cfg.train, 4),
        2, {"f1": 0.5}, cfg,
    )
    det = StreamingDetector(path, device="cpu")
    assert det.config == cfg
    windows = audio[:, :16000]
    np.testing.assert_array_equal(
        det.scores_for(windows), _port_detector(port_weights, 0.5).scores_for(windows)
    )


def test_detector_defaults_to_the_card(weights):
    if torch.cuda.is_available():
        pytest.skip("a card is present; the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        StreamingDetector(variables=weights[1], config=default_config("small"))


# -- over a mesh of devices ------------------------------------------------------------


def _mesh_kw(weights):
    return dict(
        variables=weights[1], config=default_config("small"), device="cpu",
        num_streams=4, chunk_size=CHUNK, confidence_threshold=0.0,
        smoothing_window=3, debounce_seconds=0.5,
    )


def test_detector_over_a_mesh_equals_one_device(weights, audio):
    """4 streams in two blocks over ["cpu", "cpu"] (tests/test_sharding.py's
    check): the detections of one device in stream order, times exact; lane
    resets, thresholds and raw scores reach the right block. Confidences
    and scores are held exactly against one device run on the mesh's block
    shapes (two detectors of 2 streams, their lanes and detections mapped
    as the mesh maps them): the model's CPU convolutions sum in another
    order at another batch size (the same features give logits up to
    4.6e-5 apart at 2 and 4 rows), so a block of 2 and a batch of 4 round a
    confidence differently (2.87e-4 moved by 9.9e-9 on one host)."""
    four = np.concatenate([audio, audio[:1] * 0.5])
    one = StreamingDetector(mesh=False, **_mesh_kw(weights))
    two = StreamingDetector(mesh=["cpu", "cpu"], **_mesh_kw(weights))
    halves = [StreamingDetector(mesh=False, **dict(_mesh_kw(weights), num_streams=2)) for _ in range(2)]
    assert one.mesh is None and two.mesh.size == 2
    assert type(one) is StreamingDetector and isinstance(two, MeshDetector)
    for det in (one, two):
        det.process_chunk(four[:, :16000])
        det.reset_streams([1, 2], [0.3, None])
        det.set_thresholds([3], [0.9])
    for i, det in enumerate(halves):  # stream 2 i + lane: lanes 1 of the first block, 0 and 1 of the second
        det.process_chunk(four[2 * i : 2 * i + 2, :16000])
        det.reset_streams([1 - i], [[0.3, None][i]])
    halves[1].set_thresholds([1], [0.9])
    np.testing.assert_array_equal(two.current_thresholds(), one.current_thresholds())
    np.testing.assert_array_equal(two.current_thresholds(), np.concatenate([h.current_thresholds() for h in halves]))
    want, got = one.process_chunk(four[:, 16000:]), two.process_chunk(four[:, 16000:])
    blocks = sorted(
        (Detection(d.stream + 2 * i, d.time_seconds, d.confidence)
         for i, det in enumerate(halves) for d in det.process_chunk(four[2 * i : 2 * i + 2, 16000:])),
        key=lambda d: (d.time_seconds, d.stream),
    )
    assert len(want) > 5 and len(got) == len(want) == len(blocks)
    assert [(d.stream, d.time_seconds) for d in got] == [(d.stream, d.time_seconds) for d in want]
    assert got == blocks
    assert two.windows_emitted == one.windows_emitted == halves[0].windows_emitted
    windows = four[:, :16000][:3]
    padded = np.concatenate([windows, np.zeros_like(windows[:1])])
    np.testing.assert_array_equal(
        two.scores_for(windows), np.concatenate([h.scores_for(padded[2 * i : 2 * i + 2]) for i, h in enumerate(halves)])[:3]
    )


def test_explicit_indivisible_mesh_raises(weights):
    kw = _mesh_kw(weights)
    kw["num_streams"] = 3
    with pytest.raises(ValueError, match="not divisible"):
        StreamingDetector(mesh=["cpu", "cpu"], **kw)
    assert StreamingDetector(**kw).mesh is None  # no card: the default is one device
