"""PyTorch port's detection server, client and protocol, on the CPU.

Loopback clients against the port's `DetectionServer` (eager tick policy,
device="cpu"): delivered events must equal the port's in-process
`StreamingDetector` on the same audio. The wire format and the quantizers
are checked byte for byte against the JAX package's, and a subprocess
checks that importing the port pulls in neither JAX nor the JAX package.
"""

import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from cough_detector_tpu.data import synth
from cough_detector_tpu.serve import protocol as jax_protocol
from cough_detector_tpu.serve import server as jax_server
from cough_detector_tpu_torch.config import default_config
from cough_detector_tpu_torch.models import create_model
from cough_detector_tpu_torch.serve import (
    DetectionClient,
    DetectionServer,
    ServerRefused,
    protocol,
    quantize_i16,
    quantize_mulaw,
)
from cough_detector_tpu_torch.stream import StreamingDetector
from test_torch_models import one_torch_thread  # noqa: F401

CHUNK = 1600
_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def weights():
    torch.manual_seed(0)
    return create_model("small").state_dict(), default_config("small")


def _make_server(weights, **kw):
    state_dict, cfg = weights
    kw.setdefault("num_streams", 4)
    kw.setdefault("chunk_size", CHUNK)
    kw.setdefault("confidence_threshold", 0.0)  # every window fires
    kw.setdefault("debounce_seconds", 0.5)
    kw.setdefault("tick_policy", "eager")
    return DetectionServer(variables=state_dict, config=cfg, device="cpu", **kw)


def _wait(predicate, timeout=20.0, dt=0.02):
    end = time.time() + timeout
    while time.time() < end:
        if predicate():
            return True
        time.sleep(dt)
    return False


@pytest.mark.parametrize("h2d_dtype", ["float32", "int16"])
def test_events_match_in_process_detector(weights, h2d_dtype):
    """int16 ticks quantize the audio on assemble, which moves the
    confidences by O(1e-5) but no event."""
    state_dict, cfg = weights
    wave = np.concatenate([synth.synthetic_cough(7, 1.5), np.zeros(8000, np.float32)])
    n_chunks = wave.size // CHUNK
    wave = wave[: n_chunks * CHUNK]
    ref = StreamingDetector(
        variables=state_dict, config=cfg, device="cpu", num_streams=1,
        chunk_size=CHUNK, confidence_threshold=0.0, debounce_seconds=0.5,
    )
    expected = ref.process_chunk(wave)
    assert expected, "fixture should produce detections"

    with _make_server(weights, h2d_dtype=h2d_dtype) as srv:
        with DetectionClient(*srv.address) as c:
            sid = c.open_stream()
            for t in range(n_chunks):
                c.send_audio(sid, wave[t * CHUNK : (t + 1) * CHUNK])
            assert _wait(lambda: srv.stats()["ticks"] >= n_chunks)
            got = []  # the last frames may still be on the wire
            _wait(lambda: got.extend(c.events()) or len(got) >= len(expected), 5.0)
            time.sleep(0.1)
            got += c.events()
    assert len(got) == len(expected)
    for ev, exp in zip(got, expected):
        assert ev["stream"] == sid
        assert ev["time"] == pytest.approx(exp.time_seconds, abs=1e-6)
        assert ev["confidence"] == pytest.approx(
            exp.confidence, rel=1e-4 if h2d_dtype == "float32" else 1e-3
        )


def test_two_clients_isolated_and_capacity(weights):
    wave = synth.synthetic_cough(3, 1.5)
    n_chunks = wave.size // CHUNK
    with _make_server(weights, num_streams=2) as srv:
        with DetectionClient(*srv.address) as ca, DetectionClient(*srv.address) as cb:
            sa, sb = ca.open_stream(), cb.open_stream()
            with pytest.raises(ServerRefused):
                cb.open_stream()
            for t in range(n_chunks):
                ca.send_audio(sa, wave[t * CHUNK : (t + 1) * CHUNK])
                cb.send_audio(sb, np.zeros(CHUNK, np.float32))
            assert _wait(lambda: srv.stats()["ticks"] >= n_chunks)
            evs_a, evs_b = ca.events(timeout=5.0), cb.events(timeout=5.0)
            assert srv.stats()["refused"] == 1
    assert evs_a and all(e["stream"] == sa for e in evs_a)
    assert evs_b and all(e["stream"] == sb for e in evs_b)


def test_timer_policy_overflow_drops_oldest(weights):
    """Timer ticks drain 0.1 s per 0.1 s; 4 s of audio into a 0.5 s
    buffer must drop the oldest samples and count them."""
    with _make_server(
        weights, tick_policy="timer", buffer_seconds=0.5, num_streams=2
    ) as srv:
        with DetectionClient(*srv.address) as c:
            sid = c.open_stream()
            for _ in range(20):
                c.send_audio(sid, np.zeros(3200, np.float32))
            assert _wait(lambda: srv.stats()["dropped_samples"] > 0)
            assert _wait(lambda: srv.stats()["ticks"] > 0)


def test_eager_liveness_ticks_past_a_silent_tenant(weights):
    """A tenant that opens a slot and sends nothing must not stall a live
    one: after the liveness deadline the server ticks and zero-fills."""
    wave = synth.synthetic_cough(5, 1.5)
    n_chunks = wave.size // CHUNK
    with _make_server(weights, num_streams=2, liveness_seconds=0.05) as srv:
        with DetectionClient(*srv.address) as live, DetectionClient(*srv.address) as idle:
            sa = live.open_stream()
            idle.open_stream()
            for t in range(n_chunks):
                live.send_audio(sa, wave[t * CHUNK : (t + 1) * CHUNK])
            assert _wait(lambda: srv.stats()["ticks"] >= n_chunks)
            assert live.events(timeout=5.0)


def test_backend_and_device_choices(weights):
    state_dict, cfg = weights
    with pytest.raises(NotImplementedError):
        DetectionServer(variables=state_dict, config=cfg, device="cpu", backend="native")
    srv = _make_server(weights, backend="auto")
    try:
        assert srv.backend == "python"
    finally:
        srv.stop()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            DetectionServer(variables=state_dict, config=cfg)


def test_quantizers_and_wire_bytes_match_jax():
    rng = np.random.default_rng(0)
    x = rng.uniform(-1.2, 1.2, 4096).astype(np.float32)
    x[:4] = [np.nan, np.inf, -np.inf, 0.0]
    np.testing.assert_array_equal(quantize_i16(x), jax_server.quantize_i16(x))
    np.testing.assert_array_equal(quantize_mulaw(x), jax_server.quantize_mulaw(x))
    for ours, theirs in [
        (protocol.encode_open(0.25), jax_protocol.encode_open(0.25)),
        (protocol.encode_audio(3, x[4:20]), jax_protocol.encode_audio(3, x[4:20])),
        (protocol.encode_event(1, 1.25, 0.5), jax_protocol.encode_event(1, 1.25, 0.5)),
        (protocol.encode_thresh(2, 0.7), jax_protocol.encode_thresh(2, 0.7)),
    ]:
        assert ours == theirs


def test_port_imports_no_jax():
    """Every module of the port imports without JAX, Flax, optax, Orbax or
    the JAX package; the training slice's modules are among them."""
    code = (
        "import pkgutil, importlib, sys\n"
        "import cough_detector_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "banned = ('jax', 'flax', 'optax', 'orbax', 'cough_detector_tpu')\n"
        "bad = sorted(n for n in sys.modules if n.split('.')[0] in banned)\n"
        "assert not bad, bad\n"
        "assert 'cough_detector_tpu_torch.train.loop' in sys.modules\n"
        "print('ok', len([n for n in sys.modules if n.startswith(p.__name__)]))\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=_REPO, capture_output=True, text=True,
        timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")
    assert int(out.stdout.split()[1]) >= 36
