"""PyTorch port's detection server, client and protocol, on the CPU.

Loopback clients against the port's `DetectionServer` (eager tick policy,
device="cpu"): delivered events must equal the port's in-process
`StreamingDetector` on the same audio. The behaviors the JAX package's
tests/test_serve.py holds on both socket tiers run here on both too: the
python reader threads and the port's C++ epoll plane (`backend="native"`,
skipped without g++), whose int16 and μ-law assembly equal the host
quantizers bit for bit. The stats sidecar and the daemon CLI
(`python -m cough_detector_tpu_torch.cli.serve`, in a subprocess stopped
by SIGTERM) are checked as the JAX package's are. The wire format and the
quantizers are checked byte for byte against the JAX package's, and a
subprocess checks that importing the port pulls in neither JAX nor the JAX
package.
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
    StatsHttpServer,
    native_ingest,
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
    """"native" is the C++ plane, and raises only when its library cannot
    be built; "auto" takes it when it builds; an unknown tier raises."""
    state_dict, cfg = weights
    with pytest.raises(ValueError, match="backend"):
        _make_server(weights, backend="rust")
    if native_ingest.available():
        srv = _make_server(weights, backend="native")
        assert srv.backend == "native" and srv.address is None
        srv.stop()  # never started: nothing bound, nothing to close
    else:
        with pytest.raises(RuntimeError, match="native ingest unavailable"):
            _make_server(weights, backend="native")
    srv = _make_server(weights, backend="auto")
    try:
        assert srv.backend == ("native" if native_ingest.available() else "python")
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
        "for m in ('serve.native_ingest', 'serve.stats_http', 'cli.serve', 'data.native_loader',\n"
        "          'models.fuse', 'utils.native_build', 'cli.evaluate', 'cli.audit',\n"
        "          'cli.extract_segments', 'cli.export', 'cli.setup_coughvid', 'models.export',\n"
        "          'preprocessing', 'augmentation'):\n"
        "    assert p.__name__ + '.' + m in sys.modules, m\n"
        "print('ok', len([n for n in sys.modules if n.startswith(p.__name__)]))\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=_REPO, capture_output=True, text=True,
        timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")
    assert int(out.stdout.split()[1]) >= 42


# -- both socket tiers: the JAX package's tests/test_serve.py, on each backend ----

BACKENDS = ["python", "native"]


def _need(backend: str) -> None:
    if backend == "native" and not native_ingest.available():
        pytest.skip("no C++ toolchain")


def _cough(seed: int, seconds: float, pad: int = 0) -> np.ndarray:
    wave = synth.synthetic_cough(seed, seconds).astype(np.float32)
    if pad:
        wave = np.concatenate([wave, np.zeros(pad, np.float32)])
    return wave[: wave.size // CHUNK * CHUNK]


@pytest.mark.parametrize("backend", BACKENDS)
def test_eager_silent_tenant_does_not_stall_the_tick(weights, backend):
    """A tenant that opens a slot and sends nothing must not stall the one
    that feeds: after one tick period the server ticks and zero-fills."""
    _need(backend)
    wave = _cough(5, 2.0)
    n_chunks = wave.size // CHUNK
    with _make_server(weights, num_streams=2, backend=backend) as srv:
        with DetectionClient(*srv.address) as active, DetectionClient(*srv.address) as silent:
            sid = active.open_stream()
            silent.open_stream()
            for t in range(n_chunks):
                active.send_audio(sid, wave[t * CHUNK : (t + 1) * CHUNK])
            assert _wait(lambda: srv.stats()["ticks"] >= n_chunks, 30.0)
            assert active.events(timeout=5.0)


@pytest.mark.parametrize("backend", BACKENDS)
def test_eager_all_idle_never_ticks(weights, backend):
    """While no open slot has a full chunk nobody is stalled, so no
    deadline tick fires; a completed chunk ticks."""
    _need(backend)
    with _make_server(weights, num_streams=2, backend=backend) as srv:
        with DetectionClient(*srv.address) as c:
            sid = c.open_stream()
            time.sleep(5 * CHUNK / 16000)
            assert srv.stats()["ticks"] == 0
            c.send_audio(sid, np.zeros(CHUNK // 2, np.float32))
            time.sleep(3 * CHUNK / 16000)
            assert srv.stats()["ticks"] == 0
            c.send_audio(sid, np.zeros(CHUNK // 2, np.float32))
            assert _wait(lambda: srv.stats()["ticks"] >= 1)


@pytest.mark.parametrize("backend", BACKENDS)
def test_eager_liveness_inf_is_pure_lockstep(weights, backend):
    """liveness_seconds=inf: a silent tenant does stall the tick."""
    _need(backend)
    with _make_server(weights, num_streams=2, backend=backend, liveness_seconds=float("inf")) as srv:
        with DetectionClient(*srv.address) as active, DetectionClient(*srv.address) as silent:
            sid = active.open_stream()
            silent.open_stream()
            active.send_audio(sid, np.ones(3 * CHUNK, np.float32))
            time.sleep(5 * CHUNK / 16000)
            assert srv.stats()["ticks"] == 0


@pytest.mark.parametrize("backend", BACKENDS)
def test_eager_mid_stream_pause_does_not_perturb_events(weights, backend):
    """A pause of many liveness periods mid-stream leaves the events those
    of the in-process detector: an all-idle server freezes the clock."""
    _need(backend)
    state_dict, cfg = weights
    wave = _cough(11, 1.5, pad=8000)
    n_chunks = wave.size // CHUNK
    ref = StreamingDetector(variables=state_dict, config=cfg, device="cpu", num_streams=1,
                            chunk_size=CHUNK, confidence_threshold=0.0, debounce_seconds=0.5)
    expected = ref.process_chunk(wave)
    assert expected
    with _make_server(weights, num_streams=1, backend=backend) as srv:
        with DetectionClient(*srv.address) as c:
            sid = c.open_stream()
            for t in range(n_chunks):
                if t == n_chunks // 2:
                    assert _wait(lambda: srv.stats()["ticks"] >= t)
                    time.sleep(4 * CHUNK / 16000)
                c.send_audio(sid, wave[t * CHUNK : (t + 1) * CHUNK])
            assert _wait(lambda: srv.stats()["ticks"] >= n_chunks)
            got = _collect(c, len(expected))
    assert len(got) == len(expected)
    for ev, ex in zip(got, expected):
        assert ev["stream"] == sid
        assert ev["time"] == pytest.approx(ex.time_seconds, abs=1e-6)
        assert ev["confidence"] == pytest.approx(ex.confidence, rel=1e-4)


def _collect(client, n: int, timeout: float = 5.0) -> list:
    """Events until `n` have come (the last frames may be on the wire),
    then whatever arrives in a short settle."""
    got = []
    _wait(lambda: got.extend(client.events()) or len(got) >= n, timeout)
    time.sleep(0.1)
    return got + client.events()


@pytest.mark.parametrize("backend", BACKENDS)
def test_two_tenants_with_different_thresholds(weights, backend):
    _need(backend)
    wave = _cough(5, 2.0)
    n_chunks = wave.size // CHUNK
    with _make_server(weights, num_streams=2, backend=backend) as srv:
        with DetectionClient(*srv.address) as hot, DetectionClient(*srv.address) as cold:
            s_hot, s_cold = hot.open_stream(threshold=0.0), cold.open_stream(threshold=1.1)
            for t in range(n_chunks):
                hot.send_audio(s_hot, wave[t * CHUNK : (t + 1) * CHUNK])
                cold.send_audio(s_cold, wave[t * CHUNK : (t + 1) * CHUNK])
            assert _wait(lambda: srv.stats()["ticks"] >= n_chunks)
            assert hot.events(timeout=5.0), "the threshold-0 tenant must receive events"
            assert not cold.events(timeout=0.5), "the threshold-1.1 tenant must receive none"


@pytest.mark.parametrize("backend", BACKENDS)
def test_thresh_frame_retunes_mid_stream(weights, backend):
    """Muted at 1.1 for the first half; THRESH 0.0 makes the same stream
    fire, without a reconnect."""
    _need(backend)
    wave = _cough(5, 4.0)
    n_chunks = wave.size // CHUNK
    half = n_chunks // 2
    with _make_server(weights, num_streams=1, backend=backend) as srv:
        with DetectionClient(*srv.address) as c:
            sid = c.open_stream(threshold=1.1)
            for t in range(half):
                c.send_audio(sid, wave[t * CHUNK : (t + 1) * CHUNK])
            assert _wait(lambda: srv.stats()["ticks"] >= half)
            assert not c.events(timeout=0.3), "the muted tenant fired"
            c.set_threshold(sid, 0.0)
            for t in range(half, n_chunks):
                c.send_audio(sid, wave[t * CHUNK : (t + 1) * CHUNK])
            assert _wait(lambda: srv.stats()["ticks"] >= n_chunks)
            assert c.events(timeout=5.0), "the retuned tenant must fire"


@pytest.mark.parametrize("backend", BACKENDS)
def test_slot_reuse_restores_default_threshold_and_retimes(weights, backend):
    """The next tenant of a slot gets the server default back, times from
    its own open on the hop grid, and no event from a window over the
    padding before its audio; the first tenant's events never reach it."""
    _need(backend)
    wave = _cough(5, 2.0)
    n_chunks = wave.size // CHUNK
    with _make_server(weights, num_streams=1, backend=backend) as srv:
        with DetectionClient(*srv.address) as a:
            sid = a.open_stream(threshold=1.1)
            for t in range(n_chunks):
                a.send_audio(sid, wave[t * CHUNK : (t + 1) * CHUNK])
            assert _wait(lambda: srv.stats()["ticks"] >= n_chunks)
            assert not a.events(timeout=0.5)
            a.close_stream(sid)
        assert _wait(lambda: srv.stats()["open_streams"] == 0)
        with DetectionClient(*srv.address) as b:
            assert b.open_stream() == sid  # the same slot, a new generation
            target = srv.stats()["ticks"] + n_chunks
            for t in range(n_chunks):
                b.send_audio(sid, wave[t * CHUNK : (t + 1) * CHUNK])
            assert _wait(lambda: srv.stats()["ticks"] >= target)
            evs = b.events(timeout=5.0)
    assert evs
    for e in evs:
        assert e["stream"] == sid and e["time"] >= 1.0 - 1e-9
        assert e["time"] / 0.25 == pytest.approx(round(e["time"] / 0.25), abs=1e-6)


@pytest.mark.parametrize("backend", BACKENDS)
def test_stale_thresh_is_purged_on_release(weights, backend):
    """A muting THRESH still queued when its sender closes must not apply
    to the slot's next tenant."""
    _need(backend)
    wave = _cough(5, 2.0)
    n_chunks = wave.size // CHUNK
    with _make_server(weights, num_streams=1, backend=backend) as srv:
        with DetectionClient(*srv.address) as a:
            sid = a.open_stream(threshold=0.0)
            a.set_threshold(sid, 1.1)
            a.close_stream(sid)
        assert _wait(lambda: srv.stats()["open_streams"] == 0)
        with DetectionClient(*srv.address) as b:
            sid2 = b.open_stream(threshold=0.0)
            base = srv.stats()["ticks"]
            for t in range(n_chunks):
                b.send_audio(sid2, wave[t * CHUNK : (t + 1) * CHUNK])
            assert _wait(lambda: srv.stats()["ticks"] >= base + n_chunks)
            assert b.events(timeout=5.0), "a stale THRESH retune leaked to the next tenant"


# -- the native plane ------------------------------------------------------------------


def test_native_backend_binds_only_after_start(weights):
    """The C++ plane grants slots the moment it binds, so it binds in
    start(), after the warm tick."""
    _need("native")
    srv = _make_server(weights, backend="native")
    assert srv.address is None and srv._ingest is None
    with srv:
        assert srv.address is not None
        with DetectionClient(*srv.address) as c:
            assert isinstance(c.open_stream(), int)


def test_native_backend_event_parity_and_reuse(weights):
    """Timer ticks on the C++ plane: events equal the in-process detector's
    (a timer tick may land between OPENED and the first AUDIO, so the lane
    may first score whole ticks of silence: the offset is searched), a full
    pool refuses, disconnect frees the slots, a reused slot keeps the
    timing contract, and a protocol violation severs only its sender."""
    _need("native")
    import socket as socketlib

    state_dict, cfg = weights
    wave = _cough(7, 1.5, pad=8000)
    n_chunks = wave.size // CHUNK

    def expected_for_offset(k: int) -> list:
        ref = StreamingDetector(variables=state_dict, config=cfg, device="cpu", num_streams=1,
                                chunk_size=CHUNK, confidence_threshold=0.0, debounce_seconds=0.5)
        return ref.process_chunk(np.concatenate([np.zeros(k * CHUNK, np.float32), wave]))

    def matches(got, expected) -> bool:
        return len(got) == len(expected) and all(
            abs(ev["time"] - ex.time_seconds) < 1e-6
            and ev["confidence"] == pytest.approx(ex.confidence, rel=1e-4)
            for ev, ex in zip(got, expected)
        )

    with _make_server(weights, num_streams=2, tick_policy="timer", backend="native") as srv:
        assert srv.backend == "native"

        def feed_and_collect(client, sid):
            base = srv.stats()["dispatched"]
            for t in range(n_chunks):
                client.send_audio(sid, wave[t * CHUNK : (t + 1) * CHUNK])
            assert _wait(lambda: srv.stats()["ticks"] >= base + n_chunks + 4, (n_chunks + 10) * 0.1 + 5)
            return client.events(timeout=3.0)

        with DetectionClient(*srv.address) as ca:
            sa = ca.open_stream()
            got = feed_and_collect(ca, sa)
            assert got and all(e["stream"] == sa for e in got)
            assert any(matches(got, expected_for_offset(k)) for k in range(6)), got[:3]
            sb = ca.open_stream()
            with pytest.raises(ServerRefused):
                ca.open_stream()
            assert srv.stats()["refused"] == 1
        assert _wait(lambda: srv.stats()["open_streams"] == 0)

        with DetectionClient(*srv.address) as cb:
            s2 = cb.open_stream()
            assert s2 in (sa, sb)
            times = [e["time"] for e in feed_and_collect(cb, s2)]
            assert len(times) >= 2 and all(t >= 1.0 - 1e-9 for t in times)
            assert all(b - a >= 0.5 - 1e-6 for a, b in zip(times, times[1:]))  # debounce
            assert all(t / 0.05 == pytest.approx(round(t / 0.05), abs=1e-4) for t in times)

        bad = socketlib.create_connection(srv.address)
        bad.sendall(protocol.encode(protocol.AUDIO, 0, b"123"))
        frame = protocol.read_frame(bad)
        assert frame is not None and frame.type == protocol.ERROR
        assert protocol.read_frame(bad) is None
        bad.close()
        with DetectionClient(*srv.address) as cc:
            assert isinstance(cc.open_stream(), int)


def test_auto_backend_resolves_native_for_both_policies(weights):
    _need("native")
    for policy in ("timer", "eager"):
        srv = _make_server(weights, tick_policy=policy, backend="auto", num_streams=2)
        try:
            assert srv.backend == "native", policy
        finally:
            srv.stop()


@pytest.mark.parametrize("h2d_dtype", ["int16", "mulaw"])
def test_native_assembly_matches_the_host_quantizers(h2d_dtype):
    """The C++ plane's float32 assembly passes the wire samples through;
    its int16 and μ-law assembly equal quantize_i16 / quantize_mulaw bit
    for bit, clipping and non-finite samples included."""
    _need("native")
    import socket as socketlib

    quantize, dtype = {"int16": (quantize_i16, np.int16), "mulaw": (quantize_mulaw, np.uint8)}[h2d_dtype]
    ing = native_ingest.NativeIngest("localhost", 0, num_streams=2, chunk=CHUNK, buffer_cap=4 * CHUNK)
    try:
        rng = np.random.default_rng(7)
        wave = rng.uniform(-1.2, 1.2, CHUNK).astype(np.float32)
        wave[7:10] = [np.nan, np.inf, -np.inf]
        sock = socketlib.create_connection(ing.address)
        sock.sendall(protocol.encode(protocol.OPEN))
        frame = protocol.read_frame(sock)
        assert frame is not None and frame.type == protocol.OPENED
        sid = frame.stream
        assert _wait(lambda: [g[:1] for g in ing.granted()] == [(sid,)], 5.0)
        for out in (np.zeros((2, CHUNK), np.float32), np.zeros((2, CHUNK), dtype)):
            sock.sendall(protocol.encode_audio(sid, wave))
            assert _wait(lambda: ing.readiness() == 2, 5.0)
            assert ing.assemble(out) == 1  # assemble consumes the chunk
            want = wave if out.dtype == np.float32 else quantize(wave)
            np.testing.assert_array_equal(out[sid], want)
            silence = 128 if out.dtype == np.uint8 else 0
            assert np.all(out[1 - sid] == silence)
        sock.close()
    finally:
        ing.stop()
    assert ing.stats()["connections"] == 1  # the snapshot taken at stop
    assert ing.readiness() == 0 and ing.granted() == []


@pytest.mark.parametrize("h2d_dtype", ["float32", "int16", "mulaw"])
def test_native_events_equal_python_tier_detector_and_four_workers(weights, h2d_dtype):
    """Eager lockstep over four streams and two clients: the native plane
    (one ingest worker and four) and the python tier deliver the events of
    the in-process detector fed the host quantizer's output."""
    _need("native")
    state_dict, cfg = weights
    audio = np.stack([_cough(s, 1.5, pad=8000) for s in (7, 3, 11, 5)])
    n_chunks = audio.shape[1] // CHUNK
    quantize = {"float32": lambda x: x, "int16": quantize_i16, "mulaw": quantize_mulaw}[h2d_dtype]
    ref = StreamingDetector(variables=state_dict, config=cfg, device="cpu", num_streams=4,
                            chunk_size=CHUNK, confidence_threshold=0.0, debounce_seconds=0.5)
    want = []
    for t in range(n_chunks):
        want += ref.collect_events(ref.tick_async(quantize(audio[:, t * CHUNK : (t + 1) * CHUNK])))
    want = sorted((d.stream, round(d.time_seconds, 6), d.confidence) for d in want)
    assert want
    runs = {}
    for backend, workers in (("native", 1), ("native", 4), ("python", 1)):
        srv = _make_server(weights, backend=backend, ingest_workers=workers, h2d_dtype=h2d_dtype,
                           liveness_seconds=float("inf"))
        with srv, DetectionClient(*srv.address) as c0, DetectionClient(*srv.address) as c1:
            owner = [c0, c1, c0, c1]
            sids = [owner[s].open_stream() for s in range(4)]
            for t in range(n_chunks):
                for s in range(4):
                    owner[s].send_audio(sids[s], audio[s, t * CHUNK : (t + 1) * CHUNK])
            assert _wait(lambda: srv.stats()["ticks"] >= n_chunks)
            lane = {sid: s for s, sid in enumerate(sids)}
            got = _collect(c0, 1) + _collect(c1, 1)
        runs[backend, workers] = sorted((lane[e["stream"]], round(e["time"], 6), e["confidence"]) for e in got)
    for key, got in runs.items():
        assert [g[:2] for g in got] == [w[:2] for w in want], key
        np.testing.assert_allclose([g[2] for g in got], [w[2] for w in want], rtol=1e-4, err_msg=str(key))
    assert runs["native", 1] == runs["native", 4]


# -- the stats sidecar and the daemon CLI -------------------------------------------


def test_stats_http_sidecar():
    """/healthz gates on readiness, /stats is a fresh snapshot each
    request, unknown paths 404, and a stats() failure is a 500 that the
    sidecar survives."""
    import json
    import urllib.error
    import urllib.request

    state = {"n": 0, "boom": False}

    def get_stats():
        if state["boom"]:
            raise RuntimeError("synthetic stats failure")
        state["n"] += 1
        return {"ticks": state["n"]}

    srv = StatsHttpServer(get_stats, port=0)
    try:
        base = "http://{}:{}".format(*srv.address)

        def get(path):
            try:
                with urllib.request.urlopen(base + path, timeout=5) as r:
                    return r.status, r.read()
            except urllib.error.HTTPError as e:
                return e.code, e.read()

        assert get("/healthz")[0] == 503
        srv.set_ready(True)
        assert get("/healthz") == (200, b"ok")
        s1, s2 = json.loads(get("/stats")[1]), json.loads(get("/stats")[1])
        assert s2["ticks"] == s1["ticks"] + 1
        assert get("/nope")[0] == 404
        state["boom"] = True
        code, body = get("/stats")
        assert code == 500 and b"synthetic" in body
        state["boom"] = False
        assert get("/stats")[0] == 200
        srv.set_ready(False)
        assert get("/healthz")[0] == 503
    finally:
        srv.stop()


@pytest.fixture(scope="module")
def pt_path(weights, tmp_path_factory):
    from cough_detector_tpu_torch.train.checkpoint import export_torch_checkpoint

    path = tmp_path_factory.mktemp("serve_cli") / "m.pt"
    export_torch_checkpoint(str(path), *weights)
    return str(path)


def test_cli_smoke(pt_path, capsys):
    """In-process: the readiness line first, stats lines, and the last
    line serving false once --max-seconds ends it."""
    import json

    from cough_detector_tpu_torch.cli import serve as serve_cli

    backend = "native" if native_ingest.available() else "python"
    serve_cli.main(["--model", pt_path, "--port", "0", "--streams", "2", "--max-seconds", "0.5",
                    "--stats-interval", "0.2", "--device", "cpu", "--backend", backend])
    lines = [json.loads(line) for line in capsys.readouterr().out.strip().splitlines()]
    assert lines[0]["serving"] is True and lines[0]["backend"] == backend and lines[0]["device"] == "cpu"
    assert len(lines) >= 3 and lines[-1]["serving"] is False and lines[-1]["backend"] == backend


def _spawn_cli(argv, readiness_timeout: float = 120.0):
    """Popen `python -m cough_detector_tpu_torch.cli.serve`; returns (proc,
    readiness line, finish, read_stderr). stderr drains on a thread so a
    chatty child never blocks on a full pipe, and a watchdog bounds the
    readiness read; finish() reads stdout to the child's exit."""
    import threading

    proc = subprocess.Popen(
        [sys.executable, "-m", "cough_detector_tpu_torch.cli.serve", *argv],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=_REPO,
    )
    err = []
    drain = threading.Thread(target=lambda: err.append(proc.stderr.read()), daemon=True)
    drain.start()
    watchdog = threading.Timer(readiness_timeout, proc.kill)
    watchdog.start()
    try:
        line = proc.stdout.readline()
    finally:
        watchdog.cancel()

    def finish(timeout: float = 60.0) -> str:
        killer = threading.Timer(timeout, proc.kill)
        killer.start()
        try:
            rest = proc.stdout.read()
            proc.wait(timeout=timeout)
        finally:
            killer.cancel()
        return rest

    def read_stderr() -> str:
        drain.join(timeout=30)
        return err[0] if err else ""

    return proc, line, finish, read_stderr


@pytest.mark.parametrize("h2d_dtype", ["float32", "int16", "mulaw"])
def test_cli_native_daemon_serves_reports_and_stops_on_sigterm(weights, pt_path, h2d_dtype):
    """The daemon as users start it, on the C++ plane and the CPU: the
    readiness line carries the stats address; /healthz is 200 and /stats
    the daemon's counters while it serves; its events equal the python
    tier's and the in-process detector's on the same quantized audio; and
    SIGTERM ends it with exit 0 and a last line serving false."""
    _need("native")
    import json
    import signal
    import urllib.request

    state_dict, cfg = weights
    audio = np.stack([_cough(7, 1.5, pad=8000), _cough(3, 1.5, pad=8000)])
    n_chunks = audio.shape[1] // CHUNK
    quantize = {"float32": lambda x: x, "int16": quantize_i16, "mulaw": quantize_mulaw}[h2d_dtype]

    def serve(address, stats):
        with DetectionClient(*address) as c:
            sids = [c.open_stream(), c.open_stream()]
            for t in range(n_chunks):
                for s in range(2):
                    c.send_audio(sids[s], audio[s, t * CHUNK : (t + 1) * CHUNK])
            assert _wait(lambda: stats()["ticks"] >= n_chunks)
            lane = {sid: s for s, sid in enumerate(sids)}
            return sorted((lane[e["stream"]], round(e["time"], 6), e["confidence"]) for e in _collect(c, 1))

    proc, first_line, finish, read_stderr = _spawn_cli([
        "--model", pt_path, "--port", "0", "--streams", "2", "--threshold", "0", "--tick-policy", "eager",
        "--liveness", "inf", "--backend", "native", "--h2d-dtype", h2d_dtype, "--stats-port", "0",
        "--stats-interval", "30", "--device", "cpu",
    ])
    try:
        first = json.loads(first_line)
        assert first["serving"] is True and first["backend"] == "native" and first["h2d_dtype"] == h2d_dtype
        base = "http://{}:{}".format(*first["stats_http"])

        def http_stats():
            with urllib.request.urlopen(base + "/stats", timeout=5) as r:
                return json.loads(r.read())

        with urllib.request.urlopen(base + "/healthz", timeout=5) as r:
            assert r.status == 200
        daemon = serve((first["host"], first["port"]), http_stats)
        # The plane handles the clients' closes on its own threads: wait
        # for the count to reach 0 rather than reading it once.
        assert _wait(lambda: http_stats()["open_streams"] == 0)
        stats = http_stats()
        assert stats["backend"] == "native" and stats["dispatched"] >= n_chunks and stats["open_streams"] == 0
        proc.send_signal(signal.SIGTERM)
        rest = finish()
    finally:
        proc.kill()
    err = read_stderr()
    assert proc.returncode == 0, err
    assert "Traceback" not in err
    assert json.loads(rest.strip().splitlines()[-1])["serving"] is False

    with _make_server(weights, num_streams=2, backend="python", h2d_dtype=h2d_dtype,
                      liveness_seconds=float("inf")) as srv:
        python = serve(srv.address, srv.stats)
    ref = StreamingDetector(variables=state_dict, config=cfg, device="cpu", num_streams=2,
                            chunk_size=CHUNK, confidence_threshold=0.0, debounce_seconds=0.5)
    want = []
    for t in range(n_chunks):
        want += ref.collect_events(ref.tick_async(quantize(audio[:, t * CHUNK : (t + 1) * CHUNK])))
    want = sorted((d.stream, round(d.time_seconds, 6), d.confidence) for d in want)
    assert want and [d[:2] for d in daemon] == [p[:2] for p in python] == [w[:2] for w in want]
    np.testing.assert_allclose([d[2] for d in daemon], [w[2] for w in want], rtol=1e-4)
    np.testing.assert_allclose([d[2] for d in daemon], [p[2] for p in python], rtol=1e-6)


def test_server_over_a_mesh_equals_one_device(weights):
    """Four slots over ["cpu", "cpu"], two a device: every stream's events
    equal the one-device detector's on the same audio."""
    state_dict, cfg = weights
    waves = np.stack([synth.synthetic_cough(7 + i, 1.5) * (0.4 + 0.2 * i) for i in range(4)])
    n_chunks = waves.shape[1] // CHUNK
    waves = waves[:, : n_chunks * CHUNK].astype(np.float32)
    ref = StreamingDetector(
        variables=state_dict, config=cfg, device="cpu", num_streams=4, chunk_size=CHUNK,
        confidence_threshold=0.0, debounce_seconds=0.5, mesh=False,
    )
    expected = ref.process_chunk(waves)
    assert expected
    with _make_server(weights, mesh=["cpu", "cpu"], liveness_seconds=float("inf")) as srv:
        assert srv._detector.mesh.size == 2
        with DetectionClient(*srv.address) as c:
            sids = [c.open_stream() for _ in range(4)]
            for t in range(n_chunks):
                for i, sid in enumerate(sids):
                    c.send_audio(sid, waves[i, t * CHUNK : (t + 1) * CHUNK])
            assert _wait(lambda: srv.stats()["ticks"] >= n_chunks)
            got = []
            _wait(lambda: got.extend(c.events()) or len(got) >= len(expected), 5.0)
            time.sleep(0.1)
            got += c.events()
    assert sorted(sids) == [0, 1, 2, 3] and len(got) == len(expected)
    key = lambda e: (e[1], e[0])  # noqa: E731
    got = sorted(((ev["stream"], ev["time"], ev["confidence"]) for ev in got), key=key)
    want = sorted(((d.stream, d.time_seconds, d.confidence) for d in expected), key=key)
    for (s, t, p), (ws, wt, wp) in zip(got, want):
        assert s == ws and t == pytest.approx(wt, abs=1e-6) and p == pytest.approx(wp, rel=1e-4)
