"""The port's bench: the JAX package's `bench.py`, in PyTorch on the card.

    python -m cough_detector_tpu_torch.cli.bench [--batch B] [--mode high|serve|bf16]
        [--trace DIR] [--fresh-h2d] [--device cuda]
    python -m cough_detector_tpu_torch.cli.bench --serving [--streams S] [--precision high|serve]
    python -m cough_detector_tpu_torch.cli.bench --serving-sweep [--precision high|serve]
    python -m cough_detector_tpu_torch.cli.bench --daemon [--streams S] [--clients M] [--seconds T]
        [--backend python|native|auto] [--loadgen python|native] [--h2d float32|int16|mulaw]
        [--uplink SECONDS]
    python -m cough_detector_tpu_torch.cli.bench --daemon-ramp [--seconds T] [--clients M] ...

Each mode prints one JSON record a run, under the JAX bench's metric names
and keys, plus "device" (the card's name, or "cpu"):

  * the headline (`main`): raw 1 s, 16 kHz waveforms → the stacked (90, 101)
    features (`extract_features_fast`, the hand-written kernel pair on the
    card) → the residual classifier's logits, in clips/s. B = 16384 clips
    resident on the device (uploaded before timing), seeded weights, float32
    with TF32 off ("high"). The timed region is one captured program
    (`utils/graphs.Programs`): one warm call captures it, then 20 replays
    chain a scalar (`logits.sum() + acc`) and one host fetch of it ends the
    window. An earlier line gives the same window by CUDA events.
    `vs_baseline` is the value over 10,000 clips/s, the north-star target in
    BASELINE.md, not a measured time. `--fresh-h2d` adds the
    ingest-inclusive record: int16 batches of min(B, 4096) uploaded inside
    the timed region on a copy stream, one ahead of the compute;
  * `--serving` (`serving_bench`): S streams ticked with 100 ms chunks by
    the detector's captured tick (`ring.StreamStep`), the sustained tick
    (ticks back to back, then one fetch) and the synchronous tick's p50.
    Every fill key of the tick is captured before the timed loops;
  * `--daemon` (`daemon_bench`): the socket tier end to end, client
    processes feeding real-time frames to a timer-policy `DetectionServer`.
    The client children (`_daemon_client_main`, or the port's C++ load
    generator, native/cdt_loadgen.cpp) never initialise CUDA.

`--device` defaults to the card and fails without one; the CPU runs only
when asked (`--device cpu`). The JAX package's bench.py stays its own.
"""

from __future__ import annotations

import dataclasses
import gc
import json
import os
import subprocess
import sys
import tempfile
import time
from collections import Counter
from pathlib import Path
from typing import Callable, Dict, List, NamedTuple, Optional

import numpy as np
import torch

from ..config import default_config
from ..data import synth
from ..data.shards import dequantize_torch, quantize
from ..models import fold_batchnorm, init_weights, model_from_config, place_model
from ..ops import frontend, frontend_kernel
from ..serve import DetectionClient, DetectionServer
from ..stream import StreamingDetector, ring
from ..utils import graphs, native_build
from ..utils.device import resolve_device
from ..utils.observability import capture_trace, trace_span

BASELINE_CLIPS_PER_SEC = 10_000.0  # BASELINE.md's north-star target
MODES = ("high", "serve", "bf16")
SWEEP_STREAMS = (256, 1024, 4096, 8192, 16384, 18432, 20480)
RAMP_STREAMS = (512, 1024, 2048, 4096, 8192)
_REPO = Path(__file__).resolve().parents[2]


def seeded_weights(seed: int = 0) -> Dict[str, torch.Tensor]:
    """The shipped residual classifier's state dict, its weights drawn by
    `init_weights` from a CPU `torch.Generator` seeded with `seed`."""
    model = model_from_config(default_config("residual").model)
    return init_weights(model, torch.Generator().manual_seed(seed)).state_dict()


def _device_name(dev: torch.device) -> str:
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"


def _tile(base: np.ndarray, rows: int) -> np.ndarray:
    return np.ascontiguousarray(np.tile(base, (-(-rows // base.shape[0]), 1))[:rows])


def _launches() -> tuple:
    return frontend_kernel.SPECTRAL_LAUNCHES, frontend_kernel.EPILOGUE_LAUNCHES


def _released(dev: torch.device) -> None:
    """Return the memory of dropped programs and their pools to the card."""
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()


class Headline(NamedTuple):
    """What `main` measured and ran: its records, the last timed replay's
    features and logits (the program's static outputs), the waveforms and
    the model, the kernel launches over the timed replays, the timed window
    by CUDA events in ms a replay (None off the card), and `replay`, which
    runs the program once more and returns its chained scalar (for a
    profiler's look at the program)."""

    record: dict
    ingest_record: Optional[dict]
    features: torch.Tensor
    logits: torch.Tensor
    waves: torch.Tensor
    model: torch.nn.Module
    launches: Dict[str, int]
    event_ms: Optional[float]
    replay: Callable[[], torch.Tensor]


def _headline_model(mode: str, state_dict, dev: torch.device) -> torch.nn.Module:
    """The residual classifier in `mode`: "high" float32, "serve" TF32 bulk
    convs, "bf16" bfloat16 compute on batch-norm-folded weights."""
    mcfg = default_config("residual").model
    if mode == "bf16":
        mcfg = dataclasses.replace(mcfg, compute_dtype="bfloat16")
    model = model_from_config(mcfg, "serve" if mode == "serve" else "high")
    weights = seeded_weights() if state_dict is None else state_dict
    if mode == "bf16":
        weights = fold_batchnorm(weights, mcfg.model_type)
    model.load_state_dict({k: torch.as_tensor(v) for k, v in weights.items()})
    return place_model(model, dev)


def main(
    batch: Optional[int] = None,
    n_iters: int = 20,
    mode: str = "high",
    trace: Optional[str] = None,
    fresh_h2d: bool = False,
    device="cuda",
    state_dict=None,
) -> Headline:
    """The headline record (module docstring), printed and returned.

    mode: "high" (float32, TF32 off: the 1e-3 parity budget), "serve" (TF32
    bulk convs) or "bf16" (bfloat16 compute, batch norm folded); the last
    two add "mode" to the records. trace: a directory for a torch.profiler
    trace of 3 more replays after the measurement. fresh_h2d: also the
    ingest-inclusive record. state_dict: the classifier's weights in the
    reference layout (default `seeded_weights()`). The TF32 flags are
    restored on return."""
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    dev = resolve_device(device)
    cuda = dev.type == "cuda"
    tf32 = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    try:
        return _main(16384 if batch is None else batch, n_iters, mode, trace, fresh_h2d, dev, cuda, state_dict)
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32


def _record(metric: str, value: float, mode: str, dev: torch.device, **extra) -> dict:
    # vs_baseline from the rounded value, so a reader recomputing it from
    # the printed value gets the printed ratio.
    value = round(value, 1)
    rec = {"metric": metric, "value": value, "unit": "clips/s/chip",
           "vs_baseline": round(value / BASELINE_CLIPS_PER_SEC, 3), **extra}
    if mode != "high":
        rec["mode"] = mode
    rec["device"] = _device_name(dev)
    return rec


@torch.no_grad()
def _main(batch, n_iters, mode, trace, fresh_h2d, dev, cuda, state_dict) -> Headline:
    model = _headline_model(mode, state_dict, dev)
    fcfg = default_config("residual").features

    def forward(waves: torch.Tensor) -> tuple:
        feats = frontend.extract_features_fast(waves, fcfg, device=dev)
        return feats, model(feats)

    def timed(static) -> tuple:
        feats, logits = forward(static["waves"])
        return feats, logits, logits.float().sum() + static["acc"]

    base = synth.fixture_batch(min(batch, 256), 1.0, seed=0)
    waves = torch.from_numpy(_tile(base, batch)).to(dev)
    programs = graphs.Programs(dev, name="bench")

    def call(acc):
        return programs("headline", timed, {"waves": waves, "acc": acc}, copy=(False, False, True))

    # The warm call runs the program once and captures it; its fetch waits
    # for both. The timed window chains the scalar through every replay
    # and ends with one host fetch of it, so nothing it enqueued escapes.
    feats, logits, acc = call(torch.zeros((), device=dev))
    float(acc)
    before = _launches()
    events = [torch.cuda.Event(enable_timing=True) for _ in range(2)] if cuda else None
    t0 = time.perf_counter()
    if cuda:
        events[0].record()
    for _ in range(n_iters):
        feats, logits, acc = call(acc)
    if cuda:
        events[1].record()
    float(acc)
    dt = (time.perf_counter() - t0) / n_iters
    launches = dict(zip(("spectral", "epilogue"), (a - b for a, b in zip(_launches(), before))))
    event_ms = events[0].elapsed_time(events[1]) / n_iters if cuda else None
    record = _record("1s_clips_per_sec_per_chip_end_to_end", batch / dt, mode, dev)
    print(
        f"headline [{mode}] B={batch} on {record['device']}: {n_iters} replays of one captured program, "
        f"{dt * 1e3:.4f} ms a replay to the host fetch, "
        + (f"{event_ms:.4f} ms by CUDA events" if cuda else "CUDA events not measured (cpu)")
        + f"; front-end launches over the replays {launches}",
        flush=True,
    )
    if trace:
        with capture_trace(trace):
            with trace_span("bench_headline_forward"):
                for _ in range(3):
                    feats, logits, acc = call(acc)
            float(acc)
        record["trace"] = trace
    print(json.dumps(record), flush=True)

    ingest = None
    if fresh_h2d:
        ingest = _ingest_inclusive(base, min(batch, 4096), forward, mode, dev, cuda)
        print(json.dumps(ingest), flush=True)

    def replay() -> torch.Tensor:
        with torch.no_grad():
            return call(acc)[2]

    return Headline(record, ingest, feats, logits, waves, model, launches, event_ms, replay)


def _ingest_inclusive(base, fb, forward, mode, dev, cuda, fresh_iters: int = 4) -> dict:
    """The ingest-inclusive record: each iteration uploads the next int16
    batch (non_blocking, from one of two pinned host buffers holding `base`
    and `base[::-1]`, so no upload repeats its predecessor) on a copy stream
    before the current batch's program, which dequantizes on the card.
    Events order the copies: a program waits for its batch's upload, and an
    upload into a device buffer waits until the program before it has
    copied that buffer in."""
    hosts = [torch.from_numpy(quantize(_tile(b, fb))) for b in (base, base[::-1])]
    if cuda:
        hosts = [h.pin_memory() for h in hosts]
    bufs = [torch.empty(h.shape, dtype=h.dtype, device=dev) for h in hosts]
    uploaded: List[Optional[torch.cuda.Event]] = [None, None]
    consumed: List[Optional[torch.cuda.Event]] = [None, None]
    copy_stream = torch.cuda.Stream(dev) if cuda else None
    programs = graphs.Programs(dev, name="bench_ingest")

    def timed(static) -> tuple:
        _, logits = forward(dequantize_torch(static["waves"]))
        return (logits.float().sum() + static["acc"],)

    def upload(i: int) -> None:
        if not cuda:
            bufs[i].copy_(hosts[i])
            return
        with torch.cuda.stream(copy_stream):
            if consumed[i] is not None:
                copy_stream.wait_event(consumed[i])
            bufs[i].copy_(hosts[i], non_blocking=True)
            uploaded[i] = copy_stream.record_event()

    def compute(i: int, acc: torch.Tensor) -> torch.Tensor:
        if cuda:
            torch.cuda.current_stream(dev).wait_event(uploaded[i])
        (acc,) = programs("ingest", timed, {"waves": bufs[i], "acc": acc})
        if cuda:
            consumed[i] = torch.cuda.current_stream(dev).record_event()
        return acc

    upload(0)
    acc = compute(0, torch.zeros((), device=dev))
    float(acc)
    t0 = time.perf_counter()
    for i in range(fresh_iters):
        upload((i + 1) % 2)  # the next batch's upload goes before this batch's compute
        acc = compute(i % 2, acc)
    float(acc)
    dt = (time.perf_counter() - t0) / fresh_iters
    return _record("1s_clips_per_sec_per_chip_ingest_inclusive", fb / dt, mode, dev,
                   batch=fb, h2d_bytes_per_iter=int(hosts[0].numel() * hosts[0].element_size()))


class Serving(NamedTuple):
    """What `serving_bench` ran: its record; every tick's packed events
    (warm ticks, sustained, synchronous, in order) with the chunk of
    `serving_audio(num_streams, 1600, n_unique)` each tick was fed and the
    fill it started from; and, for the two timed loops, the
    ticks a fill key ran and the replays its captured program gained (equal
    when no tick was captured inside them; empty off the card)."""

    record: dict
    packed: List[torch.Tensor]
    n_unique: int
    chunk_order: List[int]
    fills: List[int]
    timed_by_fill: Dict[int, int]
    replays_by_fill: Dict[int, int]

    def fired(self) -> List[np.ndarray]:
        """Each tick's (streams, windows) fired mask, from its packed rows."""
        s = self.record["num_streams"]
        return [p[3 + s:].cpu().numpy() > 0.5 for p in self.packed]


def serving_audio(num_streams: int, chunk: int, n_unique: int) -> np.ndarray:
    """(num_streams, chunk * n_unique) float32: synthetic coughs, one a
    stream for the first 256, tiled over the rest."""
    base = np.stack(
        [np.resize(synth.synthetic_cough(i, 2.0), chunk * n_unique) for i in range(min(num_streams, 256))]
    ).astype(np.float32)
    return _tile(base, num_streams)


def serving_bench(
    num_streams: int = 256,
    n_ticks: Optional[int] = None,
    precision_mode: str = "high",
    device="cuda",
    state_dict=None,
) -> Serving:
    """The multi-stream record: `num_streams` streams ticked with 100 ms
    chunks of synthetic coughs through a fresh detector's tick, driven
    directly (`det._step` on `det._state`) so the syncing is explicit.

    Warm-up runs one tick for every fill of the ring's cycle
    (`ring.tick_fills`: each is the first call of its key, which captures
    its graph on the card). Then the sustained tick: n_ticks - 1 ticks
    enqueued back to back, ended by one fetch of the last tick's fired
    mask (ticks are serially dependent through the state); then 12
    synchronous ticks, each fetched, for the p50. Real-time at this count
    iff the sustained tick takes under the 100 ms of audio it carries.
    The detector, its programs and their pool are released on return."""
    dev = resolve_device(device)
    cfg = default_config("residual")
    chunk = 1600  # 100 ms at 16 kHz — the reference mic chunk
    if n_ticks is None:
        n_ticks = int(max(16, min(100, 64_000_000 // (num_streams * chunk))))
    # The prepared audio stays near 64M samples whatever the count: a few
    # unique chunks, cycled (a tick's cost does not depend on its audio).
    n_unique = int(max(2, min(n_ticks, 64_000_000 // (num_streams * chunk))))
    det = StreamingDetector(
        variables=seeded_weights() if state_dict is None else state_dict, config=cfg,
        device=dev, num_streams=num_streams, precision_mode=precision_mode,
        chunk_size=chunk, confidence_threshold=0.7, smoothing_window=3,
        debounce_seconds=0.5, mesh=False,
    )
    try:
        return _serving_run(det, num_streams, n_ticks, n_unique, chunk, precision_mode, dev)
    finally:
        del det
        _released(dev)


@torch.no_grad()
def _serving_run(det, num_streams, n_ticks, n_unique, chunk, precision_mode, dev) -> Serving:
    audio = serving_audio(num_streams, chunk, n_unique)
    chunks = [torch.from_numpy(np.ascontiguousarray(audio[:, t * chunk:(t + 1) * chunk])).to(dev)
              for t in range(n_unique)]
    step, state = det._step, det._state
    packed, order, fills = [], [], []
    s = num_streams

    def tick(t: int) -> torch.Tensor:
        nonlocal state
        order.append(t % n_unique)
        fills.append(state.fill)
        state, ev = step(state, chunks[t % n_unique])
        packed.append(ev["packed"])
        return ev["packed"]

    def replays() -> Dict[int, int]:
        out: Counter = Counter()
        for p in det.tick_programs():
            for key, n in p.replays().items():
                out[key[2]] += n
        return dict(out)

    def keys() -> list:
        return [k for p in det.tick_programs() for k in p.keys]

    hop = int(det.config.features.sample_rate * det.stream_config.hop_duration)
    for t in range(len(ring.tick_fills(chunk, det.window_samples, hop))):
        last = tick(t)
    last[3 + s:].cpu()  # waits for every warm tick and capture
    warm_keys, warm_replays, first_timed = keys(), replays(), len(fills)

    t0 = time.perf_counter()
    for t in range(1, n_ticks):
        last = tick(t)
    last[3 + s:].cpu()  # the last tick's fired mask: waits for the whole chain
    sustained = (time.perf_counter() - t0) / (n_ticks - 1)

    sync = []
    for t in range(12):
        t0 = time.perf_counter()
        tick(t)[3 + s:].cpu()
        sync.append(time.perf_counter() - t0)
    det._state = state
    if keys() != warm_keys:
        raise RuntimeError(f"ticks were captured inside the timed loops: keys {keys()} after warm-up {warm_keys}")
    after = replays()
    replays_by_fill = {f: n - warm_replays.get(f, 0) for f, n in after.items() if n > warm_replays.get(f, 0)}
    timed_by_fill = dict(Counter(fills[first_timed:])) if after else {}

    # Only ticks that complete a window score (ROADMAP, "partial windows"),
    # so the sustained mean is over scoring and non-scoring ticks alike:
    # each kind's synchronous p50 goes on a line of its own.
    scores = [ring.tick_geometry(f, chunk, det.window_samples, hop)[0] > 0 for f in fills]
    n_sync = len(sync)
    split = {kind: [dt for dt, sc in zip(sync, scores[-n_sync:]) if sc == want]
             for kind, want in (("scoring", True), ("non-scoring", False))}
    print(
        f"serving [{num_streams} streams] on {_device_name(dev)}: sustained mean over {n_ticks - 1} ticks, "
        f"{sum(scores[first_timed:first_timed + n_ticks - 1])} of them scoring windows, {sustained * 1e3:.3f} ms; "
        "synchronous p50 " + ", ".join(
            f"{kind} {np.percentile(v, 50) * 1e3:.3f} ms ({len(v)} ticks)" if v else f"{kind} none"
            for kind, v in split.items()),
        flush=True,
    )
    capacity = int(num_streams * 0.1 / sustained)
    record = {
        "metric": "multi_stream_serving",
        "num_streams": num_streams,
        "precision": precision_mode,
        "n_ticks_timed": n_ticks - 1,
        "sustained_tick_ms": round(sustained * 1e3, 3),
        "sync_tick_p50_ms": round(float(np.percentile(sync, 50)) * 1e3, 3),
        "realtime_at_this_count": sustained < 0.1,
        "derived_stream_capacity_per_chip": capacity,
        "vs_baseline_256_streams": round(capacity / 256.0, 2),
        "device": _device_name(dev),
    }
    print(json.dumps(record), flush=True)
    return Serving(record, packed, n_unique, order, fills, timed_by_fill, replays_by_fill)


# -- the socket tier ---------------------------------------------------------------

_CLIENT_BOOT = (
    "import sys; sys.path.insert(0, {repo!r}); "
    "from cough_detector_tpu_torch.cli import bench; bench._daemon_client_main(sys.argv[1:])"
)


def _daemon_client_main(argv) -> None:
    """One load-generator child process (spawned by daemon_bench as a plain
    subprocess, with CUDA hidden): opens n_slots, prints READY, waits for GO
    on stdin, feeds one real-time frame per slot per tick (absolute-deadline
    pacing), drains events on a thread, prints `EVENTS <n> LATE <s>` and
    exits. A separate interpreter, so the harness's Python work never
    shares the interpreter lock with the server under test."""
    import threading

    host, port, n_slots, n_frames, tick_s, chunk = (
        argv[0], int(argv[1]), int(argv[2]), int(argv[3]), float(argv[4]), int(argv[5]),
    )
    clip = np.resize(synth.synthetic_cough(3, 2.0), chunk * (n_frames + 1)).astype(np.float32)
    client = DetectionClient(host, port)
    slots = [client.open_stream() for _ in range(n_slots)]
    done = threading.Event()
    got = [0]

    def drain():
        while not done.is_set():
            got[0] += len(client.events(timeout=0.2))
        got[0] += len(client.events())

    drainer = threading.Thread(target=drain, daemon=True)
    drainer.start()
    print("READY", flush=True)
    sys.stdin.readline()  # GO
    t0 = time.monotonic()
    next_t = t0 + tick_s
    for f in range(n_frames):
        delay = next_t - time.monotonic()
        if delay > 0:
            time.sleep(delay)
        next_t += tick_s
        lo = (f * chunk) % (clip.size - chunk)
        frame = clip[lo:lo + chunk]
        try:
            for sid in slots:
                client.send_audio(sid, frame)
        except OSError:
            break
    # How far behind the real-time schedule this generator finished: if the
    # client could not offer the load, the server's row is void.
    late = time.monotonic() - (t0 + n_frames * tick_s)
    time.sleep(0.5)  # let the tail tick's events arrive
    done.set()
    drainer.join(timeout=2.0)
    print(f"EVENTS {got[0]} LATE {late:.3f}", flush=True)
    client.close()


def _rss_kb() -> int:
    """This process's resident set in KiB (the server's slot rings, delivery
    queues and plane buffers are bounded, so it must plateau)."""
    with open("/proc/self/status") as fh:
        for line in fh:
            if line.startswith("VmRSS:"):
                return int(line.split()[1])
    return -1


def daemon_bench(
    num_streams: int = 256,
    n_clients: int = 8,
    seconds: float = 30.0,
    chunk: int = 1600,
    backend: str = "python",
    loadgen: str = "python",
    h2d_dtype: str = "float32",
    uplink_s: Optional[float] = None,
    device="cuda",
    state_dict=None,
) -> dict:
    """The socket tier end to end (serve/server.py), not the in-process
    engine: M loopback client processes feed real-time PCM frames across N
    stream slots of a timer-policy DetectionServer while its tick runs on
    `device`. Reports the tick cadence on the dispatch clock against the
    100 ms budget over an exact wall window, the server's tick and delivery
    percentiles, delivered and dropped events and samples, and this
    process's RSS at the start and the end. Real-time at N iff cadence holds
    (> 0.99 of the expected ticks) with no dropped samples and every client
    under 1 s late.

    loadgen="native" runs the port's C++ load generator
    (native/cdt_loadgen.cpp, built into build/native/; raises without g++)
    in place of the Python children: same READY/GO/EVENTS contract, wire
    bytes and clip cycle, without an interpreter's per-frame cost.
    uplink_s sends frames of that length less often at the same bandwidth
    (batched-uplink clients); the server still ticks every 100 ms."""
    if loadgen not in ("python", "native"):
        # A typo'd loadgen must not run the Python generators under a
        # mislabeled row.
        raise ValueError(f"unknown loadgen {loadgen!r}")
    dev = resolve_device(device)
    cfg = default_config("residual")
    server = DetectionServer(
        variables=seeded_weights() if state_dict is None else state_dict, config=cfg,
        device=dev, num_streams=num_streams, chunk_size=chunk, confidence_threshold=0.7,
        smoothing_window=3, debounce_seconds=0.5, tick_policy="timer", backend=backend,
        h2d_dtype=h2d_dtype, mesh=False,
    )
    tier = server.backend
    tick_s = chunk / cfg.features.sample_rate
    u_s = tick_s if uplink_s is None else float(uplink_s)
    u_chunk = int(round(u_s * cfg.features.sample_rate))
    n_frames = int(round(seconds / u_s))
    # The children must not touch the card: the server under test owns it.
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")

    clip_path = None
    try:
        if loadgen == "native":
            binary = str(native_build.build_executable("cdt_loadgen"))
            # The clip and cycle the Python generator feeds, as raw f32le.
            clip = np.resize(synth.synthetic_cough(3, 2.0), u_chunk * (n_frames + 1)).astype(np.float32)
            fd, clip_path = tempfile.mkstemp(suffix=".f32")
            with os.fdopen(fd, "wb") as fh:
                fh.write(clip.tobytes())

        def spawn(m: int) -> subprocess.Popen:
            if loadgen == "native":
                cmd = [binary, host, str(port), str(m), str(n_frames),
                       str(int(round(u_s * 1e6))), str(u_chunk), clip_path]
            else:
                cmd = [sys.executable, "-c", _CLIENT_BOOT.format(repo=str(_REPO)), host,
                       str(port), str(m), str(n_frames), repr(u_s), str(u_chunk)]
            return subprocess.Popen(cmd, stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True, env=env)

        with server:
            host, port = server.address
            per_client = [num_streams // n_clients + (1 if i < num_streams % n_clients else 0)
                          for i in range(n_clients)]
            procs = [spawn(m) for m in per_client]
            try:
                for p in procs:
                    line = p.stdout.readline()
                    if line.strip() != "READY":
                        raise RuntimeError(f"daemon bench client failed: {line!r}")
                # Ticks run during the open phase (the timer starts with the
                # first slot) stay out of the window, which is measured on
                # the dispatch clock: missed dispatches are the real-time
                # failure signal, delivery health shows in the lag
                # percentiles.
                d0 = server.stats()["dispatched"]
                rss0 = _rss_kb()
                t_start = time.monotonic()
                for p in procs:
                    p.stdin.write("GO\n")
                    p.stdin.flush()
                time.sleep(seconds)
                elapsed = time.monotonic() - t_start
                d1 = server.stats()["dispatched"]
                total_events, max_late = 0, 0.0
                for p in procs:
                    try:
                        out, _ = p.communicate(timeout=60)
                    except subprocess.TimeoutExpired:
                        p.kill()
                        out, _ = p.communicate()
                    for line in (out or "").splitlines():
                        if line.startswith("EVENTS "):
                            parts = line.split()
                            total_events += int(parts[1])
                            if len(parts) >= 4:
                                max_late = max(max_late, float(parts[3]))
                stats = server.stats()
                rss1 = _rss_kb()
            finally:
                for p in procs:
                    if p.poll() is None:
                        p.kill()
                    p.wait()
    finally:
        # The clip file must not outlive a failed run (a refused handshake
        # at a ramp's overflow point raises above).
        if clip_path is not None:
            try:
                os.unlink(clip_path)
            except OSError:
                pass
        server = None
        _released(dev)
    timed_ticks = d1 - d0
    cadence = timed_ticks / max(elapsed / tick_s, 1e-9)
    record = {
        "metric": "serving_daemon_socket_tier",
        "backend": tier,
        "loadgen": loadgen,
        "h2d_dtype": h2d_dtype,
        "num_streams": num_streams,
        "n_clients": n_clients,
        "uplink_frame_s": round(u_s, 3),
        "seconds": round(elapsed, 1),
        "ticks": timed_ticks,
        "tick_budget_ms": round(tick_s * 1e3, 1),
        "tick_ms_p50": stats.get("tick_ms_p50"),
        "tick_ms_p99": stats.get("tick_ms_p99"),
        "delivery_lag_ms_p50": stats.get("delivery_lag_ms_p50"),
        "delivery_lag_ms_p99": stats.get("delivery_lag_ms_p99"),
        "cadence": round(cadence, 4),
        "events_delivered": total_events,
        "events_dropped": stats["events_dropped"],
        "dropped_samples": stats["dropped_samples"],
        "max_client_late_s": round(max_late, 3),
        "rss_kb_start": rss0,
        "rss_kb_end": rss1,
        # Valid only if the generators offered the load on time.
        "realtime_at_this_count": bool(cadence > 0.99 and stats["dropped_samples"] == 0 and max_late < 1.0),
        "device": _device_name(dev),
    }
    print(json.dumps(record), flush=True)
    return record


# -- the command line ----------------------------------------------------------------


def _flag(argv: List[str], name: str, default, allowed=None, cast=str):
    """The value after `name` in argv, cast; an unknown value exits with a
    message: a typo'd tier must never run the default path under a
    mislabeled record."""
    if name not in argv:
        return default
    i = argv.index(name)
    if i + 1 >= len(argv):
        raise SystemExit(f"{name} needs a value")
    try:
        value = cast(argv[i + 1])
    except ValueError:
        raise SystemExit(f"{name}: cannot read {argv[i + 1]!r}") from None
    if allowed is not None and value not in allowed:
        raise SystemExit(f"{name} must be one of {sorted(allowed)}, got {value!r}")
    return value


def cli(argv: List[str]) -> None:
    """The bench's command line (module docstring). Every flag is read, and
    the device resolved, before anything runs."""
    backend = _flag(argv, "--backend", "python", {"python", "native", "auto"})
    loadgen = _flag(argv, "--loadgen", "python", {"python", "native"})
    h2d = _flag(argv, "--h2d", "float32", {"float32", "int16", "mulaw"})
    uplink = _flag(argv, "--uplink", None, cast=float)
    precision = _flag(argv, "--precision", "high", {"high", "serve"})
    mode = _flag(argv, "--mode", "high", set(MODES))
    streams = _flag(argv, "--streams", None, cast=int)
    clients = _flag(argv, "--clients", 8, cast=int)
    seconds = _flag(argv, "--seconds", None, cast=float)
    batch = _flag(argv, "--batch", None, cast=int)
    trace = _flag(argv, "--trace", None)
    try:
        dev = resolve_device(_flag(argv, "--device", "cuda"))
    except RuntimeError as err:
        raise SystemExit(f"the bench runs on a CUDA card unless --device cpu is given: {err}") from None
    daemon = dict(n_clients=clients, backend=backend, loadgen=loadgen, h2d_dtype=h2d, uplink_s=uplink, device=dev)
    if "--daemon-ramp" in argv:
        # The socket tier's ceiling: every row a real multi-client run at
        # that count, up to the first that is not real-time.
        for s in RAMP_STREAMS:
            rec = daemon_bench(num_streams=s, seconds=20.0 if seconds is None else seconds, **daemon)
            if not rec["realtime_at_this_count"]:
                break
    elif "--daemon" in argv:
        daemon_bench(num_streams=256 if streams is None else streams,
                     seconds=30.0 if seconds is None else seconds, **daemon)
    elif "--serving-sweep" in argv:
        # Every point a real run on a fresh detector at that count.
        for s in SWEEP_STREAMS:
            serving_bench(num_streams=s, precision_mode=precision, device=dev)
    elif "--serving" in argv:
        serving_bench(num_streams=256 if streams is None else streams, precision_mode=precision, device=dev)
    else:
        main(batch=batch, mode=mode, trace=trace, fresh_h2d="--fresh-h2d" in argv, device=dev)


if __name__ == "__main__":
    cli(sys.argv[1:])
