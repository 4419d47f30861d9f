"""Host-side live audio capture feeding the streaming engine, the port's
copy of `cough_detector_tpu/stream/mic.py`.

Capability match for the reference's microphone listener + device listing
(reference: src/inference.py:250-451), re-designed around one seam: a
*capture backend* object with `open(emit)` / `close()`. The listener never
branches on backend names — whichever adapter is installed pushes sample
blocks into a bounded queue, a worker drains it through the inference
engine, and detection events go to a pluggable sink. The same seam lets
tests drive the whole loop with an in-memory adapter (no PortAudio, no
hardware), which the reference's if/elif-per-backend layout cannot do. The capture
stacks (sounddevice, pyaudio) are imported at first use, never when this
module is imported.
"""

from __future__ import annotations

import functools
import importlib
import queue
import threading
import time
from typing import Callable, List, Optional, Tuple

import numpy as np


@functools.lru_cache(maxsize=None)
def _stack(name: str):
    """The capture module `name`, or None where it (or PortAudio under it)
    is not installed."""
    try:
        return importlib.import_module(name)
    except Exception:  # pragma: no cover - host audio stacks absent in CI
        return None


def sounddevice_available() -> bool:
    return _stack("sounddevice") is not None


def pyaudio_available() -> bool:
    return _stack("pyaudio") is not None


# ---------------------------------------------------------------------------
# Capture backends: anything with .open(emit) / .close()
# ---------------------------------------------------------------------------


class SoundDeviceCapture:  # pragma: no cover - needs PortAudio hardware
    """PortAudio capture via the sounddevice module."""

    name = "sounddevice"

    def __init__(self, sample_rate: int, block_size: int,
                 device_index: Optional[int] = None):
        self._kw = dict(
            samplerate=sample_rate, channels=1, dtype="float32",
            blocksize=block_size, device=device_index,
        )
        self._stream = None

    def open(self, emit: Callable[[np.ndarray], None]) -> None:
        def _cb(indata, _frames, _time, status):
            if status:
                print(f"[capture] sounddevice reported: {status}")
            emit(indata[:, 0].copy())

        self._stream = _stack("sounddevice").InputStream(callback=_cb, **self._kw)
        self._stream.start()

    def close(self) -> None:
        if self._stream is not None:
            self._stream.stop()
            self._stream.close()
            self._stream = None

    @staticmethod
    def input_devices() -> List[Tuple[int, str, int]]:
        return [
            (i, d["name"], d["max_input_channels"])
            for i, d in enumerate(_stack("sounddevice").query_devices())
            if d["max_input_channels"] > 0
        ]


class PyAudioCapture:  # pragma: no cover - needs PortAudio hardware
    """PortAudio capture via the pyaudio module."""

    name = "pyaudio"

    def __init__(self, sample_rate: int, block_size: int,
                 device_index: Optional[int] = None):
        self._sample_rate = sample_rate
        self._block_size = block_size
        self._device_index = device_index
        self._pa = None
        self._stream = None

    def open(self, emit: Callable[[np.ndarray], None]) -> None:
        pa_mod = _stack("pyaudio")
        self._pa = pa_mod.PyAudio()

        def _cb(in_data, _count, _time, _status):
            emit(np.frombuffer(in_data, dtype=np.float32))
            return (None, pa_mod.paContinue)

        self._stream = self._pa.open(
            format=pa_mod.paFloat32, channels=1, rate=self._sample_rate,
            input=True, input_device_index=self._device_index,
            frames_per_buffer=self._block_size, stream_callback=_cb,
        )
        self._stream.start_stream()

    def close(self) -> None:
        if self._stream is not None:
            self._stream.stop_stream()
            self._stream.close()
            self._stream = None
        if self._pa is not None:
            self._pa.terminate()
            self._pa = None

    @staticmethod
    def input_devices() -> List[Tuple[int, str, int]]:
        pa = _stack("pyaudio").PyAudio()
        try:
            out = []
            for i in range(pa.get_device_count()):
                info = pa.get_device_info_by_index(i)
                if info["maxInputChannels"] > 0:
                    out.append((i, info["name"], info["maxInputChannels"]))
            return out
        finally:
            pa.terminate()


class ArrayCapture:
    """In-memory adapter: replays a waveform in block_size pieces from a
    thread. Lets unit tests (and offline demos) exercise the identical
    queue/worker/sink path the hardware adapters use."""

    name = "array"

    def __init__(self, wave: np.ndarray, block_size: int,
                 realtime_factor: float = 0.0):
        self._wave = np.asarray(wave, np.float32)
        self._block = block_size
        self._sleep = realtime_factor
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()

    def open(self, emit: Callable[[np.ndarray], None]) -> None:
        self._stop.clear()

        def _feed():
            for lo in range(0, len(self._wave), self._block):
                if self._stop.is_set():
                    return
                emit(self._wave[lo : lo + self._block])
                if self._sleep:
                    time.sleep(self._sleep * self._block / 16000.0)

        self._thread = threading.Thread(target=_feed, daemon=True)
        self._thread.start()

    def close(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            self._thread = None

    def drained(self) -> bool:
        return self._thread is None or not self._thread.is_alive()


def resolve_capture(
    backend: str,
    sample_rate: int,
    block_size: int,
    device_index: Optional[int] = None,
):
    """Map a backend name ('auto' picks the first installed stack) to a
    capture adapter instance."""
    if backend == "auto":
        backend = (
            "sounddevice" if sounddevice_available()
            else "pyaudio" if pyaudio_available()
            else ""
        )
    if backend == "sounddevice" and sounddevice_available():
        return SoundDeviceCapture(sample_rate, block_size, device_index)
    if backend == "pyaudio" and pyaudio_available():
        return PyAudioCapture(sample_rate, block_size, device_index)
    raise RuntimeError(
        "no usable capture stack — install sounddevice or pyaudio, or pass "
        "a capture adapter explicitly"
    )


# ---------------------------------------------------------------------------
# Listener: queue → inference worker → detection sink
# ---------------------------------------------------------------------------


def _print_sink(timestamp, confidence: float) -> None:
    stamp = timestamp.isoformat(sep=" ", timespec="milliseconds")
    print(f"[cough] {stamp}  p={confidence:.3f}")


class RealtimeMicrophoneDetector:
    """Drives a capture adapter into a CoughDetectorInference engine
    (stream/detector.py).

    Reference-API compatible surface (ctor args, start/stop/run,
    on_detection) per src/inference.py:250-429; internally one adapter seam
    instead of per-backend code paths. Pass `capture` to inject any adapter
    (tests use ArrayCapture); otherwise `backend` resolves an installed
    hardware stack.
    """

    QUEUE_POLL_S = 0.25
    WORKER_JOIN_S = 2.0

    def __init__(
        self,
        inference_engine,
        sample_rate: int = 16000,
        chunk_duration: float = 0.1,
        device_index: Optional[int] = None,
        backend: str = "auto",
        capture=None,
        max_queued_blocks: int = 256,
    ):
        self.inference = inference_engine
        self.sample_rate = sample_rate
        self.chunk_size = int(sample_rate * chunk_duration)
        self.capture = capture if capture is not None else resolve_capture(
            backend, sample_rate, self.chunk_size, device_index
        )
        self.backend = self.capture.name
        self.on_detection: Optional[Callable] = None
        self._sink = _print_sink
        self._queue: "queue.Queue[np.ndarray]" = queue.Queue(max_queued_blocks)
        self._worker: Optional[threading.Thread] = None
        self._live = threading.Event()
        self.errors: List[str] = []

    @property
    def running(self) -> bool:
        return self._live.is_set()

    def _enqueue(self, block: np.ndarray) -> None:
        try:
            self._queue.put_nowait(block)
        except queue.Full:
            # Shedding is the right failure mode for live audio: a stalled
            # scorer must not grow the queue without bound (latency creep).
            self.errors.append("queue full: dropped a capture block")

    def _drain(self, live: threading.Event) -> None:
        # `live` is THIS worker's own flag (not self._live): a stop()
        # whose join times out (a first tick that builds the kernels can
        # hold the scorer for seconds) followed by start() must not revive
        # the old worker next to the new one: two workers interleaving
        # ticks through one engine corrupt ring order.
        while live.is_set():
            try:
                block = self._queue.get(timeout=self.QUEUE_POLL_S)
            except queue.Empty:
                continue
            # task_done accounting (see drain_until_idle): an empty queue
            # alone does not mean idle — this thread may still be scoring
            # the block it already popped.
            try:
                hit = self.inference.process_audio_chunk(
                    np.ravel(block)
                )
            except Exception as e:  # keep listening; record the failure
                self.errors.append(f"scoring failed: {e}")
                print(f"[capture] scoring failed, block skipped: {e}")
                continue
            finally:
                self._queue.task_done()
            if hit is not None:
                when, conf = hit
                # A raising sink/callback must not kill the worker:
                # capture would keep filling the bounded queue while
                # `running` still reads True and no detection is ever
                # delivered again.
                try:
                    self._sink(when, conf)
                    if self.on_detection:
                        self.on_detection(when, conf)
                except Exception as e:
                    self.errors.append(f"detection callback failed: {e}")
                    print(f"[capture] detection callback failed: {e}")

    def start(self) -> None:
        if self._live.is_set():
            return
        if self._worker is not None and self._worker.is_alive():
            # A previous stop() timed out joining (scorer mid-build):
            # that worker's own live flag is cleared so it WILL exit
            # after the in-flight block; wait for it rather than double-
            # driving the non-thread-safe engine.
            self._worker.join()
        self._worker = None
        self.inference.reset()
        # Open capture FIRST: if the device is busy/unplugged, open()
        # raises and we must not be left half-started (a set _live flag
        # plus an orphaned worker would make every retry a silent no-op).
        self.capture.open(self._enqueue)
        self._live = threading.Event()
        self._live.set()
        self._worker = threading.Thread(
            target=self._drain, args=(self._live,), daemon=True
        )
        self._worker.start()
        print(f"[capture] {self.backend} live at {self.sample_rate} Hz — "
              "ctrl-c ends the session")

    def stop(self) -> None:
        if not self._live.is_set():
            return
        self.capture.close()
        self._live.clear()
        if self._worker is not None:
            self._worker.join(timeout=self.WORKER_JOIN_S)
            if not self._worker.is_alive():
                self._worker = None
            # else: keep the handle — start() joins it before spawning a
            # replacement (its cleared live flag guarantees exit).
        print("[capture] session closed")

    def run(self) -> None:
        self.start()
        try:
            while self._live.is_set():
                time.sleep(0.1)
        except KeyboardInterrupt:
            pass
        finally:
            self.stop()

    def drain_until_idle(self, timeout: float = 10.0) -> None:
        """Block until every queued block has been fully SCORED
        (ArrayCapture feeds have a finite end; hardware captures never
        idle). Test/offline helper. Uses the queue's unfinished-task
        count, not emptiness: the worker may still be scoring the block
        it already popped, and returning then would intermittently miss
        the final chunk's detection."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            src_done = getattr(self.capture, "drained", lambda: False)()
            with self._queue.all_tasks_done:
                idle = self._queue.unfinished_tasks == 0
            if src_done and idle:
                return
            time.sleep(0.02)
        raise TimeoutError("capture queue did not drain in time")


def list_audio_devices() -> None:
    """Print every input-capable device each installed stack can see."""
    print("audio input devices")
    found = False
    for cls, available in (
        (SoundDeviceCapture, sounddevice_available()),
        (PyAudioCapture, pyaudio_available()),
    ):
        if not available:  # pragma: no cover
            continue
        found = True  # pragma: no cover
        print(f"- via {cls.name}:")  # pragma: no cover
        for idx, label, chans in cls.input_devices():  # pragma: no cover
            print(f"    {idx:>3}  {label}  ({chans}ch in)")
    if not found:
        print("- none: no capture stack installed on this host")
