"""Sliding-window ring buffer for S concurrent audio streams, in torch.

The port of `cough_detector_tpu/stream/ring.py`: one tick appends a
(S, C) chunk to each stream's pending buffer, scores every window the chunk
completes, smooths, thresholds per lane, debounces in integer window
indices, and shifts the buffer by the consumed hops.

Differences from the JAX tick, none of which changes an event:
  * `fill` and `windows_emitted` are host ints. They depend only on chunk
    sizes, never on the audio, so the host knows how many windows a tick
    completes without a device round trip; the window count enters the
    device arithmetic as a device scalar written before each tick.
  * Only the windows a tick completes are scored, in one batch of
    n_valid*S windows (one front-end kernel launch per tick). `probs` of
    the other candidate windows are 0; nothing reads them.
  * The state's tensors are updated in place, where JAX donates them, so
    every tick reads and writes one set of addresses: on the card the tick
    is a captured CUDA graph (the JAX package jits it), one a (chunk dtype,
    chunk size, fill) key, and `fill` cycles through a few values
    (`tick_fills`).

Invariants (as in the reference loop): fill < window after every tick, so
capacity window+chunk suffices; window k of a tick starts at offset k*hop of
the pending buffer.
"""

from __future__ import annotations

from typing import Callable, List, NamedTuple, Optional, Tuple, Union

import numpy as np
import torch

from ..config import FeatureConfig, StreamConfig
from ..utils import graphs
from ..utils.device import resolve_device

NEVER_FIRED = -(1 << 24)


class StreamState(NamedTuple):
    """Per-stream tick state; tensors live on the detector's device."""

    buffer: torch.Tensor          # (S, capacity) f32 pending samples
    fill: int                     # valid samples per stream (lockstep)
    windows_emitted: int          # total windows so far
    history: torch.Tensor         # (S, smoothing_window) recent confidences
    history_len: torch.Tensor     # (S,) int32 valid history entries per lane
    last_fire_window: torch.Tensor  # (S,) int32 window index of last fire
    threshold: torch.Tensor       # (S,) f32 per-lane confidence threshold


def init_state(
    num_streams: int,
    chunk_size: int,
    window_samples: int,
    smoothing_window: int,
    confidence_threshold: float = 0.7,
    device: Union[str, torch.device] = "cuda",
) -> StreamState:
    dev = resolve_device(device)
    capacity = window_samples + chunk_size
    return StreamState(
        buffer=torch.zeros((num_streams, capacity), dtype=torch.float32, device=dev),
        fill=0,
        windows_emitted=0,
        history=torch.zeros(
            (num_streams, smoothing_window), dtype=torch.float32, device=dev
        ),
        history_len=torch.zeros((num_streams,), dtype=torch.int32, device=dev),
        last_fire_window=torch.full(
            (num_streams,), NEVER_FIRED, dtype=torch.int32, device=dev
        ),
        threshold=torch.full(
            (num_streams,), confidence_threshold, dtype=torch.float32, device=dev
        ),
    )


def max_windows_per_chunk(chunk_size: int, hop_samples: int) -> int:
    return (chunk_size - 1) // hop_samples + 1


def dequantize(chunk: torch.Tensor) -> torch.Tensor:
    """int16 PCM (x = i/32768) or uint8 μ-law codes (x = sign(y)·(256^|y|
    − 1)/255 with y = (code−128)/127) → f32; f32 passes through."""
    if chunk.dtype == torch.int16:
        return chunk.to(torch.float32) * (1.0 / 32768.0)
    if chunk.dtype == torch.uint8:
        y = (chunk.to(torch.float32) - 128.0) * (1.0 / 127.0)
        return torch.sign(y) * (torch.exp2(y.abs() * 8.0) - 1.0) * (1.0 / 255.0)
    if chunk.dtype != torch.float32:
        raise ValueError(f"unsupported chunk dtype {chunk.dtype}")
    return chunk


def tick_geometry(fill: int, chunk_size: int, window_samples: int, hop_samples: int) -> Tuple[int, int]:
    """(windows the tick completes, samples it consumes) for a tick of
    `chunk_size` samples appended at `fill`: host ints, from sizes alone."""
    k_max = max_windows_per_chunk(chunk_size, hop_samples)
    end = fill + chunk_size
    n_valid = min((end - window_samples) // hop_samples + 1, k_max) if end >= window_samples else 0
    return n_valid, n_valid * hop_samples


def tick_fills(chunk_size: int, window_samples: int, hop_samples: int) -> List[int]:
    """The fill each tick starts from, from an empty ring until the
    sequence repeats: a chunk size's tick keys. The ring then cycles
    through the fills from the first repeated one on."""
    fills, fill = [], 0
    while fill not in fills:
        fills.append(fill)
        fill += chunk_size - tick_geometry(fill, chunk_size, window_samples, hop_samples)[1]
    return fills


def tick_program(
    state: StreamState,
    chunk: torch.Tensor,
    base: torch.Tensor,
    score_fn: Callable[[torch.Tensor], torch.Tensor],
    *,
    fill: int,
    window_samples: int,
    hop_samples: int,
    sample_rate: int,
    debounce_seconds: float,
) -> dict:
    """The device side of one tick, with no host value but the sizes: reads
    and writes the state's tensors in place, the window count so far comes
    as `base`, a device int32 scalar, and `fill` (a host int) fixes which
    windows complete. The same ops run eagerly (`stream_step`) and as the
    captured tick (`make_stream_step` on the card). Returns the events."""
    dev = state.buffer.device
    chunk = dequantize(chunk)
    s, c = chunk.shape
    hop, window = hop_samples, window_samples
    k_max = max_windows_per_chunk(c, hop)
    n_valid, consumed = tick_geometry(fill, c, window, hop)

    # 1. Append the chunk at the current fill offset.
    buffer = state.buffer
    buffer[:, fill : fill + c] = chunk

    # 2. Score the completed windows in one batch, window-major.
    probs = torch.zeros((s, k_max), dtype=torch.float32, device=dev)
    if n_valid:
        wins = torch.cat(
            [buffer[:, k * hop : k * hop + window] for k in range(n_valid)]
        )
        probs[:, :n_valid] = score_fn(wins).reshape(n_valid, s).T
    kk = torch.arange(k_max, device=dev)
    valid = kk < n_valid

    # 3. Smoothing: deque(maxlen).mean() over each lane's populated history
    #    (per lane, so a scrubbed lane restarts with an empty deque).
    smooth_win = state.history.shape[1]
    history, history_len = state.history, state.history_len
    idx = torch.arange(smooth_win, device=dev)
    smoothed = []
    for k in range(k_max):
        if k < n_valid:
            history = torch.cat([history[:, 1:], probs[:, k : k + 1]], dim=1)
            history_len = torch.clamp(history_len + 1, max=smooth_win)
        mask = idx[None, :] >= (smooth_win - history_len)[:, None]
        smoothed.append(
            (history * mask).sum(dim=1) / torch.clamp(history_len, min=1)
        )
    smoothed = torch.stack(smoothed, dim=1)

    # 4. Per-lane threshold, then debounce in integer window indices:
    #    window w fires at sample w*hop + window, so "debounce_seconds since
    #    the last fire" is w - w_last >= ceil(debounce_samples / hop).
    debounce_windows = -(-int(round(debounce_seconds * sample_rate)) // hop)
    last_fire = state.last_fire_window
    fired = torch.zeros((s, k_max), dtype=torch.bool, device=dev)
    for k in range(n_valid):
        can_fire = (smoothed[:, k] >= state.threshold) & (
            base + k - last_fire >= debounce_windows
        )
        last_fire = torch.where(can_fire, base + k, last_fire)
        fired[:, k] = can_fire

    # 5. Advance the buffer by the consumed hops; the tail refills with 0.
    if consumed:
        cap = buffer.shape[1]
        buffer[:, : cap - consumed] = buffer[:, consumed:].clone()
        buffer[:, cap - consumed :] = 0.0
    if n_valid:  # the new values back into the state's own storage
        state.history.copy_(history)
        state.history_len.copy_(history_len)
        state.last_fire_window.copy_(last_fire)

    win_idx = kk + base
    packed = torch.cat(
        [
            torch.stack(
                [valid.float(), (win_idx >> 15).float(), (win_idx & 0x7FFF).float()]
            ),
            smoothed,
            fired.float(),
        ]
    )
    return {
        "probs": probs,
        "smoothed": smoothed,
        "fired": fired,
        "valid": valid,
        "timestamps": (win_idx.float() * hop + window) / sample_rate,
        "window_index": win_idx,
        "packed": packed,
    }


def advance(state: StreamState, chunk_size: int, window_samples: int, hop_samples: int) -> StreamState:
    """The state after a tick of `chunk_size` samples: its host counters
    moved on (its tensors were updated in place)."""
    n_valid, consumed = tick_geometry(state.fill, chunk_size, window_samples, hop_samples)
    return state._replace(
        fill=state.fill + chunk_size - consumed,
        windows_emitted=state.windows_emitted + n_valid,
    )


def reset_state(state: StreamState, confidence_threshold: float) -> StreamState:
    """`state` emptied in place (what init_state gives, on the same
    storage, so captured ticks stay valid)."""
    state.buffer.zero_()
    state.history.zero_()
    state.history_len.zero_()
    state.last_fire_window.fill_(NEVER_FIRED)
    state.threshold.fill_(confidence_threshold)
    return state._replace(fill=0, windows_emitted=0)


def stream_step(
    state: StreamState,
    chunk: torch.Tensor,
    score_fn: Callable[[torch.Tensor], torch.Tensor],
    *,
    window_samples: int,
    hop_samples: int,
    sample_rate: int,
    debounce_seconds: float,
) -> Tuple[StreamState, dict]:
    """One streaming tick for all S streams, eagerly; updates `state`'s
    tensors in place.

    chunk: (S, C) f32 audio, int16 PCM or uint8 μ-law (dequantized on the
    state's device). score_fn: (B, window) → (B,) cough probability.

    Returns (new_state, events): probs (S, K), smoothed (S, K), fired (S, K)
    bool, valid (K,) bool, timestamps (K,), window_index (K,), and `packed`,
    the (3 + 2S, K) f32 tensor a host decodes in one fetch: rows valid,
    win_idx >> 15, win_idx & 0x7FFF (exact in f32), smoothed, fired.
    """
    dev = state.buffer.device
    chunk = torch.as_tensor(chunk).to(dev)
    base = torch.full((), state.windows_emitted, dtype=torch.int32, device=dev)
    geometry = dict(window_samples=window_samples, hop_samples=hop_samples)
    events = tick_program(
        state, chunk, base, score_fn, fill=state.fill, sample_rate=sample_rate,
        debounce_seconds=debounce_seconds, **geometry,
    )
    return advance(state, chunk.shape[1], **geometry), events


def _storage(state: StreamState) -> tuple:
    return tuple(t.data_ptr() for t in (state.buffer, state.history, state.history_len,
                                        state.last_fire_window, state.threshold))


class StreamStep:
    """The tick bound to fixed geometry: (state, chunk) → (state, events).

    `graphed` (None: on a CUDA state) runs it as captured programs
    (utils.graphs.Programs), one a (chunk dtype, chunk size, fill, state
    storage) key: the chunk and the window count go in through pinned
    staging buffers, the program is `tick_program`, and the events hold
    `packed` alone, copied out of the static output (a dispatched tick's
    events outlive later ticks). Otherwise it is `stream_step`, eagerly.
    On the CPU a graphed tick calls `tick_program` on the static buffers."""

    def __init__(self, score_fn, *, graphed: Optional[bool] = None, **geometry):
        self.score_fn = score_fn
        self.graphed = graphed
        self.geometry = geometry
        self.ring = dict(window_samples=geometry["window_samples"], hop_samples=geometry["hop_samples"])
        self.programs: Optional[graphs.Programs] = None

    def __call__(self, state: StreamState, chunk) -> Tuple[StreamState, dict]:
        dev = state.buffer.device
        if not (self.graphed or (self.graphed is None and dev.type == "cuda")):
            return stream_step(state, chunk, self.score_fn, **self.geometry)
        if self.programs is None:
            self.programs = graphs.Programs(dev, name="tick")
        if not isinstance(chunk, torch.Tensor):
            chunk = np.asarray(chunk)
        key = (str(chunk.dtype), tuple(chunk.shape), state.fill, _storage(state))

        def program(static):
            events = tick_program(state, static["chunk"], static["base"], self.score_fn,
                                  fill=state.fill, **self.geometry)
            return (events["packed"],)

        (packed,) = self.programs(
            key, program, {"chunk": chunk, "base": np.array(state.windows_emitted, np.int32)}
        )
        return advance(state, chunk.shape[1], **self.ring), {"packed": packed}


def make_stream_step(
    score_fn: Callable[[torch.Tensor], torch.Tensor],
    feature_config: FeatureConfig,
    stream_config: StreamConfig,
    graphed: Optional[bool] = None,
) -> StreamStep:
    """Streaming tick bound to fixed geometry: (state, chunk) → (state,
    events); the chunk size comes from each chunk's shape. On the card the
    tick runs as captured programs (the JAX package's jitted tick), on the
    CPU eagerly (`graphed` forces either; see StreamStep)."""
    return StreamStep(
        score_fn,
        graphed=graphed,
        window_samples=int(feature_config.sample_rate * stream_config.window_duration),
        hop_samples=int(feature_config.sample_rate * stream_config.hop_duration),
        sample_rate=feature_config.sample_rate,
        debounce_seconds=stream_config.debounce_seconds,
    )
