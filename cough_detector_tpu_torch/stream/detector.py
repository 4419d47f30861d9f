"""Streaming cough detection engines, in torch.

The port of `cough_detector_tpu/stream/detector.py`. `StreamingDetector`:
S concurrent streams scored in one batched tick on one device. Each tick
is `ring.stream_step` with this detector's `score_fn`: peak-normalize →
`ops.frontend.extract_features_fast` (the fused CUDA kernel on the card) →
classifier → softmax. `CoughDetectorInference` wraps it in the reference's
single-stream API (`predict`, `process_audio_chunk`, `reset`,
`on_cough_detected`; reference: src/inference.py:39-247).

Weights come as a state dict in the reference `.pt` key layout (what
`models.convert.from_jax_variables` returns), from a reference `.pt`
checkpoint file, or from a checkpoint directory the port's trainer wrote
(train/checkpoint.py). Multi-device serving comes with a later slice.
"""

from __future__ import annotations

import datetime
import warnings
from pathlib import Path
from typing import Callable, List, Mapping, NamedTuple, Optional, Tuple, Union

import numpy as np
import torch

from ..config import Config, StreamConfig
from ..models import model_from_config, place_model
from ..ops import frontend, frontend_kernel
from ..utils.device import resolve_device
from . import ring


class Detection(NamedTuple):
    stream: int
    time_seconds: float
    confidence: float


def _load_checkpoint(model_path: str) -> Tuple[Mapping, Config]:
    """(state_dict, config) from a checkpoint directory of the port's
    trainer (its state.pt and meta.json's config_full) or a reference
    checkpoint file ({epoch, model_state_dict, optimizer_state_dict,
    metrics, config}, reference: src/train.py:192-199)."""
    from ..train import checkpoint

    if Path(model_path).is_dir():
        tree, _, _, config = checkpoint.load_checkpoint(model_path)
        return tree["model"], config
    state_dict, config, _, _ = checkpoint.import_torch_checkpoint(model_path)
    return state_dict, config


class StreamingDetector:
    """Batched multi-stream sliding-window detector.

    Feed lockstep chunks of shape (num_streams, chunk_size); receive
    Detection events. Methods that touch the tick state (tick_async,
    reset, reset_streams, set_thresholds) must not run concurrently;
    collect_events on an earlier tick's events may.
    """

    def __init__(
        self,
        model_path: Optional[str] = None,
        *,
        variables: Optional[Mapping] = None,
        config: Optional[Config] = None,
        device: Union[str, torch.device] = "cuda",
        num_streams: int = 1,
        chunk_size: int = 1600,
        confidence_threshold: float = 0.5,
        smoothing_window: int = 3,
        debounce_seconds: float = 0.5,
        hop_duration: float = 0.25,
    ):
        """`variables`: a state dict in the reference key layout (tensors or
        numpy arrays), with `config`; or `model_path`, a reference `.pt`
        file or a checkpoint directory of the port's trainer. `device`
        defaults to the card and raises if there is none."""
        if model_path is not None:
            variables, config = _load_checkpoint(model_path)
        elif variables is None or config is None:
            raise ValueError("Provide model_path or (variables, config)")
        self.device = resolve_device(device)
        self.config = config
        self.stream_config = StreamConfig(
            window_duration=config.features.segment_duration,
            hop_duration=hop_duration,
            confidence_threshold=confidence_threshold,
            smoothing_window=smoothing_window,
            debounce_seconds=debounce_seconds,
            num_streams=num_streams,
        )
        self.num_streams = num_streams
        self.chunk_size = chunk_size
        self.window_samples = int(
            config.features.sample_rate * self.stream_config.window_duration
        )

        model = model_from_config(config.model)
        model.load_state_dict({k: torch.as_tensor(v) for k, v in variables.items()})
        self._model = place_model(model, self.device)
        fcfg = config.features
        if self.device.type == "cuda" and not frontend_kernel.card_supports(
            fcfg, self.window_samples
        ):
            warnings.warn(
                f"the fused CUDA front-end kernel does not take this feature "
                f"config at {self.window_samples}-sample windows; the "
                f"detector's front end runs the plain torch chain: {fcfg}",
                stacklevel=2,
            )

        def score_fn(windows: torch.Tensor) -> torch.Tensor:
            waves = frontend.peak_normalize(windows)
            feats = frontend.extract_features_fast(waves, fcfg, device=self.device)
            return torch.softmax(self._model(feats), dim=-1)[:, 1]

        self._score_fn = score_fn
        self._step = ring.make_stream_step(score_fn, fcfg, self.stream_config)
        self.reset()

    # -- engine ----------------------------------------------------------

    def reset(self) -> None:
        self._state = ring.init_state(
            self.num_streams,
            self.chunk_size,
            self.window_samples,
            self.stream_config.smoothing_window,
            self.stream_config.confidence_threshold,
            device=self.device,
        )
        self._pending = np.zeros((self.num_streams, 0), np.float32)

    def _lane_mask_and_thresholds(self, indices, thresholds):
        """(host mask, device mask, device thresholds) for a lane subset. A
        None `thresholds` (or None entry) means the configured default."""
        idx = np.asarray(list(indices), np.int64)
        mask = np.zeros((self.num_streams,), bool)
        mask[idx] = True
        default = self.stream_config.confidence_threshold
        thr = np.full((self.num_streams,), default, np.float32)
        if thresholds is not None:
            thr[idx] = np.asarray(
                [default if t is None else float(t) for t in thresholds],
                np.float32,
            )
        return (
            mask,
            torch.from_numpy(mask).to(self.device),
            torch.from_numpy(thr).to(self.device),
        )

    @torch.no_grad()
    def reset_streams(self, indices, thresholds=None) -> None:
        """Zero the given lanes' ring buffer, smoothing history and its
        per-lane count, debounce clock and pending host samples, and set
        their thresholds (`thresholds` aligned with `indices`; None, or a
        None entry, restores the default). The shared lockstep counters are
        untouched. Used when a serving slot passes to a new tenant."""
        mask, mask_dev, thr_dev = self._lane_mask_and_thresholds(
            indices, thresholds
        )
        st = self._state
        st.buffer.masked_fill_(mask_dev[:, None], 0.0)
        st.history.masked_fill_(mask_dev[:, None], 0.0)
        st.history_len.masked_fill_(mask_dev, 0)
        st.last_fire_window.masked_fill_(mask_dev, ring.NEVER_FIRED)
        st.threshold.copy_(torch.where(mask_dev, thr_dev, st.threshold))
        self._pending[mask] = 0.0

    @torch.no_grad()
    def set_thresholds(self, indices, thresholds) -> None:
        """Change the given lanes' thresholds mid-stream, scrubbing nothing:
        ring audio, smoothing history and the debounce clock survive."""
        _, mask_dev, thr_dev = self._lane_mask_and_thresholds(
            indices, thresholds
        )
        st = self._state
        st.threshold.copy_(torch.where(mask_dev, thr_dev, st.threshold))

    def current_thresholds(self) -> np.ndarray:
        """The live per-lane thresholds."""
        return self._state.threshold.cpu().numpy()

    @torch.no_grad()
    def tick_async(self, tick: np.ndarray) -> dict:
        """Enqueue exactly one device tick, (num_streams, chunk_size)
        samples as f32, int16 PCM or uint8 μ-law, without waiting for it;
        returns the events dict for a later `collect_events`."""
        self._state, events = self._step(self._state, tick)
        return events

    def collect_events(self, events: dict) -> List[Detection]:
        """Wait for one tick's events and decode them to Detection records.
        Reads only the packed event tensor: one device-to-host copy."""
        packed = events["packed"].cpu().numpy()
        s = self.num_streams
        valid = packed[0] > 0.5
        win_idx = packed[1].astype(np.int64) * 32768 + packed[2].astype(np.int64)
        smoothed = packed[3 : 3 + s]
        fired = packed[3 + s : 3 + 2 * s] > 0.5
        sr = self.config.features.sample_rate
        hop = int(sr * self.stream_config.hop_duration)
        detections: List[Detection] = []
        for k in np.nonzero(valid)[0]:
            # Exact stream time from the integer window index.
            t = (int(win_idx[k]) * hop + self.window_samples) / sr
            for s_i in np.nonzero(fired[:, k])[0]:
                detections.append(Detection(int(s_i), t, float(smoothed[s_i, k])))
        return detections

    def process_chunk(self, chunk: np.ndarray) -> List[Detection]:
        """Feed (num_streams, n) or (n,) samples; n need not equal
        chunk_size — data is re-chunked on the host."""
        if chunk.ndim == 1:
            chunk = chunk[None, :]
        if chunk.shape[0] != self.num_streams:
            raise ValueError(
                f"Expected {self.num_streams} streams, got {chunk.shape[0]}"
            )
        self._pending = np.concatenate(
            [self._pending, chunk.astype(np.float32)], axis=1
        )
        detections: List[Detection] = []
        while self._pending.shape[1] >= self.chunk_size:
            tick = self._pending[:, : self.chunk_size]
            self._pending = self._pending[:, self.chunk_size :]
            detections.extend(self.collect_events(self.tick_async(tick)))
        return detections

    @torch.no_grad()
    def scores_for(self, chunk: np.ndarray) -> np.ndarray:
        """Raw per-window cough probabilities for a (B, window) batch."""
        windows = torch.as_tensor(chunk, dtype=torch.float32, device=self.device)
        return self._score_fn(windows).cpu().numpy()


class CoughDetectorInference:
    """Reference-API single-stream wrapper (reference: src/inference.py:39).

    Debouncing and timestamps use deterministic stream time; the wall-clock
    timestamp handed to the callback is taken at event time. `device`:
    "auto" (the reference's default) and "cuda" mean the card, and raise
    without one; "cpu" is the only way to the CPU."""

    def __init__(
        self,
        model_path: str,
        device: Union[str, torch.device] = "auto",
        confidence_threshold: float = 0.5,
        smoothing_window: int = 3,
        debounce_seconds: float = 0.5,
        verbose: bool = True,
    ):
        self.verbose = verbose
        self._confidence_threshold = confidence_threshold
        self.debounce_seconds = debounce_seconds
        self._engine = StreamingDetector(
            model_path,
            device="cuda" if device == "auto" else device,
            num_streams=1,
            chunk_size=1600,  # 100 ms at 16 kHz, the reference mic chunk
            confidence_threshold=confidence_threshold,
            smoothing_window=smoothing_window,
            debounce_seconds=debounce_seconds,
            hop_duration=0.25,
        )
        self.device = self._engine.device
        self.config = self._engine.config.to_flat_dict()
        self.on_cough_detected: Optional[Callable[[datetime.datetime, float], None]] = None
        if verbose:
            print(
                f"Model loaded: {self._engine.config.model.model_type} "
                f"({self._engine.num_streams} stream, {self.device})"
            )

    @property
    def confidence_threshold(self) -> float:
        return self._confidence_threshold

    @confidence_threshold.setter
    def confidence_threshold(self, value: float) -> None:
        """Live-mutable, like the reference's attribute (read at event time,
        reference: src/inference.py:70,229): takes effect on the next window
        without disturbing the ring audio, smoothing history or debounce
        clock."""
        self._confidence_threshold = float(value)
        self._engine.set_thresholds([0], [float(value)])

    @torch.no_grad()
    def predict(self, features: np.ndarray) -> Tuple[bool, float]:
        """(is_cough, p_cough) for a (1, H, T) or (B, 1, H, T) feature
        tensor (reference: src/inference.py:165-189)."""
        feats = torch.as_tensor(np.asarray(features, np.float32), device=self.device)
        if feats.ndim == 3:
            feats = feats[None]
        p = float(torch.softmax(self._engine._model(feats), dim=-1)[0, 1])
        return p > 0.5, p

    def process_audio_chunk(
        self, audio_chunk: np.ndarray
    ) -> Optional[Tuple[datetime.datetime, float]]:
        """Feed raw mic samples; returns (timestamp, smoothed_confidence) on
        a debounced detection, else None (reference: src/inference.py:
        191-241). The callback fires once per detected cough (the reference
        returns on the first and drops the rest of the chunk's); the
        returned tuple is the first event, as the reference returns."""
        audio_chunk = np.asarray(audio_chunk, np.float32)
        if audio_chunk.ndim == 2:  # (channels, samples) → mono
            audio_chunk = audio_chunk.mean(axis=0)
        detections = self._engine.process_chunk(audio_chunk)
        if not detections:
            return None
        timestamp = datetime.datetime.now()
        if self.on_cough_detected:
            for det in detections:
                self.on_cough_detected(timestamp, det.confidence)
        return timestamp, detections[0].confidence

    def reset(self) -> None:
        """Clear audio, history and debounce state. A live-mutated
        confidence_threshold survives, like the reference's (its reset()
        never touches the attribute); the engine's reset restores the
        constructor's, so ours is applied again."""
        self._engine.reset()
        self._engine.set_thresholds([0], [self._confidence_threshold])
