"""Open-loop streaming ticks at the audio's real-time cadence.

The traffic file gives the number of streams, the chunk (a tick's samples
a stream), the tick period, the detector's hop, threshold, smoothing and
debounce, and the audio's parameters. Set-up builds the port's
`StreamingDetector` from the seed's weights, makes `cycle_ticks` chunks of
int16 PCM a stream from the seed (the streams loop over them), runs one
tick from each of the ring's fills so every key of the tick is captured,
and empties the ring. In the window, tick k is due k periods after its
start: the loop sleeps until it is due, calls `tick_async` with that
tick's chunk (the host array goes up through the detector's pinned staging
buffers) and `collect_events`, as the serving daemon's tick does. Only the sampled streams' events are kept (after the tick's time is
taken), so the harness holds few objects. A tick's
latency runs from when it was due to when its events are in hand, so a
late tick also delays the ones behind it; how late each call began is
recorded too.

The check follows a sample of streams, drawn from the seed, through every
tick of the window: each scored window against the plain reference's
score smoothed over the same windows, the schedule of windows, and the
threshold and debounce applied to the program's own smoothed scores,
against the events the program fired and `collect_events` returned.
"""

from __future__ import annotations

import gc
import resource
import time
from typing import Dict, Optional

import numpy as np
import torch

from port_bench.lib import audio, check, weights
from port_bench.reference import frontend as ref_frontend
from port_bench.reference import models as ref_models
from port_bench.reference import stream as ref_stream


class Cell:
    def __init__(self, run):
        from cough_detector_tpu_torch.config import Config, FeatureConfig, ModelConfig
        from cough_detector_tpu_torch.stream import StreamingDetector, ring

        self.run = run
        t, cfg = run.traffic, run.config
        dev = self.dev = run.device
        self.fcfg = cfg["features"]
        self.model_type = cfg["model"]["model_type"]
        sr = self.fcfg["sample_rate"]
        self.n, self.chunk, self.cycle = int(t["streams"]), int(t["chunk"]), int(t["cycle_ticks"])
        self.params = {"window": int(sr * self.fcfg["segment_duration"]), "hop": int(sr * t["hop_s"]),
                       "chunk": self.chunk}
        self.state = weights.make(self.model_type, run.seed, dev)
        run.mark("weights")
        pcm = audio.pcm(self.n, self.cycle * self.chunk, run.seed, "streams", t["audio"], dev, sr)
        self.chunks = np.ascontiguousarray(
            pcm.reshape(self.n, self.cycle, self.chunk).transpose(0, 1).contiguous().cpu().numpy())
        head = t["head"]  # the events' rate: a share of windows over the threshold
        gen = torch.Generator().manual_seed(weights.subseed(run.seed, "head"))
        rows = torch.randint(self.n, (head["windows"], 1), generator=gen)
        starts = torch.randint((self.cycle * self.chunk - self.params["window"]) // self.params["hop"] + 1,
                               (head["windows"], 1), generator=gen) * self.params["hop"]
        with torch.no_grad(), check.tf32(False):
            cols = (starts + torch.arange(self.params["window"])[None]).to(dev)
            x = pcm[rows.to(dev), cols].float() / 32768.0
            x = x / x.abs().amax(dim=1, keepdim=True).clamp_min(1e-12)
            embedded = ref_models.logits(ref_frontend.features(x, self.fcfg), self.state, self.model_type, head=False)
        weights.calibrate_head(self.state, self.model_type, embedded, head["spread"], head["fire_share"],
                               t["threshold"])
        del pcm, x, embedded
        run.mark("inputs")
        config = Config(features=FeatureConfig(**self.fcfg),
                        model=ModelConfig(model_type=self.model_type, num_classes=cfg["model"]["num_classes"],
                                          dropout=cfg["model"]["dropout"]))
        self.det = StreamingDetector(
            variables=self.state, config=config, device=dev, num_streams=self.n, chunk_size=self.chunk,
            confidence_threshold=t["threshold"], smoothing_window=t["smoothing"],
            debounce_seconds=t["debounce_s"], hop_duration=t["hop_s"],
            precision_mode=cfg["precision"]["mode"], mesh=False,
        )
        rng = np.random.default_rng(weights.subseed(run.seed, "sample"))
        self.sample = np.sort(rng.choice(self.n, size=min(self.n, int(t["check_streams"])), replace=False))
        fills = ring.tick_fills(self.chunk, self.params["window"], self.params["hop"])
        for k in range(len(fills)):  # each fill's first tick captures its program
            self.det.collect_events(self.det.tick_async(self.chunks[k % self.cycle]))
        self.det.reset()
        self.keys = [k for p in self.det.tick_programs() for k in p.keys]
        run.mark("capture")

    @torch.no_grad()
    def window(self) -> None:
        run, rf = self.run, torch.profiler.record_function
        period = float(run.traffic["tick_s"])
        n_ticks = max(1, int(round(run.seconds / period)))
        late, latency, enqueued, packed, events = [], [], [], [], []
        det, sampled, n_events = self.det, set(int(x) for x in self.sample), 0
        pauses, began = [], []
        cuda = self.dev.type == "cuda"
        marks = [torch.cuda.Event(enable_timing=True) for _ in range(2 * n_ticks)] if cuda else []

        def collecting(phase, info):  # the interpreter's collections inside the window
            if phase == "start":
                began.append(time.perf_counter())
            elif began:
                pauses.append((info["generation"], time.perf_counter() - began.pop()))

        gc.callbacks.append(collecting)
        usage = resource.getrusage(resource.RUSAGE_SELF)
        with rf("port_bench.window"):
            t0 = time.perf_counter()
            for k in range(n_ticks):
                due = t0 + k * period
                wait = due - time.perf_counter()
                if wait > 0:
                    with rf("port_bench.sleep"):
                        time.sleep(wait)
                start = time.perf_counter()
                if cuda:
                    marks[2 * k].record()
                with rf("port_bench.tick_async"):
                    ev = det.tick_async(self.chunks[k % self.cycle])
                if cuda:
                    marks[2 * k + 1].record()
                mid = time.perf_counter()
                with rf("port_bench.collect_events"):
                    found = det.collect_events(ev)
                done = time.perf_counter()
                late.append(start - due)
                enqueued.append(mid - start)
                latency.append(done - due)
                packed.append(ev["packed"])
                events.append([d for d in found if d.stream in sampled])
                n_events += len(found)
            t1 = time.perf_counter()
        gc.callbacks.remove(collecting)
        after = resource.getrusage(resource.RUSAGE_SELF)
        keys = [k for p in det.tick_programs() for k in p.keys]
        if keys != self.keys:
            raise SystemExit(f"port_bench: ticks were captured inside the window: {len(keys)} keys, "
                             f"{len(self.keys)} after warm-up")
        limit = float(run.traffic["deadline_ms"]) * 1e-3
        run.window.update(seconds=t1 - t0, ticks=n_ticks, latency_s=latency, late_s=late,
                          attempted=n_ticks, failed=sum(x > limit for x in latency))
        self.n_ticks = n_ticks
        self._packed, self._events = packed, events
        run.info.append(f"{n_ticks} ticks of {self.n} streams; {n_events} events; "
                        f"{sum(x > limit for x in latency)} ticks past {run.traffic['deadline_ms']} ms; "
                        f"slowest ticks {sorted(round(x * 1e3, 1) for x in latency)[-5:]} ms; p95 of each half "
                        f"{[round(float(np.percentile(h, 95)) * 1e3, 2) for h in np.array_split(latency, 2)]} ms; "
                        f"{len(pauses)} garbage collections, generation 2: "
                        f"{[round(d * 1e3, 1) for g, d in pauses if g == 2]} ms")
        # Where the slowest ticks lost their time: how late each began, the
        # host's tick_async, the rest (collect_events: the fetch and the
        # decode), and the device's span from tick_async's start to the end
        # of its work; the process's page faults and context switches.
        worst = sorted(range(n_ticks), key=lambda j: latency[j])[-3:]
        if cuda:
            torch.cuda.synchronize(self.dev)
        rows = []
        for j in reversed(worst):
            device = marks[2 * j].elapsed_time(marks[2 * j + 1]) if cuda else float("nan")
            rows.append(f"tick {j}: late {late[j] * 1e3:.1f}, tick_async {enqueued[j] * 1e3:.1f}, "
                        f"collect {(latency[j] - late[j] - enqueued[j]) * 1e3:.1f}, device {device:.1f}")
        run.info.append("slowest ticks (ms): " + "; ".join(rows) + "; window: major faults "
                        f"{after.ru_majflt - usage.ru_majflt}, minor {after.ru_minflt - usage.ru_minflt}, "
                        f"involuntary switches {after.ru_nivcsw - usage.ru_nivcsw}, "
                        f"voluntary {after.ru_nvcsw - usage.ru_nvcsw}")

    def release(self) -> None:
        """Read the sampled streams' rows out of every tick's events, then
        drop the detector."""
        s, rows = self.n, self.sample
        pick = torch.as_tensor(np.concatenate([[0, 1, 2], 3 + rows, 3 + s + rows]))
        ticks = [p[pick.to(p.device)].cpu().numpy() for p in self._packed]
        m = len(rows)
        w_total = ref_stream.windows_completed(self.n_ticks * self.chunk, self.params["window"], self.params["hop"])
        smoothed = np.full((m, w_total), np.nan, np.float32)
        fired = np.zeros((m, w_total), bool)
        expected = ref_stream.expected(self.params, self.n_ticks)
        schedule = 0
        for k, col in enumerate(ticks):
            valid = col[0] > 0.5
            wins = (col[1].astype(np.int64) * 32768 + col[2].astype(np.int64))[valid]
            want = [expected[k]] if k in expected else []
            if list(wins) != want:
                schedule += 1
                continue
            for j in np.nonzero(valid)[0]:
                w = int(wins[0])
                smoothed[:, w] = col[3:3 + m, j]
                fired[:, w] = col[3 + m:3 + 2 * m, j] > 0.5
        index = {int(x): i for i, x in enumerate(rows)}
        sr, hop, window = self.fcfg["sample_rate"], self.params["hop"], self.params["window"]
        returned = set()
        for found in self._events:
            for d in found:
                if d.stream in index:
                    w = int(round((d.time_seconds * sr - window) / hop))
                    returned.add((index[d.stream], w, np.float32(d.confidence)))
        self.answers = {"smoothed": smoothed, "fired": fired, "schedule": schedule, "returned": returned}
        self.det = self._packed = self._events = None

    # -- the check ------------------------------------------------------------------

    def _audio(self) -> np.ndarray:
        """The sampled streams' samples over the window's ticks, as fed."""
        seq = [self.chunks[k % self.cycle][self.sample] for k in range(self.n_ticks)]
        return np.concatenate(seq, axis=1).astype(np.float64) / 32768.0

    def _smoothed(self, dtype: torch.dtype, tf32: bool) -> np.ndarray:
        def score(x):
            return ref_models.logits(ref_frontend.features(x, self.fcfg), self.state, self.model_type)

        with check.tf32(tf32):
            p = ref_stream.scores(self._audio(), self.params["window"], self.params["hop"], score, self.dev, dtype)
        return ref_stream.smooth(p, int(self.run.traffic["smoothing"]))

    def control_answers(self) -> Dict:
        """The control in the program's place: the reference's scores in
        float32 with TF32 on, smoothed, thresholded and debounced by the
        reference's rules (which fire and return exactly what they imply)."""
        sm = self._smoothed(check.CONTROL_DTYPE, True).astype(np.float32)
        fired = self._fire(sm)
        returned = {(i, w, sm[i, w]) for i, w in zip(*np.nonzero(fired))}
        return {"smoothed": sm, "fired": fired, "schedule": 0, "returned": returned}

    def _fire(self, smoothed: np.ndarray) -> np.ndarray:
        t = self.run.traffic
        d = ref_stream.debounce_windows(t["debounce_s"], self.fcfg["sample_rate"], self.params["hop"])
        return ref_stream.fire(smoothed.astype(np.float32), np.float32(t["threshold"]), d)

    def check(self, answers: Optional[Dict] = None) -> Dict[str, float]:
        a = answers or self.answers
        ref = self._smoothed(check.REFERENCE_DTYPE, False)
        sm = a["smoothed"]
        diff = np.abs(sm.astype(np.float64) - ref)
        gap = float(np.nanmax(diff)) if np.any(~np.isnan(diff)) else 0.0
        missing = int(np.isnan(sm).sum())
        fired = self._fire(np.nan_to_num(sm, nan=0.0))
        implied = {(i, w, sm[i, w]) for i, w in zip(*np.nonzero(fired))}
        events = (a["schedule"] + missing + int((fired != a["fired"]).sum())
                  + len(implied ^ a["returned"]))
        n_fired = int(fired.sum())
        self.run.info.append(f"sampled {len(self.sample)} streams x {sm.shape[1]} windows; "
                             f"{n_fired} events by the rules on the program's scores")
        return {"smoothed": gap if np.isfinite(gap) else float("inf"), "events": float(events)}
