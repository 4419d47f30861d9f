"""Closed-loop batch scoring: corpus clips as int16 PCM, one batch ahead.

The traffic file gives the batch, the number of distinct host batches, the
clip length and the audio's parameters. The host batches go up in turn
into two device buffers; a number of them that two does not divide gives
a buffer other clips on each use, so a stale or skipped upload shows in
the check. Set-up makes the classifier's
weights and the host batches (pinned) from the seed, and captures the
scoring program: `graphs.Programs` over dequantize -> the port's
`extract_features_fast` -> the classifier, as a user scoring a corpus
drives it. The window runs batch after batch for the run's seconds: each
iteration uploads the next host batch on a copy stream, then calls the
program on the current one, with at most `in_flight` calls not yet done.
The rate is every clip scored over the window, which ends when the last
call's work has finished.

The check compares every call's logits, and the feature images of calls
drawn from the seed, with the plain reference on the same PCM and weights.
"""

from __future__ import annotations

import time
from collections import deque
from typing import Dict, Optional

import numpy as np
import torch

from port_bench.lib import audio, check, weights
from port_bench.reference import frontend as ref_frontend
from port_bench.reference import models as ref_models


class Cell:
    def __init__(self, run):
        from cough_detector_tpu_torch.config import FeatureConfig, ModelConfig
        from cough_detector_tpu_torch.data.shards import dequantize_torch
        from cough_detector_tpu_torch.models import model_from_config, place_model
        from cough_detector_tpu_torch.ops import frontend
        from cough_detector_tpu_torch.utils import graphs

        self.run = run
        t, cfg = run.traffic, run.config
        dev = self.dev = run.device
        self.cuda = dev.type == "cuda"
        self.batch, self.k = int(t["batch"]), int(t["host_batches"])
        self.fcfg = cfg["features"]
        self.model_type = cfg["model"]["model_type"]
        n = int(self.fcfg["sample_rate"] * t["clip_seconds"])

        self.state = weights.make(self.model_type, run.seed, dev)
        model = model_from_config(ModelConfig(model_type=self.model_type, num_classes=cfg["model"]["num_classes"],
                                              dropout=cfg["model"]["dropout"]), cfg["precision"]["mode"])
        model.load_state_dict(self.state)
        self.model = place_model(model, dev)
        fcfg = FeatureConfig(**self.fcfg)
        run.mark("weights")

        self.hosts = []
        for h in range(self.k):
            x = audio.pcm(self.batch, n, run.seed, f"batch{h}", t["audio"], dev, self.fcfg["sample_rate"])
            host = torch.empty(x.shape, dtype=torch.int16, pin_memory=self.cuda)
            host.copy_(x)
            self.hosts.append(host)
            del x
        run.mark("inputs")
        self.bufs = [torch.empty(self.hosts[0].shape, dtype=torch.int16, device=dev) for _ in range(2)]
        self.uploaded = [None, None]
        self.consumed = [None, None]
        self.copy_stream = torch.cuda.Stream(dev) if self.cuda else None
        self.programs = graphs.Programs(dev, name="port_bench", pool=graphs.scoring_pool(dev))

        def score(static):
            waves = dequantize_torch(static["pcm"])
            feats = frontend.extract_features_fast(waves, fcfg, device=dev)
            return feats, self.model(feats)

        self.score = score
        rng = np.random.default_rng(weights.subseed(run.seed, "sample"))
        self.keep = set(int(i) for i in rng.choice(int(t["feature_span"]), size=int(t["feature_calls"]), replace=False))
        with torch.no_grad():
            for i in range(int(t["warm_calls"])):  # the first call captures the program
                self._upload(i)
                self._call(i)
        if self.cuda:
            torch.cuda.synchronize(dev)
        run.mark("capture")

    def _upload(self, i: int) -> None:
        b, host = i % 2, self.hosts[i % self.k]
        if not self.cuda:
            self.bufs[b].copy_(host)
            return
        with torch.cuda.stream(self.copy_stream):
            if self.consumed[b] is not None:
                self.copy_stream.wait_event(self.consumed[b])
            self.bufs[b].copy_(host, non_blocking=True)
            self.uploaded[b] = self.copy_stream.record_event()

    def _call(self, i: int):
        b = i % 2
        if self.cuda:
            torch.cuda.current_stream(self.dev).wait_event(self.uploaded[b])
        feats, logits = self.programs("score", self.score, {"pcm": self.bufs[b]}, copy=(False, True))
        if self.cuda:
            self.consumed[b] = torch.cuda.current_stream(self.dev).record_event()
        return feats, logits

    @torch.no_grad()
    def window(self) -> None:
        run, rf = self.run, torch.profiler.record_function
        depth = int(run.traffic["in_flight"])
        logits, hb, feats, enqueue, finished = [], [], {}, [], []
        pending: deque = deque()
        with rf("port_bench.window"):
            t0 = time.perf_counter()
            deadline = t0 + run.seconds
            self._upload(0)
            i = 0
            while True:
                if len(pending) >= depth:
                    with rf("port_bench.wait"):
                        pending.popleft().synchronize()
                    finished.append(time.perf_counter())
                with rf("port_bench.upload"):
                    self._upload(i + 1)
                with rf("port_bench.call"):
                    ta = time.perf_counter()
                    f, lg = self._call(i)
                    enqueue.append(time.perf_counter() - ta)
                logits.append(lg)
                hb.append(i % self.k)
                if i in self.keep:
                    feats[i] = f.clone()
                if self.cuda:
                    pending.append(torch.cuda.current_stream(self.dev).record_event())
                i += 1
                if time.perf_counter() >= deadline:
                    break
            with rf("port_bench.drain"):
                if self.cuda:
                    torch.cuda.synchronize(self.dev)
            t1 = time.perf_counter()
        if not feats:  # a window shorter than the sampled calls: the last call's
            feats[i - 1] = f.clone()
        run.window.update(seconds=t1 - t0, clips=i * self.batch, calls=i, enqueue_s=enqueue,
                          attempted=i * self.batch, failed=0)
        self.answers = {"logits": logits, "host": hb, "feats": feats}
        sixths = np.histogram(finished, bins=6, range=(t0, t1))[0]
        run.info.append(f"{i} calls of {self.batch} clips; features kept from calls {sorted(feats)}; "
                        f"calls done in each sixth of the window {sixths.tolist()}")

    def release(self) -> None:
        """Drop the program, its buffers and the model; keep the host PCM,
        the weights and the answers."""
        self.programs = self.model = self.score = None
        self.bufs = self.uploaded = self.consumed = None

    # -- the check ------------------------------------------------------------------

    def reference(self, h: int, dtype: torch.dtype, tf32: bool, block: int = 1024) -> tuple:
        """The reference's feature images and logits of host batch h."""
        feats, logits = [], []
        with check.tf32(tf32):
            for lo in range(0, self.batch, block):
                x = self.hosts[h][lo:lo + block].to(self.dev).to(dtype) / 32768.0
                f = ref_frontend.features(x, self.fcfg)
                logits.append(ref_models.logits(f, self.state, self.model_type))
                feats.append(f)
        return torch.cat(feats), torch.cat(logits)

    def control_answers(self) -> Dict:
        """The control in the program's place: the reference in float32
        with TF32 on, over the same calls."""
        outs = {h: self.reference(h, check.CONTROL_DTYPE, True) for h in sorted(set(self.answers["host"]))}
        return {"logits": [outs[h][1] for h in self.answers["host"]], "host": self.answers["host"],
                "feats": {i: outs[self.answers["host"][i]][0] for i in self.answers["feats"]}}

    def check(self, answers: Optional[Dict] = None) -> Dict[str, float]:
        a = answers or self.answers
        blocks = ref_frontend.row_blocks(self.fcfg)
        gaps = {name: check.Gap() for name in ["logits", *blocks]}
        need_feats = {a["host"][i] for i in a["feats"]}
        for h in sorted(set(a["host"])):
            feats, logits = self.reference(h, check.REFERENCE_DTYPE, False)
            for lg, hh in zip(a["logits"], a["host"]):
                if hh == h:
                    gaps["logits"].add(lg, logits)
            if h in need_feats:
                for i, f in a["feats"].items():
                    if a["host"][i] == h:
                        for name, (lo, hi) in blocks.items():
                            gaps[name].add(f[:, lo:hi], feats[:, lo:hi])
            del feats, logits
        return {name: g.value for name, g in gaps.items()}
