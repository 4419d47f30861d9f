"""The check on the CPU with the timed path broken underneath: each fault
the cells can have turns `correct` false, and the unbroken run stays true.
On a card (marked `card`), the control, the reference in float32 with TF32
on put in the program's place, turns it false too."""

import time

import numpy as np
import pytest
import torch

from cough_detector_tpu_torch.models import classifiers
from cough_detector_tpu_torch.stream import ring
from port_bench.lib import check, harness, spec, weights

SERVE = ["residual.serve", "residual.serve_busy"]


def _run(cell, seed=11, seconds=1.0, rehearse=True, overrides=None):
    args = harness.parse(["--workload", cell, "--seed", str(seed), "--seconds", str(seconds)]
                         + (["--rehearse"] if rehearse else []))
    run = harness.build(args, time.perf_counter(), overrides)
    return run, harness.measure(run)


def _correct(cell_name, cell, answers=None):
    return check.judge(cell.check(answers), spec.limits(cell_name))[0]


def _half_batch(monkeypatch, model):
    forward = model.forward

    def half(self, x, *a, **k):
        n = max(1, x.shape[0] // 2)
        out = forward(self, x[:n], *a, **k)
        return torch.cat([out, out.mean(dim=0, keepdim=True).expand(x.shape[0] - n, -1)])

    monkeypatch.setattr(model, "forward", half)


def _altered(monkeypatch, model, row):
    forward = model.forward

    def alter(self, x, *a, **k):
        out = forward(self, x, *a, **k).clone()
        if out.shape[0] > row:
            out[row, 1] += 0.5
        return out

    monkeypatch.setattr(model, "forward", alter)


@pytest.mark.parametrize("cell", ["residual.offline", "small_realtime.offline", *SERVE])
def test_unbroken_run_is_correct(cell):
    _, c = _run(cell, seconds=3.0 if cell.endswith("serve") else 1.0)
    assert _correct(cell, c)


@pytest.mark.parametrize("cell,model", [("residual.offline", classifiers.CoughDetectorResidual),
                                        ("small_realtime.offline", classifiers.CoughDetectorSmall),
                                        *[(c, classifiers.CoughDetectorResidual) for c in SERVE]])
def test_half_the_batch_left_out_fails(monkeypatch, cell, model):
    _half_batch(monkeypatch, model)
    _, c = _run(cell, seconds=3.0 if cell.endswith("serve") else 1.0)
    assert not _correct(cell, c)


@pytest.mark.parametrize("cell,model", [("residual.offline", classifiers.CoughDetectorResidual),
                                        ("small_realtime.offline", classifiers.CoughDetectorSmall)])
def test_an_answer_altered_fails_offline(monkeypatch, cell, model):
    _altered(monkeypatch, model, row=5)
    _, c = _run(cell)
    assert not _correct(cell, c)


@pytest.mark.parametrize("cell", SERVE)
def test_an_answer_altered_fails_serving(monkeypatch, cell):
    traffic = spec.traffic(spec.workload(spec.benchmark(), cell)["traffic"])
    n = traffic["rehearsal"]["streams"]
    rng = np.random.default_rng(weights.subseed(11, "sample"))
    sampled = np.sort(rng.choice(n, size=min(n, traffic["rehearsal"]["check_streams"]), replace=False))
    _altered(monkeypatch, classifiers.CoughDetectorResidual, row=int(sampled[0]))
    _, c = _run(cell, seconds=3.0)
    assert not _correct(cell, c)


@pytest.mark.parametrize("cell", SERVE)
def test_a_tick_that_leaves_its_state_unchanged_fails(monkeypatch, cell):
    monkeypatch.setattr(ring, "advance", lambda state, *a, **k: state)
    _, c = _run(cell, seconds=3.0)
    assert not _correct(cell, c)


@pytest.mark.parametrize("cell", ["residual.offline", "small_realtime.offline"])
def test_an_upload_left_out_fails(monkeypatch, cell):
    """No host batch goes up inside the window: each device buffer keeps
    the clips it held after set-up, which differ from the call's own. Three
    warm calls leave the window's first buffer holding host batch 2, so
    the first call already reads stale clips (with two host batches it
    would hold batch 0 again and pass)."""
    generator = spec.generator

    def without_uploads(name):
        module = generator(name)
        window = module.Cell.window

        def no_upload(self):
            self._upload = lambda i: None
            return window(self)

        monkeypatch.setattr(module.Cell, "window", no_upload)
        return module

    monkeypatch.setattr(spec, "generator", without_uploads)
    _, c = _run(cell, overrides={"warm_calls": 3})
    assert not _correct(cell, c)


@pytest.mark.card
@pytest.mark.parametrize("cell,overrides", [("residual.offline", {"batch": 1024}),
                                            ("small_realtime.offline", {"batch": 1024}),
                                            *[(c, {"streams": 1024, "check_streams": 64}) for c in SERVE]])
def test_control_fails_on_the_card(cell, overrides):
    if not torch.cuda.is_available():
        pytest.skip("the control's TF32 exists only on a CUDA card")
    _, c = _run(cell, seconds=3.0, rehearse=False, overrides=overrides)
    assert _correct(cell, c)
    assert not _correct(cell, c, c.control_answers())
