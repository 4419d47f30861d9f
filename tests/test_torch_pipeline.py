"""The PyTorch port's pipelined epochs and scoring programs, on the CPU.

Training (a residual model, 40 + 12 shard clips, batch 8: 5 train and 2
validation steps an epoch): one process with a resident corpus runs its
epochs pipelined one deep; `loop._PIPELINED = False` gives the synchronous
loop it is held against, with the steps eager and through the captured
programs (`loop._graphed_steps`), 3 epochs and an early stop forced at
epoch 1: per-step losses, the probes (SCAN_MATS, ROW_HASHES, STEP_LOSSES)
and the launch counters (each feature call counted, as the card's kernel
wrappers count) equal; both checkpoints and metrics.jsonl (less timings)
bit-equal; the in-memory model, BatchNorm statistics, moments and
optimizer.count the last finished epoch's, so a discarded epoch leaves
nothing. A run resumed from a pipelined run's latest_model equals the
uninterrupted one.

Scoring (the stream tests' small model, whose scores spread): the offline
scorer, `scores_for`, `predict`, evaluate's dataset mode, featurize and
extract-segments' scorer against the JAX package's own functions on the
same numpy inputs and weights (1e-3 max-relative, docs/PARITY.md; offline
event times and evaluate's counts exact); each path through its programs
against its eager function (the function called on its inputs, no static
buffers), bit for bit; the bounded key rule against unpadded scoring.
"""

import json
import re
import threading

import numpy as np
import pytest
import torch

from cough_detector_tpu.cli import evaluate as jevaluate
from cough_detector_tpu.cli import extract_segments as jsegments
from cough_detector_tpu.cli import featurize as jfeaturize
from cough_detector_tpu.config import default_config as jax_default_config
from cough_detector_tpu.ops import filters as jfilters
from cough_detector_tpu.stream import offline as joffline
from cough_detector_tpu.stream.detector import CoughDetectorInference as JaxInference
from cough_detector_tpu.stream.detector import StreamingDetector as JaxDetector
from cough_detector_tpu.train.checkpoint import export_torch_checkpoint
from cough_detector_tpu.utils.observability import LatencyTracker as JaxLatencyTracker
from cough_detector_tpu_torch.cli import evaluate, extract_segments, featurize
from cough_detector_tpu_torch.config import Config, ModelConfig, TrainConfig, default_config
from cough_detector_tpu_torch.data import audio_io, pack_arrays, synth
from cough_detector_tpu_torch.ops import filters, frontend_kernel
from cough_detector_tpu_torch.stream import CoughDetectorInference, StreamingDetector, offline
from cough_detector_tpu_torch.train import checkpoint, loop, steps
from cough_detector_tpu_torch.utils import graphs
from cough_detector_tpu_torch.utils.observability import LatencyTracker
from test_torch_models import one_torch_thread  # noqa: F401
from test_torch_stream import audio, weights  # noqa: F401
from test_torch_train import _corpus

SR = 16000
TOL = 1e-3  # max-relative, the parity budget (docs/PARITY.md)


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-8))


# -- pipelined epochs ---------------------------------------------------------------


@pytest.fixture(scope="module")
def shards(tmp_path_factory):
    root = tmp_path_factory.mktemp("pipeline_shards")
    pack_arrays(*_corpus(40, 0), str(root / "train"), shard_size=16)
    pack_arrays(*_corpus(12, 500), str(root / "val"))
    return root


def _cfg(epochs: int, stop: bool = False) -> Config:
    # A stop at epoch 1: its validation loss cannot beat epoch 0's by 1e9.
    train = TrainConfig(batch_size=8, epochs=epochs, patience=1 if stop else 50,
                        early_stop_min_delta=1e9 if stop else 0.001)
    return Config(model=ModelConfig(model_type="residual"), train=train)


_REAL = (loop.model_from_config, steps.make_optimizer, loop.make_feature_fns)


def _train(out, shards, cfg, monkeypatch, capsys, *, pipelined=True, programs=False, resume=None) -> dict:
    """train() on the CPU with the probes on and each feature call counted
    as a launch; returns the printed probes and the run's model and
    optimizer as train() left them."""
    monkeypatch.setattr(loop, "_PIPELINED", pipelined)
    monkeypatch.setattr(loop, "_graphed_steps", lambda dev, group: programs)
    monkeypatch.setenv("CDT_DEBUG_STEP_METRICS", "1")
    monkeypatch.setattr(frontend_kernel, "SPECTRAL_LAUNCHES", 0)
    monkeypatch.setattr(frontend_kernel, "EPILOGUE_LAUNCHES", 0)
    held = {}
    real_model, real_opt, real_features = _REAL

    def model_from_config(*args, **kwargs):
        held["model"] = real_model(*args, **kwargs)
        return held["model"]

    def make_optimizer(*args, **kwargs):
        held["optimizer"] = real_opt(*args, **kwargs)
        return held["optimizer"]

    def counted(fn):
        def call(*args):
            frontend_kernel.SPECTRAL_LAUNCHES += 1
            frontend_kernel.EPILOGUE_LAUNCHES += 1
            return fn(*args)

        return call

    def make_feature_fns(*args, **kwargs):
        return tuple(counted(f) for f in real_features(*args, **kwargs))

    monkeypatch.setattr(loop, "model_from_config", model_from_config)
    monkeypatch.setattr(steps, "make_optimizer", make_optimizer)
    monkeypatch.setattr(loop, "make_feature_fns", make_feature_fns)
    capsys.readouterr()
    loop.train(None, str(out), config=cfg, shards_dir=str(shards), device="cpu", resume=resume)
    text = capsys.readouterr().out
    assert not [t for t in threading.enumerate() if t.name.startswith("cdt-ckpt")]
    probes = {
        name: re.findall(rf"^{name} (.*)$", text, re.M)
        for name in ("STEP_LOSSES", "SCAN_MATS", "ROW_HASHES", "KERNEL_LAUNCHES")
    }
    return dict(probes=probes, text=text, **held)


def _records(out) -> list:
    skip = {"train_clips_per_sec", "val_clips_per_sec", "wall_s", "t"}
    return [{k: v for k, v in json.loads(line).items() if k not in skip}
            for line in (out / "metrics.jsonl").read_text().splitlines()]


def _assert_same_checkpoints(out_a, out_b):
    for name in ("best_model", "latest_model"):
        (a, ea, ma, _), (b, eb, mb, _) = (checkpoint.load_checkpoint(str(o / name)) for o in (out_a, out_b))
        assert (ea, ma, a["step"], a["optimizer"]["count"]) == (eb, mb, b["step"], b["optimizer"]["count"]), name
        assert a["model"].keys() == b["model"].keys()
        for k, v in a["model"].items():
            assert torch.equal(v, b["model"][k]), (name, k)
        for x, y in zip(a["optimizer"]["mu"] + a["optimizer"]["nu"], b["optimizer"]["mu"] + b["optimizer"]["nu"]):
            assert torch.equal(x, y), name


def _assert_in_memory_is(run: dict, out):
    """The run's model (BatchNorm statistics too), moments and count equal
    the latest_model checkpoint's."""
    tree = checkpoint.load_checkpoint(str(out / "latest_model"))[0]
    for k, v in run["model"].state_dict().items():
        assert torch.equal(v, tree["model"][k]), k
    opt = run["optimizer"]
    assert opt.count == tree["optimizer"]["count"]
    for x, y in zip(opt.mu + opt.nu, tree["optimizer"]["mu"] + tree["optimizer"]["nu"]):
        assert torch.equal(x, y)


@pytest.mark.parametrize("stop", [False, True], ids=["three_epochs", "early_stop"])
@pytest.mark.parametrize("programs", [False, True], ids=["eager_steps", "programs"])
def test_pipelined_epochs_equal_the_synchronous_loop(shards, tmp_path, monkeypatch, capsys, stop, programs):
    runs = {
        mode: _train(tmp_path / mode, shards, _cfg(3, stop), monkeypatch, capsys,
                     pipelined=mode == "pipelined", programs=programs)
        for mode in ("synchronous", "pipelined")
    }
    sync, pipe = runs["synchronous"], runs["pipelined"]
    epochs = [0, 1] if stop else [0, 1, 2]
    assert [r["epoch"] for r in _records(tmp_path / "pipelined")] == epochs
    assert _records(tmp_path / "pipelined") == _records(tmp_path / "synchronous")
    _assert_same_checkpoints(tmp_path / "pipelined", tmp_path / "synchronous")
    # Probes and counters: the finished epochs', in order; none of a
    # discarded epoch's (each epoch 5 train + 2 validation calls).
    assert pipe["probes"] == sync["probes"]
    losses = [json.loads(line.split(" ", 1)[1]) for line in pipe["probes"]["STEP_LOSSES"]]
    assert [len(x) for x in losses] == [5] * len(epochs) and all(np.isfinite(x).all() for x in losses)
    assert [m.split()[0] for m in pipe["probes"]["SCAN_MATS"]] == [f"epoch={e}" for e in epochs]
    n = 7 * len(epochs)
    assert pipe["probes"]["KERNEL_LAUNCHES"] == [f"rank=0 spectral={n} epilogue={n}"]
    assert ("Early stopping at epoch 1" in pipe["text"]) is stop
    for run, out in ((pipe, tmp_path / "pipelined"), (sync, tmp_path / "synchronous")):
        _assert_in_memory_is(run, out)
        assert run["optimizer"].count == 5 * len(epochs)


def test_resuming_a_pipelined_run_gives_the_uninterrupted_run(shards, tmp_path, monkeypatch, capsys):
    straight, resumed = tmp_path / "straight", tmp_path / "resumed"
    _train(straight, shards, _cfg(3), monkeypatch, capsys)
    _train(resumed, shards, _cfg(1), monkeypatch, capsys)
    run = _train(resumed, shards, _cfg(3), monkeypatch, capsys, resume=str(resumed / "latest_model"))
    assert [r["epoch"] for r in _records(resumed)] == [0, 1, 2]
    assert _records(resumed) == _records(straight)
    _assert_same_checkpoints(resumed, straight)
    _assert_in_memory_is(run, resumed)


def test_upload_packs_a_run_of_inputs_into_one_buffer():
    rng = np.random.default_rng(0)
    run = [
        {"batch": rng.integers(0, 9, (2, 5)), "mask": rng.random(5).astype(np.float32),
         "opt": rng.random(3).astype(np.float32), "perm": rng.permutation(5)}
        for _ in range(4)
    ]
    staged = graphs.upload(run, "cpu")
    bases = {t.untyped_storage().data_ptr() for step in staged for t in step.values()}
    assert len(bases) == 1  # one buffer, one copy
    for want, got in zip(run, staged):
        assert list(got) == list(want)
        for k, a in want.items():
            assert got[k].dtype == torch.from_numpy(a).dtype and np.array_equal(got[k].numpy(), a), k
    tree = ({"a": torch.ones(2)}, [torch.zeros(3), 4])
    assert graphs.fetch(tree, None) is tree


# -- the scoring programs ---------------------------------------------------------


class _Eager(graphs.Programs):
    """The eager function: called on the call's own inputs, no static
    buffers, no graphs."""

    def __call__(self, key, fn, inputs, copy=None):
        return tuple(fn({k: torch.as_tensor(v).to(self.device) for k, v in inputs.items()}))


@pytest.fixture(scope="module")
def pt_model(weights, tmp_path_factory):  # noqa: F811
    pt = tmp_path_factory.mktemp("pipeline_model") / "model.pt"
    export_torch_checkpoint(str(pt), weights[0], jax_default_config("small"))
    return str(pt)


@pytest.fixture(scope="module")
def recording():
    """9 s: three coughs in noise (33 windows, shorter than one batch)."""
    rng = np.random.default_rng(4)
    wave = (rng.standard_normal(9 * SR) * 0.02).astype(np.float32)
    for i, at in enumerate((1.0, 4.0, 6.5)):
        c = synth.synthetic_cough(40 + i, 1.5)
        wave[int(at * SR) : int(at * SR) + len(c)] += c
    return wave


def _windows(n: int, seed: int = 9) -> np.ndarray:
    rng = np.random.default_rng(seed)
    rows = [synth.synthetic_cough(seed + i, 1.0) if i % 2 else synth.synthetic_non_cough(seed + i, 1.0)
            for i in range(n)]
    return (np.stack(rows) * rng.uniform(0.3, 1.0, (n, 1))).astype(np.float32)


@pytest.mark.parametrize("batch_size", [1024, 16], ids=["one_bucketed_batch", "batches_of_16"])
def test_offline_scoring_matches_jax(weights, recording, batch_size):  # noqa: F811
    kw = dict(threshold=0.0, smoothing_window=1, debounce_seconds=0.0, batch_size=batch_size)
    want = joffline.score_recording(recording, weights[0], jax_default_config("small"), mesh=False, **kw)
    got = offline.score_recording(recording, weights[1], default_config("small"), device="cpu", **kw)
    assert [e.time_seconds for e in got] == [e.time_seconds for e in want] and len(got) == 33
    assert _rel([e.confidence for e in got], [e.confidence for e in want]) < TOL


@pytest.mark.parametrize("n", [5, 37])
def test_scores_for_and_segment_scorer_match_jax(weights, pt_model, n):  # noqa: F811
    w = _windows(n)
    ours = StreamingDetector(variables=weights[1], config=default_config("small"), device="cpu").scores_for(w)
    theirs = JaxDetector(variables=weights[0], config=jax_default_config("small"), mesh=False).scores_for(w)
    assert ours.shape == (n,) and _rel(ours, theirs) < TOL and np.ptp(theirs) > 0.05
    seg = extract_segments._make_scorer(pt_model, "cpu")(w)
    assert _rel(seg, jsegments._make_scorer(pt_model)(w)) < TOL


def test_predict_matches_jax(pt_model):
    feats = np.random.default_rng(2).standard_normal((3, 1, 90, 101)).astype(np.float32)
    ours = CoughDetectorInference(pt_model, device="cpu", verbose=False)
    theirs = JaxInference(pt_model, verbose=False)
    for x in (feats[0], feats):
        (a, p), (b, q) = ours.predict(x), theirs.predict(x)
        assert a == b and abs(p - q) <= TOL * max(abs(q), 1e-8)
    assert ours.predict_programs.keys == [(1, 1, 90, 101), (3, 1, 90, 101)]


@pytest.fixture(scope="module")
def clips(tmp_path_factory):
    """6 labeled WAV clips of 1-1.5 s, and their packed shards."""
    root = tmp_path_factory.mktemp("pipeline_clips")
    for sub in ("cough", "non_cough"):
        (root / "wav" / sub).mkdir(parents=True)
    for i in range(3):
        audio_io.write_wav(root / "wav" / "cough" / f"c{i}.wav", synth.synthetic_cough(70 + i, 1.0 + 0.25 * i), SR)
        audio_io.write_wav(root / "wav" / "non_cough" / f"n{i}.wav", synth.synthetic_non_cough(80 + i, 1.5), SR)
    pack_arrays(*_corpus(10, 900), str(root / "shards"))
    return root


def _json_of(main, args, capsys) -> dict:
    capsys.readouterr()
    main(args)
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_evaluate_matches_jax(pt_model, clips, capsys):
    args = ["--model", pt_model, "--data-dir", str(clips / "shards"), "--batch-size", "4"]
    ours = _json_of(evaluate.main, args + ["--device", "cpu"], capsys)
    theirs = _json_of(jevaluate.main, args, capsys)
    assert {k: ours[k] for k in ("tp", "fp", "fn", "tn")} == {k: theirs[k] for k in ("tp", "fp", "fn", "tn")}
    assert ours["tp"] + ours["fp"] + ours["fn"] + ours["tn"] == 10
    assert abs(ours["loss"] - theirs["loss"]) <= TOL * abs(theirs["loss"])


def test_featurize_matches_jax(clips, tmp_path, capsys):
    args = ["--data-dir", str(clips / "wav"), "--batch-size", "4", "--num-workers", "2"]
    featurize.main(args + ["--output", str(tmp_path / "ours.npz"), "--device", "cpu"])
    jfeaturize.main(args + ["--output", str(tmp_path / "theirs.npz")])
    ours, theirs = np.load(tmp_path / "ours.npz"), np.load(tmp_path / "theirs.npz")
    assert ours["features"].shape == theirs["features"].shape == (6, 90, 101)
    assert _rel(ours["features"], theirs["features"]) < TOL
    np.testing.assert_array_equal(ours["labels"], theirs["labels"])


def test_every_scoring_path_equals_its_eager_function(weights, pt_model, recording, clips, tmp_path,  # noqa: F811
                                                      monkeypatch, capsys):
    """Each path through its programs, then with `graphs.Programs` calling
    the function on its inputs: equal bit for bit (featurize with its
    augmentation's draws too)."""
    w = _windows(21)
    feats = np.random.default_rng(3).standard_normal((2, 1, 90, 101)).astype(np.float32)
    eval_args = ["--model", pt_model, "--data-dir", str(clips / "shards"), "--batch-size", "4", "--device", "cpu"]

    def paths(tag: str) -> dict:
        det = StreamingDetector(variables=weights[1], config=default_config("small"), device="cpu")
        out = {
            "offline": offline.window_probs(recording, weights[1], default_config("small"), device="cpu"),
            "offline_16": offline.window_probs(recording, weights[1], default_config("small"), device="cpu",
                                               batch_size=16),
            "scores_for": det.scores_for(w),
            "predict": CoughDetectorInference(pt_model, device="cpu", verbose=False).predict(feats)[1],
            "evaluate": _json_of(evaluate.main, eval_args, capsys),
        }
        for aug in ([], ["--augment"]):
            npz = tmp_path / f"{tag}{len(aug)}.npz"
            featurize.main(["--data-dir", str(clips / "wav"), "--batch-size", "4", "--num-workers", "2",
                            "--seed", "3", "--output", str(npz), "--device", "cpu"] + aug)
            out[f"featurize{aug}"] = np.load(npz)["features"]
        return out

    programs = paths("programs")
    monkeypatch.setattr(graphs, "Programs", _Eager)
    eager = paths("eager")
    for k, v in programs.items():
        assert np.array_equal(v, eager[k]) if isinstance(v, np.ndarray) else v == eager[k], k
    assert not np.array_equal(programs["featurize[]"], programs["featurize['--augment']"])


def test_bucketed_batches_score_every_row_as_unpadded(weights):  # noqa: F811
    """scores_for pads a batch of n to the next power of two (at least 16):
    every real row's probability is the unpadded batch's within 1e-4
    (the CPU's convolutions sum in another order below 16 rows, 2.1e-5
    apart at most; from 16 rows on they are equal), and 1-40 rows take 3
    keys."""
    det = StreamingDetector(variables=weights[1], config=default_config("small"), device="cpu")
    w = _windows(40)
    for n in range(1, 41):
        got = det.scores_for(w[:n])
        with torch.no_grad():
            want = det._score_fn(torch.from_numpy(w[:n])).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 if n < 16 else 0)
    assert [k[0][0] for k in det.score_programs.keys] == [16, 32, 64]
    assert [graphs.bucket_rows(n) for n in (1, 16, 17, 1000)] == [16, 16, 32, 1024]
    assert graphs.bucket_rows(600, cap=512) == 512


def test_short_recording_scores_as_unpadded(weights, recording):  # noqa: F811
    """window_probs of a recording shorter than a batch pads it to its
    bucket (33 windows → 64): every window's probability is the unpadded
    batch's (1e-4, as above)."""
    cfg = default_config("small")
    got = offline.window_probs(recording, weights[1], cfg, device="cpu")
    det = StreamingDetector(variables=weights[1], config=cfg, device="cpu")
    wins = offline.frame_windows(torch.from_numpy(recording), SR, 4000)
    with torch.no_grad():
        want = det._score_fn(wins.contiguous()).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


# -- the small API gaps -------------------------------------------------------------


def test_latency_percentiles_match_jax():
    ours, theirs = LatencyTracker(maxlen=16), JaxLatencyTracker(maxlen=16)
    assert ours.percentiles() == theirs.percentiles() == {"p50": 0.0, "p90": 0.0, "p99": 0.0, "n": 0}
    for v in np.random.default_rng(1).exponential(0.01, 40):
        ours.record(float(v))
        theirs.record(float(v))
    assert ours.percentiles() == theirs.percentiles() and ours.percentiles()["n"] == 16


@pytest.mark.parametrize("n_fft,win_length,n1", [(512, 400, 16), (256, 200, 8)])
def test_four_step_dft_matrices_equal_jax(n_fft, win_length, n1):
    ours = filters.four_step_dft_matrices(n_fft, win_length, n1)
    theirs = jfilters.four_step_dft_matrices(n_fft, win_length, n1)
    for a, b in zip(ours, theirs):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    m1c, m1s, twc, tws, m2c, m2s = filters.four_step_dft_matrices(n_fft, win_length, n1, dtype=np.dtype(np.float64))
    x = np.random.default_rng(0).standard_normal((4, n_fft))
    br, bi = x @ m1c, x @ m1s
    cr, ci = br * twc - bi * tws, br * tws + bi * twc
    truth = np.fft.rfft(x * filters.padded_window(win_length, n_fft), axis=-1)
    np.testing.assert_allclose(cr @ m2c - ci @ m2s, truth.real, atol=1e-9)
    np.testing.assert_allclose(cr @ m2s + ci @ m2c, truth.imag, atol=1e-9)
    with pytest.raises(ValueError, match="multiple"):
        filters.four_step_dft_matrices(500, 400, 16)
