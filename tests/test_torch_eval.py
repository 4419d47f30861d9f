"""PyTorch port's evaluate CLI against the JAX package's, on the CPU (every
port call passes `--device cpu`).

Both CLIs get the same weights through one reference `.pt` (the stream
tests' rescaled small model, whose scores spread over (0, 1)). Dataset
mode prints the JAX CLI's summary (counts exact, loss and rates within
1e-4) on a 16-clip WAV directory and on its packed shards, with a masked
tail batch; the behavioral scenarios are the JAX CLI's bit for bit, and
--behavioral and --calibrate print its numbers, events and recommended
threshold.
"""

import json
import threading
import time

import numpy as np
import pytest

from cough_detector_tpu.cli import evaluate as jevaluate
from cough_detector_tpu.config import default_config as jax_default_config
from cough_detector_tpu.train.checkpoint import export_torch_checkpoint
from cough_detector_tpu_torch.cli import evaluate, pack
from cough_detector_tpu_torch.data import audio_io, synth
from test_torch_models import one_torch_thread  # noqa: F401
from test_torch_stream import audio, weights  # noqa: F401

FLOATS = ("loss", "accuracy", "precision", "recall", "f1")
COUNTS = ("tp", "fp", "fn", "tn")


@pytest.fixture(scope="module")
def pt_model(weights, tmp_path_factory):  # noqa: F811
    """A reference .pt of the stream tests' rescaled small model."""
    pt = tmp_path_factory.mktemp("eval_model") / "model.pt"
    export_torch_checkpoint(str(pt), weights[0], jax_default_config("small"))
    return str(pt)


@pytest.fixture(scope="module")
def clip_dir(tmp_path_factory):
    """16 labeled clips: 8 synthetic coughs and 8 non-coughs of 1-1.5 s."""
    root = tmp_path_factory.mktemp("eval_clips")
    for sub in ("cough", "non_cough"):
        (root / sub).mkdir()
    for i in range(8):
        audio_io.write_wav(root / "cough" / f"c{i}.wav", synth.synthetic_cough(100 + i, 1.0 + 0.0625 * i), 16000)
        audio_io.write_wav(root / "non_cough" / f"n{i}.wav", synth.synthetic_non_cough(200 + i, 1.5 - 0.0625 * i), 16000)
    return root


def _last_json(capsys) -> dict:
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def _both(args, capsys) -> tuple:
    """The port's CLI, which must leave no thread running (its loaders'
    pools and prefetch threads end with the run), then the JAX CLI."""
    before = threading.active_count()
    evaluate.main(args + ["--device", "cpu"])
    deadline = time.monotonic() + 5.0
    while threading.active_count() > before and time.monotonic() < deadline:
        time.sleep(0.01)
    assert threading.active_count() <= before
    ours = _last_json(capsys)
    jevaluate.main(args)
    return ours, _last_json(capsys)


@pytest.mark.parametrize("source", ["wav_dir", "shards"])
def test_dataset_mode_matches_the_jax_cli(pt_model, clip_dir, tmp_path, capsys, source):
    data = clip_dir
    if source == "shards":
        data = tmp_path / "shards"
        pack.main(["--data-dir", str(clip_dir), "--output", str(data), "--no-split", "--num-workers", "2"])
        capsys.readouterr()
    args = ["--model", pt_model, "--data-dir", str(data), "--batch-size", "5", "--num-workers", "2",
            "--single-device"]
    ours, theirs = _both(args, capsys)
    assert sum(ours[k] for k in COUNTS) == 16
    assert {k: ours[k] for k in COUNTS} == {k: theirs[k] for k in COUNTS}
    assert 0 < ours["tp"] + ours["fp"] < 16  # the model says both classes
    for k in FLOATS:
        assert abs(ours[k] - theirs[k]) <= 1e-4, k


def test_dataset_mode_over_a_mesh_equals_one_device(pt_model, clip_dir, capsys):
    """Batches of 5 split over ["cpu", "cpu"] and ["cpu", "cpu", "cpu"] (padded
    to 6, the padded rows masked): the counts of one device exactly, the
    loss and rates within rtol 1e-5 (tests/test_sharding.py's bound; each
    device's convolutions see another batch size)."""
    args = ["--model", pt_model, "--data-dir", str(clip_dir), "--batch-size", "5",
            "--num-workers", "2", "--device", "cpu"]
    evaluate.main(args + ["--single-device"])
    one = _last_json(capsys)
    for mesh in ("cpu,cpu", "cpu,cpu,cpu"):
        evaluate.main(args + ["--mesh", mesh])
        split = _last_json(capsys)
        assert {k: split[k] for k in COUNTS} == {k: one[k] for k in COUNTS}
        for k in FLOATS:
            assert abs(split[k] - one[k]) <= 1e-5 * abs(one[k]), (mesh, k)


def test_dataset_mode_needs_a_data_dir(pt_model):
    with pytest.raises(SystemExit, match="--data-dir"):
        evaluate.main(["--model", pt_model, "--device", "cpu"])


@pytest.mark.parametrize("seed", [0, 5])
def test_scenario_signals_equal_the_jax_clis(seed):
    ours = evaluate._scenario_signals(seed, 0.25)
    theirs = jevaluate._scenario_signals(seed, 0.25)
    for name, a, b in zip(("silence", "speech", "coughs", "confusables"), ours, theirs):
        if name == "coughs":
            assert a[1] == b[1]
            a, b = a[0], b[0]
        assert a.dtype == b.dtype == np.float32 and np.array_equal(a, b), name


def test_match_detections_is_event_honest():
    """A double fire on one cough and a miss on another do not score 100%."""
    matched, spurious = evaluate.match_detections([1.0, 1.5, 11.0, 20.5], [0.0, 5.0, 10.0], span=3.0)
    assert matched == {0, 2} and spurious == 1
    assert (matched, spurious) == jevaluate.match_detections([1.0, 1.5, 11.0, 20.5], [0.0, 5.0, 10.0], span=3.0)


def test_behavioral_mode_matches_the_jax_cli(pt_model, capsys):
    ours, theirs = _both(["--model", pt_model, "--behavioral", "--minutes", "0.1", "--threshold", "0.5"], capsys)
    assert ours == theirs
    assert ours["coughs_matched"] + ours["coughs_missed"] == 1


def test_calibrate_mode_matches_the_jax_cli(pt_model, capsys):
    """The self-check (replay == live engine at --threshold) passes in both,
    and the sweep, the bands and the recommended threshold are equal."""
    ours, theirs = _both(["--model", pt_model, "--calibrate", "--minutes", "0.1", "--threshold", "0.5"], capsys)
    assert len(ours["sweep"]) == 19
    assert ours == theirs
    counts = {(r["fp_per_min_speech"], r["fp_per_min_confusables"]) for r in ours["sweep"]}
    assert len(counts) > 1  # the sweep moves across the model's scores
