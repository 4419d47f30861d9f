"""PyTorch port's command-line entry points against the JAX package's, on
the CPU (every port call passes `--device cpu`).

`prepare_data` writes the JAX CLI's WAVs byte for byte; `pack` writes its
shards; `detect --wav` prints its lines for the same reference `.pt`, one
file through offline scoring and several as lanes of one tick (padding
lanes and padding-only windows print nothing); `featurize` writes features
within 1e-3 of its; `train --data-dir` trains an epoch that `detect`
serves. No module of the port, and not chip_smoke.py, imports JAX or the
JAX package.
"""

import json
import re
from pathlib import Path

import numpy as np
import pytest

from cough_detector_tpu.cli import detect as jdetect
from cough_detector_tpu.cli import featurize as jfeaturize
from cough_detector_tpu.cli import pack as jpack
from cough_detector_tpu.cli import prepare_data as jprepare
from cough_detector_tpu.config import default_config as jax_default_config
from cough_detector_tpu.train.checkpoint import export_torch_checkpoint
from cough_detector_tpu_torch.cli import detect, featurize, pack, prepare_data
from cough_detector_tpu_torch.cli import train as train_cli
from cough_detector_tpu_torch.data import audio_io, synth
from test_torch_models import one_torch_thread  # noqa: F401
from test_torch_stream import audio, weights  # noqa: F401

REPO = Path(__file__).resolve().parents[1]
PREPARE = ["--skip-download", "--synthetic-coughs", "12", "--synthetic-non-coughs", "12",
           "--hard-negatives", "0.3", "--seed", "4"]


@pytest.fixture(scope="module")
def data_dirs(tmp_path_factory):
    """The port's and the JAX CLI's prepare_data outputs, plus one clip at
    44.1 kHz in each, which the loaders resample."""
    root = tmp_path_factory.mktemp("prepared")
    out = {}
    for name, cli in (("ours", prepare_data), ("theirs", jprepare)):
        cli.main(PREPARE + ["--output-dir", str(root / name), "--esc50-dir", str(root / "no_esc50")])
        wave = synth.synthetic_cough(77, 1.5, 44100)
        audio_io.write_wav(root / name / "cough" / "resampled.wav", wave, 44100)
        out[name] = root / name
    return out


def _files(d: Path) -> dict:
    return {p.relative_to(d): p.read_bytes() for p in sorted(d.rglob("*")) if p.is_file()}


def test_prepare_data_writes_the_jax_clis_wavs(data_dirs):
    ours, theirs = _files(data_dirs["ours"]), _files(data_dirs["theirs"])
    assert len(ours) == 25 and ours == theirs
    assert sum(1 for p in ours if "synthetic_hard" in str(p)) == 4


def test_pack_writes_the_jax_clis_shards(data_dirs, tmp_path, capsys, monkeypatch):
    # The port decodes in Python ("auto" until the native decoder is
    # ported); the JAX CLI's native decoder resamples within 2e-5 of it
    # (tests/test_native_loader.py), which moves some int16 codes.
    from cough_detector_tpu.data import native_loader

    monkeypatch.setattr(native_loader, "available", lambda: False)
    reports = []
    for name, cli in (("ours", pack), ("theirs", jpack)):
        cli.main(["--data-dir", str(data_dirs["ours"]), "--output", str(tmp_path / name),
                  "--shard-size", "8", "--num-workers", "2"])
        report = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        del report["seconds"], report["output"]
        reports.append(report)
    assert reports[0] == reports[1] and reports[0]["train"]["clips"] == 20
    ours, theirs = _files(tmp_path / "ours"), _files(tmp_path / "theirs")
    assert len(ours) == 2 + 2 * (3 + 1) and ours == theirs


@pytest.fixture(scope="module")
def pt_and_wavs(weights, tmp_path_factory):  # noqa: F811
    """A reference .pt of the stream tests' rescaled small model, a 9 s
    recording and a 4 s one."""
    root = tmp_path_factory.mktemp("detect")
    pt = root / "model.pt"
    export_torch_checkpoint(str(pt), weights[0], jax_default_config("small"))
    rng = np.random.default_rng(5)
    noise = lambda s: (rng.standard_normal(int(s * 16000)) * 0.05).astype(np.float32)  # noqa: E731
    long = np.concatenate([noise(1.0), synth.synthetic_cough(1, 2.0), noise(1.5), synth.synthetic_non_cough(2, 2.0),
                           synth.synthetic_cough(3, 2.5)])
    short = np.concatenate([synth.synthetic_cough(4, 2.0), noise(2.0)])
    wavs = []
    for name, wave in (("long.wav", long), ("short.wav", short)):
        audio_io.write_wav(root / name, wave, 16000)
        wavs.append(str(root / name))
    return str(pt), wavs


def _detect_lines(cli, args, capsys, device_args):
    cli.main(args + device_args)
    return [line for line in capsys.readouterr().out.splitlines() if "cough" in line.lower()]


@pytest.mark.parametrize("mode", ["one_file", "lanes"])
def test_detect_prints_the_jax_clis_lines(pt_and_wavs, capsys, mode):
    pt, wavs = pt_and_wavs
    args = ["--model", pt, "--threshold", "0.5", "--wav"]
    args += wavs[:1] if mode == "one_file" else wavs[::-1] + ["--streams", "3"]
    got = _detect_lines(detect, args, capsys, ["--device", "cpu"])
    want = _detect_lines(jdetect, args, capsys, [])
    assert got == want and got and "No coughs" not in got[0]
    if mode == "lanes":
        # Lane 0 holds the 4 s file: no event may come from its padding.
        short = [float(re.search(r"t=([0-9.]+)s", line).group(1)) for line in got if "short.wav" in line]
        assert short and max(short) - 1.0 < 4.0
        assert any("long.wav" in line for line in got)


def _max_rel(got, want) -> float:
    return float(np.abs(got - want).max() / np.abs(want).max())


def test_featurize_matches_the_jax_cli(data_dirs, tmp_path, capsys):
    args = ["--data-dir", str(data_dirs["ours"]), "--batch-size", "8", "--num-workers", "2"]
    featurize.main(args + ["--output", str(tmp_path / "ours.npz"), "--device", "cpu"])
    report = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    jfeaturize.main(args + ["--output", str(tmp_path / "theirs.npz")])
    ours, theirs = np.load(tmp_path / "ours.npz"), np.load(tmp_path / "theirs.npz")
    assert report["clips"] == 25 and report["feature_shape"] == [90, 101] and report["device"] == "cpu"
    assert ours["features"].shape == theirs["features"].shape == (25, 90, 101)
    assert _max_rel(ours["features"], theirs["features"]) < 1e-3
    assert np.array_equal(ours["labels"], theirs["labels"]) and np.array_equal(ours["paths"], theirs["paths"])
    featurize.main(args + ["--output", str(tmp_path / "aug.npz"), "--device", "cpu", "--augment"])
    aug = np.load(tmp_path / "aug.npz")["features"]
    assert np.isfinite(aug).all() and not np.array_equal(aug, ours["features"])


def test_train_from_a_data_dir_then_detect(data_dirs, pt_and_wavs, tmp_path, capsys):
    out = tmp_path / "run"
    train_cli.main([
        "--data-dir", str(data_dirs["ours"]), "--no-esc50", "--output-dir", str(out),
        "--model-type", "small", "--epochs", "1", "--batch-size", "8", "--num-workers", "2",
        "--device", "cpu", "--export-pt",
    ])
    records = [json.loads(line) for line in (out / "metrics.jsonl").read_text().splitlines()]
    assert [r["epoch"] for r in records] == [0] and np.isfinite(records[0]["train_loss"])
    capsys.readouterr()
    for model in (out / "best_model", out / "best_model.pt"):
        detect.main(["--model", str(model), "--wav", pt_and_wavs[1][1], "--threshold", "0", "--device", "cpu"])
        lines = capsys.readouterr().out.splitlines()
        assert len(lines) >= 5 and all(line.startswith("cough at t=") for line in lines)


def test_port_sources_import_no_jax():
    pattern = re.compile(r"^\s*(import|from)\s+(jax|flax|optax|orbax|cough_detector_tpu)(\.|\s|$)", re.M)
    files = sorted((REPO / "cough_detector_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 40
    for f in files:
        assert not pattern.search(f.read_text()), f
