"""PyTorch port's curation and setup tools and its reference-API facades
against the JAX package's, on the CPU (every port call passes
`--device cpu` / device="cpu").

`audit` writes the JAX CLI's report (flags, counts; p_cough within 1e-4
for the same reference `.pt`) on a directory with planted silent, clipped,
DC-offset, short and undecodable clips; `extract_segments` writes the JAX
CLI's segment files byte for byte in both modes and keeps the same ones
when scoring; `setup_coughvid` writes the JAX CLI's WAVs from a local
synthetic COUGHVID tree (nothing downloads); the preprocessing facade's
features hold the 1e-3 budget against the JAX facade's and the
augmentation facade keeps the reference's semantics.
"""

import json

import numpy as np
import pandas as pd
import pytest

from cough_detector_tpu import augmentation as jaugmentation
from cough_detector_tpu import preprocessing as jpreprocessing
from cough_detector_tpu.cli import audit as jaudit
from cough_detector_tpu.cli import extract_segments as jextract
from cough_detector_tpu.cli import setup_coughvid as jsetup
from cough_detector_tpu_torch import augmentation, preprocessing
from cough_detector_tpu_torch.cli import audit, extract_segments, setup_coughvid
from cough_detector_tpu_torch.data import audio_io, synth
from test_torch_eval import pt_model  # noqa: F401
from test_torch_frontend import _rel
from test_torch_models import one_torch_thread  # noqa: F401
from test_torch_stream import audio, weights  # noqa: F401

SR = 16000


def _files(d) -> dict:
    return {p.relative_to(d): p.read_bytes() for p in sorted(d.rglob("*")) if p.is_file()}


@pytest.fixture(scope="module")
def audit_dir(tmp_path_factory):
    """12 healthy clips and 5 planted ones: silent, clipped, DC offset,
    short, and a file that is not audio."""
    root = tmp_path_factory.mktemp("audit")
    for sub in ("cough", "non_cough"):
        (root / sub).mkdir()
    for i in range(6):
        audio_io.write_wav(root / "cough" / f"c{i}.wav", synth.synthetic_cough(300 + i, 1.0), SR)
        audio_io.write_wav(root / "non_cough" / f"n{i}.wav", synth.synthetic_non_cough(400 + i, 1.2), SR)
    rng = np.random.default_rng(1)
    clipped = np.clip(rng.standard_normal(SR) * 2.0, -1.0, 1.0).astype(np.float32)
    dc = (0.3 + 0.05 * rng.standard_normal(SR)).astype(np.float32)
    audio_io.write_wav(root / "cough" / "silent.wav", np.zeros(SR, np.float32), SR)
    audio_io.write_wav(root / "cough" / "clipped.wav", clipped, SR)
    audio_io.write_wav(root / "non_cough" / "dc.wav", dc, SR)
    audio_io.write_wav(root / "non_cough" / "short.wav", synth.synthetic_cough(9, 1.0)[: SR // 10], SR)
    (root / "cough" / "broken.wav").write_bytes(b"not a wav file at all")
    return root


def _audit(cli, args, report, capsys) -> tuple:
    cli.main(args + ["--report", str(report)])
    counts = json.loads(capsys.readouterr().out.strip().splitlines()[-2])
    return counts, [json.loads(line) for line in report.read_text().splitlines()]


@pytest.mark.parametrize("scored", [False, True])
def test_audit_matches_the_jax_cli(audit_dir, pt_model, tmp_path, capsys, scored):  # noqa: F811
    args = ["--data-dir", str(audit_dir), "--batch-size", "5"]
    if scored:
        args += ["--model", pt_model]
    ours, ours_recs = _audit(audit, args + ["--device", "cpu"], tmp_path / "ours.jsonl", capsys)
    theirs, their_recs = _audit(jaudit, args, tmp_path / "theirs.jsonl", capsys)
    assert ours == theirs
    assert ours["total"] == 17
    assert all(ours[k] >= 1 for k in ("decode_failed", "silent", "clipped", "dc_offset", "short"))
    flags = {r["path"].rsplit("/", 1)[1]: r["flags"] for r in ours_recs}
    assert "silent" in flags["silent.wav"] and "clipped" in flags["clipped.wav"]
    assert "dc_offset" in flags["dc.wav"] and flags["broken.wav"] == ["decode_failed"]
    for a, b in zip(ours_recs, their_recs):
        p_a, p_b = a.pop("p_cough", None), b.pop("p_cough", None)
        assert a == b
        assert (p_a is None) == (p_b is None) == (not scored or "decode_failed" in a["flags"])
        if p_a is not None:
            assert abs(p_a - p_b) <= 1e-4
    if scored:
        assert 0 < ours["label_disagreement"] < 17


@pytest.fixture(scope="module")
def long_recordings(tmp_path_factory):
    """8 s of near-silence with two loud coughs at 2 s and 5.5 s, and 3.5 s
    of one louder cough under noise, in a subdirectory."""
    d = tmp_path_factory.mktemp("long")
    rng = np.random.default_rng(0)
    wave = rng.standard_normal(8 * SR) * 1e-4
    for pos in (2.0, 5.5):
        c = synth.synthetic_cough(7, 1.0)
        lo = int(pos * SR)
        wave[lo : lo + len(c)] += c
    audio_io.write_wav(d / "rec0.wav", wave.astype(np.float32), SR)
    (d / "sub").mkdir()
    other = rng.standard_normal(int(3.5 * SR)) * 0.01
    other[SR : 2 * SR] += 2 * synth.synthetic_cough(8, 1.0)
    audio_io.write_wav(d / "sub" / "rec1.wav", np.clip(other, -1, 1).astype(np.float32), SR)
    return d


@pytest.mark.parametrize("mode", ["energy", "uniform", "energy_scored"])
def test_extract_segments_matches_the_jax_cli(long_recordings, pt_model, tmp_path, capsys, mode):  # noqa: F811
    args = ["--input-dir", str(long_recordings), "--mode", mode.split("_")[0]]
    if mode == "energy_scored":
        # A bound between the candidates' scores, so that some are dropped.
        waves = [audio_io.load_mono_16k(f) for f in sorted(long_recordings.rglob("*.wav"))]
        cuts = np.stack([extract_segments._cut(w, (lo + hi) // 2, SR)
                         for w in waves for lo, hi in extract_segments.find_energy_bursts(w, SR)])
        probs = np.sort(extract_segments._make_scorer(pt_model, "cpu")(cuts))
        args += ["--model", pt_model, "--min-confidence", str(float(probs[:2].mean()))]
    extract_segments.main(args + ["--output-dir", str(tmp_path / "ours"), "--device", "cpu"])
    ours = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    jextract.main(args + ["--output-dir", str(tmp_path / "theirs")])
    theirs = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    del ours["output"], theirs["output"]
    assert ours == theirs
    assert _files(tmp_path / "ours") == _files(tmp_path / "theirs")
    if mode == "uniform":
        assert ours["written"] == 8 + 3
    elif mode == "energy":
        assert ours["written"] == ours["candidates"] >= 3
    else:
        assert ours["scored"] and ours["written"] < ours["candidates"]


def test_energy_bursts_and_cut_match_the_jax_ones(long_recordings):
    wave = audio_io.load_mono_16k(long_recordings / "rec0.wav")
    spans = extract_segments.find_energy_bursts(wave, SR)
    assert spans == jextract.find_energy_bursts(wave, SR) and len(spans) == 2
    for lo, hi in spans + [(0, 10), (len(wave) - 10, len(wave))]:
        np.testing.assert_array_equal(
            extract_segments._cut(wave, (lo + hi) // 2, SR), jextract._cut(wave, (lo + hi) // 2, SR)
        )


def test_extract_segments_bounds_need_a_model(long_recordings, tmp_path):
    with pytest.raises(SystemExit, match="require --model"):
        extract_segments.main([
            "--input-dir", str(long_recordings), "--output-dir", str(tmp_path), "--min-confidence", "0.5",
        ])


def test_setup_coughvid_matches_the_jax_cli(tmp_path, capsys):
    """A local COUGHVID tree (metadata_compiled.csv and WAVs, a third at
    48 kHz, two rows with no file): both CLIs select, convert and write the
    same clips of both classes, and neither downloads anything."""
    src = tmp_path / "coughvid" / "public_dataset"
    src.mkdir(parents=True)
    rng = np.random.default_rng(2)
    rows = []
    for i in range(14):
        uuid = f"{i:04x}-cv"
        rate = 48000 if i % 3 == 0 else SR
        if i < 12:
            audio_io.write_wav(src / f"{uuid}.wav", synth.synthetic_cough(500 + i, 0.5, rate), rate)
        rows.append({"uuid": uuid, "cough_detected": float(rng.uniform(0, 1)),
                     "status": ["healthy", "COVID-19", "symptomatic"][i % 3]})
    pd.DataFrame(rows).to_csv(src / "metadata_compiled.csv", index=False)
    for name, cli in (("ours", setup_coughvid), ("theirs", jsetup)):
        cli.main(["--output-dir", str(tmp_path / name), "--download-dir", str(tmp_path / "dl"),
                  "--coughvid-dir", str(src), "--no-esc50", "--max-coughs", "5"])
    out = capsys.readouterr().out
    assert "Downloading" not in out
    ours, theirs = _files(tmp_path / "ours"), _files(tmp_path / "theirs")
    assert len(ours) >= 4 and ours == theirs
    assert {p.parts[0] for p in ours} == {"cough", "non_cough"}


def test_preprocessor_facade_matches_the_jax_facade(tmp_path):
    """The reference constructor's defaults (every flag, spectral contrast
    included) on a 44.1 kHz stereo file and on a realtime stream."""
    wave = np.stack([synth.synthetic_cough(11, 1.3, 44100), synth.synthetic_cough(12, 1.3, 44100)])
    path = tmp_path / "stereo.wav"
    audio_io.write_wav(path, wave, 44100)
    ours = preprocessing.create_preprocessor(device="cpu")
    theirs = jpreprocessing.create_preprocessor()
    got, want = ours.process_file(str(path)), theirs.process_file(str(path))
    assert got.shape == want.shape == (1, 110, 101)
    assert ours.get_num_features() == 110 and ours.n_mels == 64
    assert _rel(got, want) < 1e-3
    mono = synth.synthetic_cough(13, 1.0)[None]
    for stage in ("extract_mel_spectrogram", "extract_mfcc", "normalize", "apply_pre_emphasis"):
        assert _rel(getattr(ours, stage)(mono), getattr(theirs, stage)(mono)) < 1e-3, stage
    feats = ours.extract_mfcc(mono)
    assert _rel(ours.compute_deltas(feats), theirs.compute_deltas(feats)) < 1e-3

    rt_ours = preprocessing.create_preprocessor(realtime=True, device="cpu", use_pcen=False)
    rt_theirs = jpreprocessing.create_preprocessor(realtime=True, use_pcen=False)
    stream = synth.synthetic_cough(14, 2.2)
    outs = [(rt_ours.add_audio(stream[i : i + 4000]), rt_theirs.add_audio(stream[i : i + 4000]))
            for i in range(0, len(stream), 4000)]
    pairs = [(a, b) for o, t in outs for a, b in zip(o, t)]
    assert len(pairs) == sum(len(t) for _, t in outs) == 3
    for a, b in pairs:
        assert a.shape == (1, 110, 101) and _rel(a, b) < 1e-3


def test_augmentation_facade_keeps_the_reference_semantics(tmp_path):
    """Random draws differ between the packages; what holds is the shape,
    p = 0 as the identity, the explicit generator's repeatability, the
    no-op speed perturbation, and MixUp's λ (numpy in both) exactly."""
    w = np.stack([synth.synthetic_cough(20 + i, 1.0) for i in range(4)])
    off = augmentation.AudioAugmentor(p_augment=0.0, device="cpu")
    for op in ("time_shift", "add_gaussian_noise", "volume_perturbation", "pitch_shift", "augment"):
        np.testing.assert_array_equal(getattr(off, op)(w), w)
    on_a = augmentation.AudioAugmentor(p_augment=1.0, seed=3, device="cpu")
    on_b = augmentation.AudioAugmentor(p_augment=1.0, seed=3, device="cpu")
    a, b = on_a.augment(w), on_b.augment(w)
    assert a.shape == w.shape and np.array_equal(a, b) and not np.array_equal(a, w)
    assert not np.array_equal(on_a.augment(w), a)  # the generator advances
    np.testing.assert_array_equal(on_a.speed_perturbation(w), w)

    noise_dir = tmp_path / "noise"
    noise_dir.mkdir()
    audio_io.write_wav(noise_dir / "hum.wav", (0.1 * np.sin(np.arange(SR // 2) * 0.05)).astype(np.float32), SR)
    aug, spec = augmentation.create_augmentation_pipeline(noise_dir=str(noise_dir), p_augment=1.0, device="cpu")
    noisy = aug.add_noise(w)
    assert aug._noise_bank.shape == (1, SR) and not np.array_equal(noisy, w)

    feats = np.ones((2, 1, 97, 101), np.float32)
    masked = spec(feats)
    assert masked.shape == feats.shape and (masked == 0).any() and spec(feats[0]).shape == (1, 97, 101)

    x1, x2, y1, y2 = w[0], w[1], np.array([1.0, 0.0]), np.array([0.0, 1.0])
    for got, want in zip(augmentation.MixUp(seed=4)(x1, y1, x2, y2), jaugmentation.MixUp(seed=4)(x1, y1, x2, y2)):
        np.testing.assert_array_equal(got, want)
