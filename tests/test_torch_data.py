"""PyTorch port's decode path against the JAX package, on the CPU.

The same seeded numpy inputs through both packages: the resampler's
polyphase banks (bit-equal) and its output (≤1e-5 max-abs, equal lengths),
WAV I/O (bytes and decoded samples bit-equal; crafted and truncated files
raise the same exception types), the datasets' sample lists and the seeded
stratified split (identical), `BatchLoader` batches with crop shifts over
two epochs (bit-equal), `write_shards` (manifest and arrays byte-equal,
each package's ShardLoader reading the other's shards), and acquisition
(synthetic WAVs byte-equal, ESC-50 reorganization and the COUGHVID
selection identical).
"""

import json
import math
import struct
import threading
import time

import numpy as np
import pandas as pd
import pytest
import torch

from cough_detector_tpu.data import acquire as jacquire
from cough_detector_tpu.data import audio_io as jaudio
from cough_detector_tpu.data import datasets as jdatasets
from cough_detector_tpu.data import native_loader as jnative
from cough_detector_tpu.data import shards as jshards
from cough_detector_tpu.ops import resample as jresample
from cough_detector_tpu_torch.config import FeatureConfig
from cough_detector_tpu_torch.data import acquire, audio_io, datasets, shards, synth
from cough_detector_tpu_torch.ops import resample
from test_torch_models import one_torch_thread  # noqa: F401

# (orig, new) rates: the loader's sources, speed factor 1.1 (16000 /
# 1.1 → 14545 Hz) and pitch ±12 semitones (8 and 32 kHz virtual rates).
RATE_PAIRS = [
    (8000, 16000), (22050, 16000), (44100, 16000), (48000, 16000),
    (16000, 14545), (16000, 8000), (16000, 32000),
]


@pytest.mark.parametrize("orig_sr,new_sr", RATE_PAIRS)
def test_resample_matches_jax(orig_sr, new_sr):
    g = math.gcd(orig_sr, new_sr)
    (bank, width), (jbank, jwidth) = (
        mod._sinc_kernel(orig_sr // g, new_sr // g) for mod in (resample, jresample)
    )
    assert width == jwidth and bank.dtype == jbank.dtype and np.array_equal(bank, jbank)
    x = (np.random.default_rng(orig_sr + new_sr).standard_normal((3, 7919)) * 0.3).astype(np.float32)
    got = resample.resample(torch.from_numpy(x), orig_sr, new_sr).numpy()
    want = np.asarray(jresample.resample(x, orig_sr, new_sr))
    assert got.shape == want.shape == (3, -(-7919 * new_sr // orig_sr))
    assert np.abs(got - want).max() <= 1e-5
    assert resample.make_resample_fn(orig_sr, new_sr) is resample.make_resample_fn(orig_sr, new_sr)


# -- audio_io ------------------------------------------------------------------


@pytest.mark.parametrize("channels,rate", [(1, 16000), (2, 44100)])
def test_write_wav_bytes_and_read_wav_match_jax(tmp_path, channels, rate):
    wave = np.random.default_rng(channels).uniform(-1.1, 1.1, (channels, 3001)).astype(np.float32)
    ours, theirs = tmp_path / "ours.wav", tmp_path / "theirs.wav"
    audio_io.write_wav(ours, wave, rate)
    jaudio.write_wav(theirs, wave, rate)
    assert ours.read_bytes() == theirs.read_bytes()
    (got, sr), (want, jsr) = audio_io.read_wav(ours), jaudio.read_wav(ours)
    assert sr == jsr == rate and got.dtype == want.dtype and np.array_equal(got, want)


def _wav_bytes(fmt_code: int, bits: int, channels: int, payload: bytes, rate: int = 16000,
               extensible: bool = False, extra_chunk: bool = False) -> bytes:
    block = channels * bits // 8
    fmt = struct.pack("<HHIIHH", 0xFFFE if extensible else fmt_code, channels, rate, rate * block, block, bits)
    if extensible:
        fmt += struct.pack("<HHI", 22, bits, 0) + struct.pack("<H", fmt_code) + b"\x00" * 14
    body = b"fmt " + struct.pack("<I", len(fmt)) + fmt
    if extra_chunk:
        body += b"LIST" + struct.pack("<I", 5) + b"abcde\x00"  # odd size, padded
    body += b"data" + struct.pack("<I", len(payload)) + payload
    return b"RIFF" + struct.pack("<I", 4 + len(body)) + b"WAVE" + body


def _pcm24(x: np.ndarray) -> bytes:
    v = np.round(x * 8388607).astype(np.int32)
    return np.stack([v & 0xFF, (v >> 8) & 0xFF, (v >> 16) & 0xFF], axis=-1).astype(np.uint8).tobytes()


def test_read_wav_formats_match_jax(tmp_path):
    x = np.random.default_rng(2).uniform(-0.99, 0.99, 600).astype(np.float64)
    files = {
        "u8": _wav_bytes(1, 8, 1, np.round(x * 127 + 128).astype(np.uint8).tobytes()),
        "s16_stereo": _wav_bytes(1, 16, 2, np.round(x * 32767).astype("<i2").tobytes()),
        "s24": _wav_bytes(1, 24, 1, _pcm24(x), extra_chunk=True),
        "s32": _wav_bytes(1, 32, 1, np.round(x * 2**31 * 0.99).astype("<i4").tobytes()),
        "f32_ext": _wav_bytes(3, 32, 1, x.astype("<f4").tobytes(), extensible=True),
        "f64": _wav_bytes(3, 64, 2, x.astype("<f8").tobytes(), rate=22050),
    }
    for name, blob in files.items():
        p = tmp_path / f"{name}.wav"
        p.write_bytes(blob)
        (got, sr), (want, jsr) = audio_io.read_wav(p), jaudio.read_wav(p)
        assert sr == jsr and got.dtype == np.float32 and np.array_equal(got, want), name


def _crafted(tmp_path):
    """Files both decoders must refuse: (name, bytes, message pattern)."""
    good = _wav_bytes(1, 16, 1, np.zeros(400, "<i2").tobytes())
    fmt_only = b"RIFF" + struct.pack("<I", 28) + b"WAVE" + b"fmt " + struct.pack("<I", 16) + good[20:36]
    return [
        ("not_riff", b"garbage data here", "RIFF"),
        ("truncated_data", good[:-100], "[Tt]runcated"),
        ("no_data_chunk", fmt_only, "Missing"),
        ("short_fmt", b"RIFF" + struct.pack("<I", 22) + b"WAVE" + b"fmt " + struct.pack("<I", 2) + b"\x01\x00"
         + b"data" + struct.pack("<I", 2) + b"\x00\x00", "fmt"),
        ("zero_channels", _wav_bytes(1, 16, 1, b"\x00\x00").replace(struct.pack("<HH", 1, 1), struct.pack("<HH", 1, 0), 1), "channels"),
        ("pcm12", _wav_bytes(1, 12, 1, b"\x00\x00\x00"), "PCM depth"),
        ("float16", _wav_bytes(3, 16, 1, b"\x00\x00"), "float depth"),
        ("adpcm", _wav_bytes(2, 16, 1, b"\x00\x00"), "format"),
    ]


def test_crafted_and_truncated_wavs_raise_like_jax(tmp_path):
    for name, blob, pattern in _crafted(tmp_path):
        p = tmp_path / f"{name}.wav"
        p.write_bytes(blob)
        with pytest.raises(audio_io.AudioDecodeError, match=pattern):
            audio_io.read_wav(p)
        with pytest.raises(jaudio.AudioDecodeError, match=pattern):
            jaudio.read_wav(p)
    # A real clip cut anywhere: the same outcome from both decoders.
    p = tmp_path / "real.wav"
    audio_io.write_wav(p, synth.synthetic_cough(0, 0.5), 16000)
    raw = p.read_bytes()
    for cut in (10, 40, 44, 100, len(raw) - 7):
        q = tmp_path / f"cut{cut}.wav"
        q.write_bytes(raw[:cut])
        outcomes = []
        for mod in (audio_io, jaudio):
            try:
                outcomes.append(mod.read_wav(q)[0])
            except mod.AudioDecodeError as e:
                outcomes.append(type(e).__name__)
        assert type(outcomes[0]) is type(outcomes[1])
        if isinstance(outcomes[0], np.ndarray):
            assert np.array_equal(*outcomes)


def test_compressed_without_ffmpeg_fails_loudly(tmp_path, monkeypatch):
    p = tmp_path / "x.webm"
    p.write_bytes(b"\x1a\x45\xdf\xa3")
    monkeypatch.setattr(audio_io.shutil, "which", lambda name: None)
    assert not audio_io.ffmpeg_available()
    with pytest.raises(audio_io.AudioDecodeError, match="ffmpeg"):
        audio_io.load_mono_16k(p)


def test_resample_np_and_load_mono_16k_match_jax(tmp_path):
    rng = np.random.default_rng(3)
    for rate, channels in ((44100, 2), (8000, 1), (16000, 1)):
        p = tmp_path / f"{rate}.wav"
        audio_io.write_wav(p, rng.uniform(-0.8, 0.8, (channels, rate // 3)).astype(np.float32), rate)
        got, want = audio_io.load_mono_16k(p), jaudio.load_mono_16k(p)
        assert got.dtype == want.dtype and np.array_equal(got, want)
        w = rng.standard_normal((2, 999)).astype(np.float32)
        assert np.array_equal(audio_io.resample_np(w, rate, 16000), jaudio.resample_np(w, rate, 16000))


# -- datasets --------------------------------------------------------------------


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    """7 coughs and 13 non-coughs of 0.6-1.4 s; a quarter at 44.1 or
    8 kHz (the loader resamples them), one stereo, one text file."""
    root = tmp_path_factory.mktemp("clips")
    rng = np.random.default_rng(4)
    for label, n, gen in (("cough", 7, synth.synthetic_cough), ("non_cough", 13, synth.synthetic_non_cough)):
        (root / label).mkdir()
        for i in range(n):
            rate = (44100, 8000)[i % 2] if i % 4 == 3 else 16000
            wave = gen(seed=100 * len(label) + i, duration_s=float(rng.uniform(0.6, 1.4)), sample_rate=rate)
            if i == 5:
                wave = np.stack([wave, 0.5 * wave])
            audio_io.write_wav(root / label / f"{label}_{i:02d}.wav", wave, rate)
    (root / "cough" / "notes.txt").write_text("ignored")
    return root


def _esc50(root):
    (root / "audio").mkdir(parents=True)
    (root / "meta").mkdir()
    rows = []
    specs = [(24, 1), (24, 2), (22, 3), (38, 4), (0, 5), (10, 1), (24, 5), (36, 2)]
    for i, (target, fold) in enumerate(specs):
        name = f"{fold}-{i}-A-{target}.wav"
        if i != 7:  # a row whose audio is missing is skipped
            audio_io.write_wav(root / "audio" / name, synth.synthetic_non_cough(i, 0.3), 16000)
        rows.append({"filename": name, "fold": fold, "target": target, "category": f"c{target}"})
    pd.DataFrame(rows).to_csv(root / "meta" / "esc50.csv", index=False)
    return root


def test_dataset_sample_lists_match_jax(data_dir, tmp_path):
    ours, theirs = datasets.CoughDataset(str(data_dir)), jdatasets.CoughDataset(str(data_dir))
    assert ours.samples == theirs.samples and len(ours) == 20
    assert ours.class_counts == theirs.class_counts
    assert np.array_equal(ours.sample_weights, theirs.sample_weights)
    for split in (0.2, 0.35):
        for a, b in zip(datasets.prepare_dataset_split(str(data_dir), split),
                        jdatasets.prepare_dataset_split(str(data_dir), split)):
            assert a.samples == b.samples and a.data_dir == b.data_dir
    esc = _esc50(tmp_path / "esc50")
    for kw in (dict(), dict(include_all_negatives=False), dict(fold=5), dict(is_training=False, fold=5),
               dict(is_training=False, fold=2, include_all_negatives=False)):
        assert datasets.ESC50Dataset(str(esc), **kw).samples == jdatasets.ESC50Dataset(str(esc), **kw).samples, kw
    combined = datasets.CombinedDataset([ours, datasets.ESC50Dataset(str(esc))])
    jcombined = jdatasets.CombinedDataset([theirs, jdatasets.ESC50Dataset(str(esc))])
    assert combined.samples == jcombined.samples
    assert np.array_equal(combined.sample_weights, jcombined.sample_weights)
    with pytest.raises(FileNotFoundError):
        datasets.ESC50Dataset(str(tmp_path))


@pytest.mark.parametrize("labels", [
    [0] * 7 + [1] * 5, [0, 1] * 20 + [1] * 3, [1] * 11 + [0] * 30 + [2] * 4, [0] * 3 + [1] * 2, [0] * 9 + [1],
])
def test_stratified_split_is_sklearns(labels):
    from sklearn.model_selection import train_test_split

    for test_size, seed in ((0.2, 42), (0.3, 7)):
        try:
            tr, te = train_test_split(
                list(range(len(labels))), test_size=test_size, random_state=seed, stratify=labels
            )
        except ValueError:  # too few rows for a class in one side: both refuse
            with pytest.raises(ValueError):
                datasets.stratified_split(labels, test_size, seed)
            continue
        got_tr, got_te = datasets.stratified_split(labels, test_size, seed)
        assert list(got_tr) == list(tr) and list(got_te) == list(te)


@pytest.mark.parametrize("mode", [
    dict(weighted=True, drop_last=True, time_shift_limit=0.2, time_shift_prob=0.6),
    dict(shuffle=True, time_shift_limit=0.3, time_shift_prob=1.0),
    dict(),
])
def test_batch_loader_batches_match_jax(data_dir, mode):
    ds, jds = datasets.CoughDataset(str(data_dir)), jdatasets.CoughDataset(str(data_dir))
    ours = datasets.BatchLoader(ds, 6, FeatureConfig(), num_workers=3, seed=3, backend="python", **mode)
    theirs = jdatasets.BatchLoader(jds, 6, num_workers=3, seed=3, backend="python", **mode)
    assert len(ours) == len(theirs)
    for epoch in (0, 1):
        ours.set_epoch(epoch)
        theirs.set_epoch(epoch)
        got, want = list(ours), list(theirs)
        assert len(got) == len(want) == len(ours)
        for (wa, la), (wb, lb) in zip(got, want):
            assert wa.dtype == wb.dtype == np.float32 and wa.shape[1] == 16000
            assert np.array_equal(wa, wb) and np.array_equal(la, lb)


def test_batch_loader_backends(data_dir):
    """"native" and "auto" decode as the JAX package's loader of the same
    backend does, bit for bit (the same C++ source and flags, or both the
    Python decoder where g++ is missing); "native" is within 2e-5 of
    "python" (tests/test_native_loader.py)."""
    ds, jds = datasets.CoughDataset(str(data_dir)), jdatasets.CoughDataset(str(data_dir))
    with pytest.raises(ValueError):
        datasets.BatchLoader(ds, 4, backend="rust")
    python = datasets.BatchLoader(ds, 8, backend="python", num_workers=2)
    for backend in ("auto", "native"):
        if backend == "native" and not jnative.available():
            with pytest.raises(RuntimeError, match="native loader unavailable"):
                datasets.BatchLoader(ds, 8, backend="native")
            continue
        ours = datasets.BatchLoader(ds, 8, backend=backend, num_workers=2)
        theirs = jdatasets.BatchLoader(jds, 8, backend=backend, num_workers=2)
        assert ours._native == theirs._native == jnative.available()
        for (wa, la), (wb, lb), (wp, _) in zip(ours, theirs, python):
            assert np.array_equal(wa, wb) and np.array_equal(la, lb)
            assert np.abs(wa - wp).max() <= 2e-5


def test_abandoned_loader_leaves_no_thread(data_dir, tmp_path):
    ds = datasets.CoughDataset(str(data_dir))
    before = threading.active_count()
    loader = datasets.BatchLoader(ds, 2, num_workers=3, prefetch=1)
    it = iter(loader)
    next(it)
    it.close()
    _threads_back_to(before)
    bad = tmp_path / "bad.wav"
    bad.write_bytes(b"RIFF....WAVE")
    with pytest.raises(audio_io.AudioDecodeError):
        list(datasets.BatchLoader(datasets.ClipDataset([(str(bad), 1)]), 1))
    _threads_back_to(before)


def _threads_back_to(n: int, timeout: float = 10.0) -> None:
    deadline = time.monotonic() + timeout
    while threading.active_count() != n and time.monotonic() < deadline:
        time.sleep(0.01)
    assert threading.active_count() == n


def test_crop_window_matches_jax():
    rng = np.random.default_rng(5)
    for n in (900, 1000, 1001, 1600, 2501):
        wave = rng.standard_normal(n).astype(np.float32)
        for shift in (-700, -1, 0, 3, 450, 1200):
            assert np.array_equal(datasets._crop_window(wave, 1000, shift),
                                  jdatasets._crop_window(wave, 1000, shift)), (n, shift)


# -- write_shards ----------------------------------------------------------------


def test_write_shards_match_jax_and_read_both_ways(data_dir, tmp_path):
    ds, jds = datasets.CoughDataset(str(data_dir)), jdatasets.CoughDataset(str(data_dir))
    ours, theirs = tmp_path / "ours", tmp_path / "theirs"
    manifest = shards.write_shards(ds, str(ours), shard_size=8, num_workers=2, backend="python")
    jmanifest = jshards.write_shards(jds, str(theirs), shard_size=8, num_workers=2, backend="python")
    assert manifest == jmanifest and len(manifest["shards"]) == 3
    names = sorted(p.name for p in ours.iterdir())
    assert names == sorted(p.name for p in theirs.iterdir())
    for name in names:
        assert (ours / name).read_bytes() == (theirs / name).read_bytes(), name
    # Each package's reader on the other's shards.
    got = shards.ShardLoader(str(theirs), 8, weighted=True, seed=1, feature_config=FeatureConfig())
    want = jshards.ShardLoader(str(ours), 8, weighted=True, seed=1)
    assert got.class_counts == want.class_counts == {0: 13, 1: 7}
    for (wa, la), (wb, lb) in zip(got, want):
        assert wa.dtype == np.int16 and np.array_equal(wa, wb) and np.array_equal(la, lb)
    assert json.loads((ours / "manifest.json").read_text())["n_clips"] == 20


# -- acquisition -------------------------------------------------------------------


def test_synthetic_dataset_bytes_match_jax(tmp_path):
    kw = dict(n_coughs=3, n_non_coughs=5, seed=9, hard_negative_frac=0.4,
              hard_negative_weights={"laugh": 0.7, "speech": 0.3})
    assert acquire.generate_synthetic_dataset(str(tmp_path / "ours"), **kw) == \
        jacquire.generate_synthetic_dataset(str(tmp_path / "theirs"), **kw)
    files = sorted(p.relative_to(tmp_path / "ours") for p in (tmp_path / "ours").rglob("*.wav"))
    assert len(files) == 8
    for f in files:
        assert (tmp_path / "ours" / f).read_bytes() == (tmp_path / "theirs" / f).read_bytes(), f
    assert acquire.dataset_summary(str(tmp_path / "ours")) == jacquire.dataset_summary(str(tmp_path / "theirs"))
    with pytest.raises(ValueError):
        acquire.generate_synthetic_dataset(str(tmp_path / "x"), hard_negative_frac=30)


def test_reorganize_esc50_matches_jax(tmp_path):
    esc = _esc50(tmp_path / "esc50")
    for negatives in (None, acquire.PREPARE_DATA_NEGATIVES):
        got = acquire.reorganize_esc50(str(esc), str(tmp_path / "ours"), negatives=negatives)
        want = jacquire.reorganize_esc50(str(esc), str(tmp_path / "theirs"), negatives=negatives)
        assert got == want
        assert acquire.dataset_summary(str(tmp_path / "ours")) == jacquire.dataset_summary(str(tmp_path / "theirs"))
    assert sorted(p.name for p in (tmp_path / "ours").rglob("*.wav")) == sorted(
        p.name for p in (tmp_path / "theirs").rglob("*.wav")
    )


@pytest.mark.parametrize("n_rows,fallback", [(700, False), (60, True)])
def test_select_coughvid_matches_jax(n_rows, fallback):
    rng = np.random.default_rng(n_rows)
    conf = rng.uniform(0, 1, n_rows)
    conf[::17] = np.nan
    meta = pd.DataFrame({
        "uuid": [f"u{i:04d}" for i in range(n_rows)],
        "cough_detected": conf,
        "status": rng.choice(["healthy", "COVID-19", "symptomatic", None, "healthy_x"], n_rows),
    })
    kw = dict(max_coughs=40, seed=3)
    if fallback:
        kw["fallback_uuids"] = [f"f{i}" for i in range(25)]
    for a, b in zip(acquire.select_coughvid(meta, **kw), jacquire.select_coughvid(meta, **kw)):
        pd.testing.assert_frame_equal(a, b)
