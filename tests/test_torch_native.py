"""PyTorch port's native (C++) decode tier against the JAX package, on the CPU.

The port builds its own copy of the loader (`cough_detector_tpu_torch/
native/cdt_loader.cpp`, the same code and g++ flags as the JAX package's
`native/cdt_loader.cpp`) into `build/native/`. Its `load_batch` and
`load_clip` must equal the JAX package's native loader bit for bit, and
both must stay within 2e-5 of the Python decoder (the bound of
tests/test_native_loader.py), with the same quarantine semantics.
"""

import shutil

import numpy as np
import pytest

from cough_detector_tpu.data import datasets as jdatasets
from cough_detector_tpu.data import native_loader as jnative
from cough_detector_tpu_torch.config import FeatureConfig
from cough_detector_tpu_torch.data import audio_io, datasets, native_loader, synth
from cough_detector_tpu_torch.utils import native_build
from test_torch_models import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.skipif(shutil.which("g++") is None, reason="no C++ toolchain")

TOL = 2e-5  # native vs the Python decoder (tests/test_native_loader.py)


@pytest.fixture(scope="module")
def wav_dir(tmp_path_factory):
    """Six clips at 16, 22.05 and 44.1 kHz of 0.5, 1 and 2 s."""
    d = tmp_path_factory.mktemp("wavs")
    (d / "cough").mkdir()
    (d / "non_cough").mkdir()
    paths = []
    for i in range(6):
        sr, dur = [16000, 22050, 44100][i % 3], [0.5, 1.0, 2.0][i % 3]
        cls = "cough" if i % 2 == 0 else "non_cough"
        gen = synth.synthetic_cough if cls == "cough" else synth.synthetic_non_cough
        path = d / cls / f"{i}.wav"
        audio_io.write_wav(path, gen(seed=i, duration_s=dur, sample_rate=sr), sr)
        paths.append(str(path))
    return d, paths


def test_load_clip_equals_jax_and_the_python_decoder(wav_dir):
    for p in wav_dir[1]:
        ours = native_loader.load_clip(p, 16000)
        assert np.array_equal(ours, jnative.load_clip(p, 16000))
        want = audio_io.load_mono_16k(p, 16000)
        assert ours.shape == want.shape and np.abs(ours - want).max() <= TOL


@pytest.mark.parametrize("shifted", [False, True])
def test_load_batch_equals_jax_and_the_python_decoder(wav_dir, shifted):
    paths = wav_dir[1]
    fracs = np.linspace(-0.2, 0.2, len(paths)) if shifted else None
    waves, n_ok, errors = native_loader.load_batch(paths, 16000, 16000, n_threads=3, shift_fracs=fracs)
    jwaves, jn_ok, jerrors = jnative.load_batch(paths, 16000, 16000, n_threads=3, shift_fracs=fracs)
    assert (n_ok, errors) == (jn_ok, jerrors) == (len(paths), "")
    assert np.array_equal(waves, jwaves)
    for i, (row, p) in enumerate(zip(waves, paths)):
        clip = audio_io.load_mono_16k(p, 16000)
        shift = int(round(fracs[i] * clip.shape[0])) if shifted else 0
        assert np.abs(row - datasets._crop_window(clip, 16000, shift)).max() <= TOL


def test_odd_pads_center_as_the_python_decoder(tmp_path):
    """A clip shorter than the segment by an odd count gets floor(pad/2)
    zeros on the left, in both tiers."""
    rng = np.random.default_rng(7)
    paths = []
    for i, n in enumerate([15999, 8001, 15985]):
        p = tmp_path / f"odd{i}.wav"
        audio_io.write_wav(p, rng.standard_normal(n).astype(np.float32) * 0.5, 16000)
        paths.append(str(p))
    waves, n_ok, errors = native_loader.load_batch(paths, 16000, 16000)
    assert n_ok == len(paths) and errors == ""
    for row, p in zip(waves, paths):
        assert np.array_equal(row, datasets._crop_window(audio_io.load_mono_16k(p, 16000), 16000))


@pytest.mark.parametrize("fault", ["truncated", "bad"])
def test_failed_clips_are_quarantined_as_jax_does(tmp_path, fault):
    good = tmp_path / "good.wav"
    audio_io.write_wav(good, synth.synthetic_cough(1, 1.0), 16000)
    broken = tmp_path / f"{fault}.wav"
    if fault == "truncated":
        broken.write_bytes(good.read_bytes()[:-500])
    else:
        broken.write_bytes(b"not audio")
    paths = [str(broken), str(good)]
    waves, n_ok, errors = native_loader.load_batch(paths, 16000, 16000)
    jwaves, jn_ok, jerrors = jnative.load_batch(paths, 16000, 16000)
    assert n_ok == jn_ok == 1 and errors == jerrors and f"{fault}.wav" in errors
    if fault == "truncated":
        assert "truncated" in errors.lower()
    assert np.array_equal(waves, jwaves)
    assert np.all(waves[0] == 0) and not np.all(waves[1] == 0)
    with pytest.raises(audio_io.AudioDecodeError):
        native_loader.load_clip(str(broken))


@pytest.mark.parametrize("mode", [
    dict(weighted=True, drop_last=True, time_shift_limit=0.2, time_shift_prob=1.0, seed=9),
    dict(),
])
def test_batch_loader_native_equals_jax_native(wav_dir, mode):
    d = str(wav_dir[0])
    ours = datasets.BatchLoader(datasets.CoughDataset(d), 3, FeatureConfig(), backend="native", **mode)
    theirs = jdatasets.BatchLoader(jdatasets.CoughDataset(d), 3, backend="native", **mode)
    python = datasets.BatchLoader(datasets.CoughDataset(d), 3, FeatureConfig(), backend="python", **mode)
    assert ours._native and theirs._native
    for epoch in (0, 1):
        for loader in (ours, theirs, python):
            loader.set_epoch(epoch)
        for (wa, la), (wb, lb), (wp, lp) in zip(ours, theirs, python):
            assert np.array_equal(wa, wb) and np.array_equal(la, lb) and np.array_equal(la, lp)
            assert np.abs(wa - wp).max() <= TOL


def test_auto_picks_native_on_wavs_and_native_raises_on_decode_error(wav_dir, tmp_path):
    ds = datasets.CoughDataset(str(wav_dir[0]))
    assert datasets.BatchLoader(ds, 3, backend="auto")._native
    assert not datasets.BatchLoader(ds, 3, backend="python")._native
    (tmp_path / "cough").mkdir()
    (tmp_path / "non_cough").mkdir()
    (tmp_path / "cough" / "bad.wav").write_bytes(b"garbage")
    loader = datasets.BatchLoader(datasets.CoughDataset(str(tmp_path)), 1, backend="native")
    with pytest.raises(audio_io.AudioDecodeError, match="bad.wav"):
        list(loader)
    flac = datasets.ClipDataset([(str(tmp_path / "a.flac"), 1)])
    assert not datasets.BatchLoader(flac, 1, backend="auto")._native
    with pytest.raises(RuntimeError, match=".wav"):
        datasets.BatchLoader(flac, 1, backend="native")


def test_without_gxx_auto_decodes_in_python_and_native_raises(wav_dir, tmp_path, monkeypatch, capsys):
    """No g++: "auto" says so once and decodes in Python; "native" raises
    with the reason."""
    monkeypatch.setattr(native_loader, "_lib", None)
    monkeypatch.setattr(native_loader, "_error", None)
    monkeypatch.setattr(native_build, "BUILD_DIR", tmp_path / "native")
    monkeypatch.setattr(native_build.shutil, "which", lambda name: None)
    ds = datasets.CoughDataset(str(wav_dir[0]))
    assert not datasets.BatchLoader(ds, 3, backend="auto")._native
    assert not datasets.BatchLoader(ds, 3, backend="auto")._native
    assert capsys.readouterr().out.count("native loader unavailable") == 1
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        datasets.BatchLoader(ds, 3, backend="native")


def test_an_edited_source_gets_a_new_library(tmp_path, monkeypatch):
    src = tmp_path / "src"
    src.mkdir()
    original = native_build._SRC / "cdt_loader.cpp"
    (src / "cdt_loader.cpp").write_bytes(original.read_bytes())
    monkeypatch.setattr(native_build, "_SRC", src)
    same = native_build.library_path("cdt_loader")
    assert same.parent == native_build.BUILD_DIR and same.name.startswith("libcdt_loader-")
    (src / "cdt_loader.cpp").write_bytes(original.read_bytes() + b"\n// edited\n")
    edited = native_build.library_path("cdt_loader")
    assert edited != same and edited.name.startswith("libcdt_loader-")
    monkeypatch.setattr(native_build, "GXX_FLAGS", native_build.GXX_FLAGS + ["-g"])
    assert native_build.library_path("cdt_loader") not in (same, edited)


def test_a_failed_build_raises_with_the_compilers_output(tmp_path, monkeypatch):
    src = tmp_path / "src"
    src.mkdir()
    (src / "broken.cpp").write_text("this is not C++\n")
    monkeypatch.setattr(native_build, "_SRC", src)
    monkeypatch.setattr(native_build, "BUILD_DIR", tmp_path / "out")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed on native/broken.cpp"):
        native_build.build("broken")
    assert not list((tmp_path / "out").iterdir())  # no half-written library left
