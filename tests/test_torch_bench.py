"""The port's bench (`cough_detector_tpu_torch/cli/bench.py`) on the CPU, at
small sizes, against the JAX package.

The headline's program (features → logits, one captured program on the
card, its plain version here) is held within 1e-3 max-relative of the JAX
package's `__graft_entry__.entry()` forward on the same fixture batch and
converted weights; the serving bench's tick loop fires exactly where the
JAX `StreamingDetector._step` fires, tick by tick, fed the same chunks; the
daemon bench runs the socket tier with the Python client children (which
must import neither JAX nor the JAX package) and with the port's C++ load
generator (built under build/native/). Each record carries the JAX bench's
keys plus "device". The command line refuses unknown values and, without
`--device cpu`, a machine with no card. The spectral launch's folded grid
index, which lets a card batch pass 65,535 clips, is checked in Python.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import __graft_entry__
from cough_detector_tpu.config import default_config as jax_default_config
from cough_detector_tpu.models import create_model as jax_create_model
from cough_detector_tpu.models import init_model as jax_init_model
from cough_detector_tpu.ops import frontend as jax_frontend
from cough_detector_tpu.stream.detector import StreamingDetector as JaxDetector
from cough_detector_tpu_torch.cli import bench
from cough_detector_tpu_torch.config import default_config
from cough_detector_tpu_torch.models import from_jax_variables
from cough_detector_tpu_torch.ops import frontend_kernel
from cough_detector_tpu_torch.stream import StreamingDetector
from cough_detector_tpu_torch.utils import native_build
from test_torch_models import one_torch_thread  # noqa: F401

TOL = 1e-3
CHUNK = 1600
N_STREAMS = 8
_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_HEADLINE_KEYS = {"metric", "value", "unit", "vs_baseline", "device"}
_SERVING_KEYS = {
    "metric", "num_streams", "precision", "n_ticks_timed", "sustained_tick_ms", "sync_tick_p50_ms",
    "realtime_at_this_count", "derived_stream_capacity_per_chip", "vs_baseline_256_streams", "device",
}
_DAEMON_KEYS = {
    "metric", "backend", "loadgen", "h2d_dtype", "num_streams", "n_clients", "uplink_frame_s", "seconds",
    "ticks", "tick_budget_ms", "tick_ms_p50", "tick_ms_p99", "delivery_lag_ms_p50", "delivery_lag_ms_p99",
    "cadence", "events_delivered", "events_dropped", "dropped_samples", "max_client_late_s", "rss_kb_start",
    "rss_kb_end", "realtime_at_this_count", "device",
}


def _max_rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.fixture(scope="module")
def jax_variables():
    """The JAX residual model's variables as `__graft_entry__.entry()` draws
    them (PRNGKey(0))."""
    cfg = jax_default_config("residual")
    return jax_init_model(jax_create_model("residual"), jax.random.PRNGKey(0), cfg.features.feature_shape)


@pytest.fixture(scope="module")
def headlines(jax_variables):
    """main(batch=8) on the CPU in each mode, the JAX weights converted;
    "high" with the ingest-inclusive record. The TF32 flags go in off."""
    weights = from_jax_variables(jax_variables, "residual")
    flags = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    threads = torch.get_num_threads()
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_num_threads(1)
    try:
        runs = {
            "high": bench.main(batch=8, fresh_h2d=True, device="cpu", state_dict=weights),
            "serve": bench.main(batch=8, mode="serve", device="cpu", state_dict=weights),
            "bf16": bench.main(batch=8, mode="bf16", device="cpu", state_dict=weights),
        }
        runs["tf32_after"] = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = flags
        torch.set_num_threads(threads)
    return runs


# -- the headline ------------------------------------------------------------------


def test_headline_matches_the_jax_entry_forward(headlines, jax_variables):
    """The headline's features and logits on fixture_batch(8, 1.0, seed=0)
    are the JAX package's entry() forward (extract_features_fast, then
    model.apply) within 1e-3 max-relative."""
    fn, (example,) = __graft_entry__.entry()
    want_logits = np.asarray(jax.jit(fn)(example))
    want_feats = np.asarray(jax_frontend.extract_features_fast(example, jax_default_config("residual").features))
    h = headlines["high"]
    np.testing.assert_array_equal(h.waves.numpy(), np.asarray(example))
    assert h.features.shape == want_feats.shape == (8, 90, 101)
    assert _max_rel(h.features.numpy(), want_feats) < TOL
    assert h.logits.shape == want_logits.shape == (8, 2)
    assert _max_rel(h.logits.numpy(), want_logits) < TOL


@pytest.mark.parametrize("run", ["high", "ingest", "serve", "bf16"])
def test_headline_records(headlines, run, capsys):
    """Each record has the JAX bench's keys plus "device", a positive value
    and vs_baseline from the rounded value; "mode" outside "high"; the
    ingest record its batch and bytes; the TF32 flags off after the modes."""
    if run == "ingest":
        rec = headlines["high"].ingest_record
        assert rec["metric"] == "1s_clips_per_sec_per_chip_ingest_inclusive"
        assert set(rec) == _HEADLINE_KEYS | {"batch", "h2d_bytes_per_iter"}
        assert rec["batch"] == 8 and rec["h2d_bytes_per_iter"] == 8 * 16000 * 2
    else:
        rec = headlines[run].record
        assert rec["metric"] == "1s_clips_per_sec_per_chip_end_to_end"
        assert set(rec) == _HEADLINE_KEYS | ({"mode"} if run != "high" else set())
        assert rec.get("mode", "high") == run
        assert headlines[run].launches == {"spectral": 0, "epilogue": 0}  # plain versions on the CPU
        assert headlines[run].event_ms is None
    assert rec["unit"] == "clips/s/chip" and rec["device"] == "cpu"
    assert rec["value"] > 0 and rec["vs_baseline"] == round(rec["value"] / 10_000.0, 3)
    assert headlines["tf32_after"] == (False, False)


def test_headline_modes_agree_and_trace(headlines, tmp_path, capsys):
    """"serve" equals "high" on the CPU (TF32 applies only on the card);
    bf16 with folded batch norm is within 1e-2 of it, the bound the serving
    precision modes are held to; --trace writes a trace after the
    measurement and names it in the record."""
    high = headlines["high"].logits.float().numpy()
    assert _max_rel(headlines["serve"].logits.numpy(), high) < 1e-6
    assert _max_rel(headlines["bf16"].logits.float().numpy(), high) < 1e-2
    capsys.readouterr()
    h = bench.main(batch=4, n_iters=2, trace=str(tmp_path / "trace"), device="cpu")
    assert h.record["trace"] == str(tmp_path / "trace")
    assert any((tmp_path / "trace").iterdir())
    lines = [json.loads(line) for line in capsys.readouterr().out.splitlines() if line.startswith("{")]
    assert lines == [h.record]


def test_headline_rejects_unknown_mode():
    with pytest.raises(ValueError, match="mode"):
        bench.main(batch=4, mode="fp8", device="cpu")


# -- the serving bench ------------------------------------------------------------------


@pytest.fixture(scope="module")
def serving_weights(jax_variables):
    """The JAX variables with the last dense layer rescaled so the logit
    difference over the bench audio's windows has mean -1 and std 3 (random
    weights put every probability within a few hundredths of each other,
    so nothing would fire at the bench's 0.7)."""
    variables = jax.tree_util.tree_map(np.asarray, jax_variables)
    audio = bench.serving_audio(N_STREAMS, CHUNK, 16)
    windows = np.concatenate([audio[:, p : p + 16000] for p in range(0, audio.shape[1] - 16000 + 1, 4000)])
    det = StreamingDetector(variables=from_jax_variables(variables, "residual"), device="cpu",
                            config=default_config("residual"), mesh=False)
    p = det.scores_for(windows).astype(np.float64)
    d = np.log(p) - np.log1p(-p)
    scale = 3.0 / d.std()
    fc = variables["params"]["fc"]
    fc["kernel"] = (fc["kernel"] * scale).astype(np.float32)
    fc["bias"] = (fc["bias"] * scale + np.array([0.0, -scale * d.mean() - 1.0])).astype(np.float32)
    return variables


def test_serving_fires_where_the_jax_tick_fires(serving_weights, capsys):
    """serving_bench(8 streams, 16 ticks) prints its record; every tick's
    fired mask (warm-up, sustained and synchronous ticks, in order) equals
    the JAX StreamingDetector._step's on the same chunks exactly, and the
    smoothed confidences of completed windows are within 1e-3; no smoothed
    value lies within 1e-3 of the threshold, so a rounding difference
    cannot flip a fire."""
    run = bench.serving_bench(num_streams=N_STREAMS, n_ticks=16, device="cpu",
                              state_dict=from_jax_variables(serving_weights, "residual"))
    rec = run.record
    assert set(rec) == _SERVING_KEYS
    assert rec["metric"] == "multi_stream_serving" and rec["num_streams"] == N_STREAMS
    assert rec["n_ticks_timed"] == 15 and rec["device"] == "cpu" and rec["precision"] == "high"
    assert rec["sustained_tick_ms"] > 0 and rec["sync_tick_p50_ms"] > 0
    printed = [json.loads(line) for line in capsys.readouterr().out.splitlines() if line.startswith("{")]
    assert printed == [rec]
    # 13 warm ticks (one a fill of 1600-sample chunks), 15 sustained, 12 synchronous.
    assert len(run.packed) == 13 + 15 + 12 and run.fills[:13] == bench.ring.tick_fills(CHUNK, 16000, 4000)

    cfg = jax_default_config("residual")
    jdet = JaxDetector(variables=serving_weights, config=cfg, num_streams=N_STREAMS, chunk_size=CHUNK,
                       confidence_threshold=0.7, smoothing_window=3, debounce_seconds=0.5)
    audio = bench.serving_audio(N_STREAMS, CHUNK, run.n_unique)
    state, fired_any, smoothed = jdet._state, 0, []
    for t, (c, packed, fired) in enumerate(zip(run.chunk_order, run.packed, run.fired())):
        state, ev = jdet._step(state, jax.numpy.asarray(audio[:, c * CHUNK : (c + 1) * CHUNK]))
        want = np.asarray(ev["fired"])
        np.testing.assert_array_equal(fired, want, err_msg=f"tick {t}")
        valid = np.asarray(ev["valid"])
        got_smoothed = packed[3 : 3 + N_STREAMS].numpy()[:, valid]
        want_smoothed = np.asarray(ev["smoothed"])[:, valid]
        assert np.abs(got_smoothed - want_smoothed).max(initial=0.0) < TOL, t
        smoothed.append(want_smoothed.ravel())
        fired_any += int(want.sum())
    smoothed = np.concatenate(smoothed)
    assert fired_any > 0 and (smoothed < 0.7).any()  # some windows fire, others do not
    assert np.abs(smoothed - 0.7).min() > TOL


# -- the socket tier ------------------------------------------------------------------------


def test_daemon_bench_python_clients_import_neither_jax_nor_the_jax_package(monkeypatch, capfd):
    """daemon_bench with the Python client children on the CPU: the record
    has the JAX bench's keys plus "device" and ticks > 0. The children print
    every module they import (PYTHONPROFILEIMPORTTIME): the bench, and
    neither JAX nor the JAX package."""
    monkeypatch.setenv("PYTHONPROFILEIMPORTTIME", "1")
    rec = bench.daemon_bench(num_streams=N_STREAMS, n_clients=2, seconds=1.5, device="cpu")
    assert set(rec) == _DAEMON_KEYS
    assert rec["metric"] == "serving_daemon_socket_tier" and rec["backend"] == "python"
    assert rec["loadgen"] == "python" and rec["ticks"] > 0 and rec["device"] == "cpu"
    assert rec["num_streams"] == N_STREAMS and rec["n_clients"] == 2 and rec["dropped_samples"] == 0
    err = capfd.readouterr().err
    imported = [line.split("|")[-1].strip() for line in err.splitlines() if line.startswith("import time:")]
    assert "cough_detector_tpu_torch.cli.bench" in imported and "cough_detector_tpu_torch.serve.client" in imported
    banned = [m for m in imported if m.split(".")[0] in ("jax", "cough_detector_tpu")]
    assert not banned, banned


def test_daemon_bench_native_loadgen_and_plane():
    """The port's C++ load generator against the native socket plane."""
    rec = bench.daemon_bench(num_streams=N_STREAMS, n_clients=2, seconds=1.5, backend="native",
                             loadgen="native", h2d_dtype="int16", device="cpu")
    assert set(rec) == _DAEMON_KEYS
    assert (rec["backend"], rec["loadgen"], rec["h2d_dtype"]) == ("native", "native", "int16")
    assert rec["ticks"] > 0 and rec["dropped_samples"] == 0


def test_daemon_bench_rejects_unknown_loadgen():
    with pytest.raises(ValueError, match="loadgen"):
        bench.daemon_bench(num_streams=2, seconds=0.1, loadgen="rust", device="cpu")


def test_loadgen_builds_under_build_native_from_the_ports_source():
    """The load generator is built from the port's own copy of the source
    into build/native/<name>-<hash of source and flags>, never into the
    repo's root native/ (the JAX package's), and runs: without arguments it
    prints its usage and exits 2."""
    path = native_build.build_executable("cdt_loadgen")
    assert path == native_build.executable_path("cdt_loadgen")
    assert path.parent == native_build.BUILD_DIR and path.parent != native_build._SRC
    assert native_build.BUILD_DIR.parent.parent == bench._REPO
    assert os.path.realpath(path.parent) != os.path.realpath(os.path.join(_REPO, "native"))
    assert path.name.startswith("cdt_loadgen-") and os.access(path, os.X_OK)
    assert (native_build._SRC / "cdt_loadgen.cpp").read_text() != open(
        os.path.join(_REPO, "native", "cdt_loadgen.cpp")).read()  # the port's copy, its own comments
    assert native_build.executable_path("cdt_loadgen") != native_build.library_path("cdt_loadgen")
    out = subprocess.run([str(path)], capture_output=True, text=True, timeout=30)
    assert out.returncode == 2 and "usage: cdt_loadgen" in out.stderr


# -- the command line -----------------------------------------------------------------------


@pytest.mark.parametrize("flag", ["--mode", "--precision", "--backend", "--h2d", "--loadgen"])
def test_cli_rejects_unknown_values(flag):
    """An unknown value exits with a message naming the flag, before
    anything runs (a typo must never run the default path)."""
    with pytest.raises(SystemExit) as exc:
        bench.cli(["--device", "cpu", flag, "bogus"])
    assert exc.value.code not in (0, None) and flag in str(exc.value.code)


def test_cli_without_a_card_exits_naming_it(monkeypatch):
    """No --device: the bench asks for the card and, with none, exits
    non-zero instead of running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as exc:
        bench.cli(["--batch", "4"])
    assert "CUDA" in str(exc.value.code) and "--device cpu" in str(exc.value.code)


def test_module_run_without_a_card_exits_non_zero():
    out = subprocess.run(
        [sys.executable, "-m", "cough_detector_tpu_torch.cli.bench", "--batch", "4"], cwd=_REPO,
        capture_output=True, text=True, timeout=120, env=dict(os.environ, CUDA_VISIBLE_DEVICES=""),
    )
    assert out.returncode != 0 and "CUDA" in out.stderr and not out.stdout.strip()


def test_cli_runs_the_headline_on_the_cpu(capsys):
    bench.cli(["--device", "cpu", "--batch", "4", "--mode", "serve"])
    (rec,) = [json.loads(line) for line in capsys.readouterr().out.splitlines() if line.startswith("{")]
    assert rec["metric"] == "1s_clips_per_sec_per_chip_end_to_end" and rec["mode"] == "serve"


# -- the front end past 65,535 clips ------------------------------------------------------


@pytest.mark.parametrize("batch", [65535, 65536, 131071])
@pytest.mark.parametrize("n_frames", [101, 201])
def test_spectral_grid_folds_the_clip_into_grid_x(batch, n_frames):
    """Launch A's grid holds the whole batch on grid x (2^31 - 1 blocks),
    past grid y's 65,535 clips: every (clip, row tile) is one block, the
    last block is the last clip's last tile, and the kernel computes the
    same mapping from blockIdx.x as the Python mirror."""
    tiles = -(-n_frames // 128)
    blocks = frontend_kernel.spectral_grid(batch, n_frames)
    assert blocks == batch * tiles <= 2**31 - 1
    idx = np.arange(blocks)
    clip, t0, grp = frontend_kernel.spectral_block(idx, n_frames)
    assert np.array_equal(np.bincount(clip, minlength=batch), np.full(batch, tiles))
    assert set(np.unique(t0)) == set(range(0, tiles * 128, 128)) and not grp.any()
    assert np.unique(clip * tiles + t0 // 128).size == blocks
    assert frontend_kernel.spectral_block(blocks - 1, n_frames) == (batch - 1, (tiles - 1) * 128, 0)
    text = (Path(frontend_kernel.__file__).parents[1] / "csrc" / "frontend_kernel.cu").read_text()
    assert "const int b = blockIdx.x / per_clip, t0 = (blockIdx.x % tiles) * kRows;" in text
    assert "const int grp = blockIdx.x % per_clip / tiles;" in text
    assert "const dim3 grid((unsigned)blocks);" in text and "blockIdx.y" not in text
