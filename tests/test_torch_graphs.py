"""The port's captured programs (utils/graphs.py) on the CPU.

On the card the streaming tick and the train and eval steps run as
captured CUDA graphs; on the CPU the same `Programs` objects copy the
inputs into the same static buffers and call the function on them, so the
buffer plumbing, the keys and the capture-safe program bodies run here.
Checked:
  * the capture-safe tick (the window count a device scalar, the state
    updated in place), eager and through the programs, against the JAX
    package's `stream_step` on the same numpy chunks: f32, int16 and μ-law,
    mid-run lane resets and threshold changes, past 2^15 windows (the
    packed window index's two halves carry);
  * a dispatched tick's `packed` outlives the ticks dispatched after it;
  * the tick's keys at the shipped geometry are the cycle `tick_fills`
    predicts;
  * `ClippedAdamW`'s tensor scalars against optax on identical grads;
  * `make_fused_epoch_fn` / `make_window_fns` against `train_steps` /
    `eval_steps` on the same matrices (bit for bit), and `train()` through
    the programs against the eager loop;
  * the package's import surface against the JAX package's `__all__`.
The kernels themselves are not run here; chip_smoke.py holds the graphs
against the eager path on the card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cough_detector_tpu
import cough_detector_tpu.ops
from cough_detector_tpu.config import StreamConfig as JaxStreamConfig
from cough_detector_tpu.config import TrainConfig as JaxTrainConfig
from cough_detector_tpu.config import FeatureConfig as JaxFeatureConfig
from cough_detector_tpu.serve.server import quantize_i16, quantize_mulaw
from cough_detector_tpu.stream import ring as jax_ring
from cough_detector_tpu.train import steps as jax_steps
from cough_detector_tpu_torch.config import Config, FeatureConfig, ModelConfig, StreamConfig, TrainConfig
from cough_detector_tpu_torch.data import pack_arrays
from cough_detector_tpu_torch.models import init_weights, model_from_config
from cough_detector_tpu_torch.stream import init_state, make_stream_step, ring
from cough_detector_tpu_torch.train import checkpoint, loop, steps
from cough_detector_tpu_torch.utils.graphs import Programs
from test_torch_models import one_torch_thread  # noqa: F401
from test_torch_train import _assert_same_run, _cfg, _corpus

CHUNK = 1600
S = 4
NEVER = -(1 << 24)


# -- the tick ----------------------------------------------------------------------


def _score_jax(w):
    return jnp.clip(jnp.abs(w[:, 0]) * 3.0, 0.0, 1.0)


def _score_torch(w):
    return torch.clamp(w[:, 0].abs() * 3.0, 0.0, 1.0)


def _chunks(fmt: str, n: int) -> list:
    rng = np.random.default_rng(5)
    gain = rng.uniform(0.02, 0.4, (S, n, 1)).astype(np.float32)
    audio = (rng.standard_normal((S, n, CHUNK)) * gain).clip(-1, 1).astype(np.float32)
    ticks = [audio[:, i] for i in range(n)]
    if fmt == "int16":
        return [quantize_i16(t) for t in ticks]
    if fmt == "mulaw":
        return [quantize_mulaw(t) for t in ticks]
    return ticks


def _decode(packed: np.ndarray) -> tuple:
    win = packed[1].astype(np.int64) * 32768 + packed[2].astype(np.int64)
    return packed[0] > 0.5, win, packed[3 : 3 + S], packed[3 + S :] > 0.5


def _jax_lanes(state, lanes, thr, scrub: bool):
    m = np.zeros(S, bool)
    m[lanes] = True
    thr_all = np.where(m, np.float32(thr), np.asarray(state.threshold))
    if not scrub:
        return state._replace(threshold=jnp.asarray(thr_all))
    return state._replace(
        buffer=jnp.where(m[:, None], 0.0, state.buffer),
        history=jnp.where(m[:, None], 0.0, state.history),
        history_len=jnp.where(m, 0, state.history_len),
        last_fire_window=jnp.where(m, NEVER, state.last_fire_window),
        threshold=jnp.asarray(thr_all),
    )


def _torch_lanes(state, lanes, thr, scrub: bool):
    m = torch.zeros(S, dtype=torch.bool)
    m[lanes] = True
    if scrub:
        state.buffer.masked_fill_(m[:, None], 0.0)
        state.history.masked_fill_(m[:, None], 0.0)
        state.history_len.masked_fill_(m, 0)
        state.last_fire_window.masked_fill_(m, NEVER)
    state.threshold.masked_fill_(m, thr)


@pytest.mark.parametrize("graphed", [False, True], ids=["eager", "programs"])
@pytest.mark.parametrize("fmt", ["float32", "int16", "mulaw"])
def test_capture_safe_tick_matches_jax(fmt, graphed):
    """48 ticks from window 2^15 - 6 on: lane 1 scrubbed (threshold 0.3) at
    tick 20, lane 2 retuned to 0.8 at tick 30; valid, window indices and
    fires equal, smoothed within 1e-6."""
    scfg = StreamConfig(confidence_threshold=0.5, smoothing_window=3, debounce_seconds=0.5)
    jscfg = JaxStreamConfig(confidence_threshold=0.5, smoothing_window=3, debounce_seconds=0.5)
    jstep = jax_ring.make_stream_step(_score_jax, JaxFeatureConfig(), jscfg, CHUNK)
    jstate = jax_ring.init_state(S, CHUNK, 16000, 3, 0.5)
    jstate = jstate._replace(windows_emitted=jnp.int32((1 << 15) - 6))
    step = make_stream_step(_score_torch, FeatureConfig(), scfg, graphed=graphed)
    state = init_state(S, CHUNK, 16000, 3, 0.5, device="cpu")._replace(windows_emitted=(1 << 15) - 6)
    fires = 0
    for t, chunk in enumerate(_chunks(fmt, 48)):
        if t in (20, 30):
            lanes, thr, scrub = ([1], 0.3, True) if t == 20 else ([2], 0.8, False)
            jstate = _jax_lanes(jstate, lanes, thr, scrub)
            _torch_lanes(state, lanes, thr, scrub)
        jstate, jev = jstep(jstate, jnp.asarray(chunk))
        state, ev = step(state, chunk)
        if graphed:
            assert set(ev) == {"packed"}
        want, got = _decode(np.asarray(jev["packed"])), _decode(ev["packed"].numpy())
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1][got[0]], want[1][want[0]])
        assert np.abs(got[2] - want[2])[:, want[0]].max(initial=0) < 1e-6
        np.testing.assert_array_equal(got[3][:, want[0]], want[3][:, want[0]])
        fires += int(want[3][:, want[0]].sum())
    assert state.windows_emitted == int(jstate.windows_emitted) > 1 << 15
    assert 0 < fires < 4 * int(jstate.windows_emitted - ((1 << 15) - 6))
    if graphed:
        assert step.programs.keys and all(k[0] == str(chunk.dtype) for k in step.programs.keys)


def test_dispatched_packed_outlives_later_ticks():
    """A tick's `packed` is a copy: 3 x 4 workers + 2 ticks dispatched after
    it (what the daemon may hold uncollected) leave it as it was."""
    step = make_stream_step(_score_torch, FeatureConfig(), StreamConfig(confidence_threshold=0.2), graphed=True)
    state = init_state(S, CHUNK, 16000, 3, 0.2, device="cpu")
    ticks = _chunks("float32", 10 + 3 * 4 + 2)
    held = []
    for chunk in ticks:
        state, ev = step(state, chunk)
        held.append((ev["packed"], ev["packed"].clone()))
    for got, snapshot in held:
        assert torch.equal(got, snapshot)
    assert len({id(p) for p, _ in held}) == len(held)
    assert held[9][0][0].sum() == 1  # tick 9 completes the first window


def test_programs_copy_outputs_out_of_the_static_buffers():
    """The runner's plumbing: inputs into one static buffer a (name, shape,
    dtype), outputs copied out unless asked not to, a key's inputs fixed."""
    programs = Programs("cpu")
    out = torch.zeros(3)

    def fn(static):
        out.copy_(static["x"] * 2)
        return (out,)

    first = programs("k", fn, {"x": np.arange(3, dtype=np.float32)})
    a = programs("k", fn, {"x": np.ones(3, np.float32)})
    b = programs("k", fn, {"x": torch.full((3,), 5.0)})
    assert a[0].tolist() == [2, 2, 2] and b[0].tolist() == [10, 10, 10]
    (alias,) = programs("k", fn, {"x": np.zeros(3, np.float32)}, copy=(False,))
    assert alias is out and first[0] is out
    assert programs.keys == ["k"] and programs.replays() == {"k": 3}
    with pytest.raises(ValueError, match="differ from its first call"):
        programs("k", fn, {"x": np.zeros(4, np.float32)})


def test_tick_keys_cycle_at_the_shipped_geometry():
    """1600-sample chunks, 1 s windows, 0.25 s hops: 13 keys, the 10 fills of
    an empty ring's first second, then a cycle of 5."""
    fills = ring.tick_fills(CHUNK, 16000, 4000)
    assert fills == list(range(0, 16000, 1600)) + [12000, 13600, 15200]
    step = make_stream_step(_score_torch, FeatureConfig(), StreamConfig(), graphed=True)
    state = init_state(2, CHUNK, 16000, 3, device="cpu")
    seen = []
    for chunk in _chunks("int16", 40):
        seen.append(state.fill)
        state, _ = step(state, chunk[:2])
    assert [k[2] for k in step.programs.keys] == fills
    assert set(seen[10:]) == {12000, 12800, 13600, 14400, 15200}
    replays = step.programs.replays()
    assert sum(replays.values()) == 40 - len(fills)


# -- the optimizer ---------------------------------------------------------------


def test_tensor_scalars_match_optax_on_identical_grads():
    """advance() + update() with the scalars as a tensor, 7 steps across a
    warm restart, on grads both sides are handed (never grads either side
    computed): parameters within 1e-6 of optax, and bit-equal to step()."""
    rng = np.random.default_rng(7)
    shapes = {"a": (3, 4), "b": (5,), "c": (2, 2, 3, 3)}
    params = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
    grads = [
        {k: (rng.standard_normal(s) * scale).astype(np.float32) for k, s in shapes.items()}
        for scale in (0.05, 1.0, 0.02, 2.0, 0.1, 0.05, 3.0)
    ]
    tx = jax_steps.make_optimizer(JaxTrainConfig(sched_t0=1), 3)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    opt_state = tx.init(jp)
    tensor_params = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    step_params = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    opt = steps.make_optimizer(list(tensor_params.values()), TrainConfig(sched_t0=1), 3)
    ref = steps.make_optimizer(list(step_params.values()), TrainConfig(sched_t0=1), 3)
    for g in grads:
        updates, opt_state = tx.update(g, opt_state, jp)
        jp = jax.tree_util.tree_map(lambda p, u: p + u, jp, updates)
        scalars = opt.advance()
        assert scalars.dtype == np.float32 and scalars.shape == (3,)
        opt.update([torch.from_numpy(g[k]) for k in shapes], torch.from_numpy(scalars))
        ref.step([torch.from_numpy(g[k]) for k in shapes])
    assert opt.count == ref.count == 7
    for k in shapes:
        np.testing.assert_allclose(tensor_params[k].numpy(), np.asarray(jp[k]), rtol=0, atol=1e-6 * float(np.abs(np.asarray(jp[k])).max()))
        assert torch.equal(tensor_params[k], step_params[k]), k


# -- the steps ------------------------------------------------------------------------


def _trainer(mixup: bool):
    cfg = Config(
        model=ModelConfig(model_type="small"),
        train=TrainConfig(batch_size=8, use_mixup=mixup),
    )
    model = model_from_config(cfg.model)
    init_weights(model, torch.Generator().manual_seed(0))
    opt = steps.make_optimizer(model.parameters(), cfg.train, 3)
    feats = loop.make_feature_fns(cfg, torch.device("cpu"), use_time_shift=True)
    return cfg, model, opt, feats


def _mats(rng, n_rows: int, steps_: int, b: int, padded_last: bool):
    idx = rng.integers(0, n_rows, (steps_, b)).astype(np.int64)
    labels = rng.integers(0, 2, (steps_, b)).astype(np.int64)
    mask = np.ones((steps_, b), np.float32)
    if padded_last:
        mask[-1, -3:] = 0
    return idx, labels, mask


def _state(model, opt) -> list:
    return list(model.state_dict().values()) + opt.mu + opt.nu


@pytest.mark.parametrize("mixup", [False, True], ids=["plain", "mixup"])
def test_fused_epoch_and_windows_equal_the_eager_steps(mixup):
    """An epoch of 3 train steps (the last padded) and 2 eval steps (the last
    padded): the fused epoch function, and the same epoch as two chunked
    windows with their own buffers and the step offset carried, equal the
    eager train_steps / eval_steps bit for bit (metrics, parameters, BN
    stats, moments)."""
    rng = np.random.default_rng(3)
    corpus = torch.from_numpy((rng.standard_normal((24, 16000)) * 3000).astype(np.int16))
    val = torch.from_numpy((rng.standard_normal((12, 16000)) * 3000).astype(np.int16))
    mats, val_mats = _mats(rng, 24, 3, 8, True), _mats(rng, 12, 2, 8, True)
    seed, epoch = 4, 1
    alpha = 0.2 if mixup else None

    cfg, model, opt, (tf, ef) = _trainer(mixup)
    cw = torch.tensor([1.0, 2.0])
    rand = steps.StepRandom("cpu")
    want_t = steps.train_steps(model, opt, steps.window_batches(corpus, mats), cw, rand, seed, epoch,
                               feature_fn=tf, mixup_alpha=alpha)
    want_v = steps.eval_steps(model, steps.window_batches(val, val_mats), cw, ef)
    want = _state(model, opt)

    for windowed in (False, True):
        cfg, model, opt, (tf, ef) = _trainer(mixup)
        programs = steps.StepPrograms(model, opt, cw, steps.StepRandom("cpu"), tf, ef, mixup_alpha=alpha)
        if windowed:
            train_w, eval_w = steps.make_window_fns(programs)
            rows = []
            for s0, s1 in ((0, 2), (2, 3)):
                part = tuple(m[s0:s1] for m in mats)
                uniq, inv = np.unique(part[0], return_inverse=True)
                buf = corpus[torch.from_numpy(uniq)]
                rows.append(train_w(buf, (inv.reshape(part[0].shape),) + part[1:], seed, epoch, s0))
            got_t, got_v = torch.cat(rows), eval_w(val, val_mats)
        else:
            got_t, got_v = steps.make_fused_epoch_fn(programs)(corpus, mats, val, val_mats, seed, epoch)
        assert torch.equal(got_t, torch.stack([steps.metric_row(m, steps.TRAIN_KEYS) for m in want_t]))
        assert torch.equal(got_v, torch.stack([steps.metric_row(m, steps.EVAL_KEYS) for m in want_v]))
        for x, y in zip(_state(model, opt), want):
            assert torch.equal(x, y)
        keys = programs.programs.keys
        assert {k[:3] for k in keys} == {("train", False, 8), ("train", True, 8), ("eval", False, 8), ("eval", True, 8)}


@pytest.fixture(scope="module")
def small_shards(tmp_path_factory):
    root = tmp_path_factory.mktemp("graph_shards")
    pack_arrays(*_corpus(40, 0), str(root / "train"), shard_size=16)
    pack_arrays(*_corpus(12, 500), str(root / "val"))
    return root


def _small(epochs: int) -> Config:
    cfg = _cfg(epochs, "small")
    return Config(model=cfg.model, train=TrainConfig(batch_size=8, epochs=epochs, patience=50))


@pytest.fixture(scope="module")
def eager_run(small_shards, tmp_path_factory):
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        out = tmp_path_factory.mktemp("eager")
        loop.train(None, str(out), config=_small(2), shards_dir=str(small_shards), device="cpu")
    finally:
        torch.set_num_threads(n)
    return out


@pytest.mark.parametrize("placement", [
    dict(), dict(device_corpus="chunked", device_corpus_budget=600_000), dict(device_corpus=False),
], ids=["resident", "chunked", "streamed"])
def test_train_through_the_programs_gives_the_eager_run(placement, eager_run, small_shards, tmp_path,
                                                        monkeypatch, capsys):
    """train() with its steps through the programs (as on the card),
    resident, chunked and streamed: the eager run bit for bit, and the
    resident run resumed from epoch 0 too."""
    monkeypatch.setattr(loop, "_graphed_steps", lambda dev, group: True)
    out = tmp_path / "programs"
    loop.train(None, str(out), config=_small(2), shards_dir=str(small_shards), device="cpu", **placement)
    assert "Steps: captured programs, called directly on the CPU" in capsys.readouterr().out
    _assert_same_run(eager_run, out)
    if not placement:
        resumed = tmp_path / "resumed"
        loop.train(None, str(resumed), config=_small(1), shards_dir=str(small_shards), device="cpu")
        loop.train(None, str(resumed), config=_small(2), shards_dir=str(small_shards), device="cpu",
                   resume=str(resumed / "latest_model"))
        _assert_same_run(eager_run, resumed)


def test_graphed_steps_follow_the_device_and_backend(tmp_path):
    """Graphs on the card in one process or over NCCL; a gloo group runs the
    eager steps (its collectives cannot be captured), as does the CPU."""
    import torch.distributed as dist

    assert loop._graphed_steps(torch.device("cuda", 0), None)
    assert not loop._graphed_steps(torch.device("cpu"), None)
    store = dist.FileStore(str(tmp_path / "store"), 1)
    dist.init_process_group("gloo", store=store, rank=0, world_size=1)
    try:
        assert not loop._graphed_steps(torch.device("cuda", 0), dist.group.WORLD)
    finally:
        dist.destroy_process_group()


# -- the import surface -----------------------------------------------------------


@pytest.mark.parametrize("package,jax_package", [
    ("cough_detector_tpu_torch", cough_detector_tpu),
    ("cough_detector_tpu_torch.ops", cough_detector_tpu.ops),
], ids=["top", "ops"])
def test_port_exports_the_jax_names(package, jax_package):
    import importlib

    port = importlib.import_module(package)
    for name in jax_package.__all__:
        assert getattr(port, name) is not None, name
    assert set(jax_package.__all__) <= set(port.__all__)
