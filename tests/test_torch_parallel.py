"""PyTorch port's data parallelism across real ranks, on the CPU.

Child ranks are real processes joined over gloo through the port's own
`parallel.maybe_initialize_distributed`: this file run as a script (the
collectives) or `cli.train --distributed` (training). Children never import
JAX, pin one torch thread, get a timeout and are killed on any failure.

  * `routed_gather` equals `index_select` and the JAX package's
    `make_routed_gather` on the 8-device CPU mesh, bit for bit, for indices
    spread over both ranks' shards and for indices one rank owns all of; the loaders' process slices equal the global batches' rows and
    the JAX loaders' slices.
  * BatchNorm across 2 ranks, forward, gradients and running stats, within
    1e-6 of one process on the global batch.
  * The DP train step on tests/dist_common.py's problem (small model,
    global batch 16, 3 steps, dropout off on both sides), 2 ranks against
    the JAX package's 8-device mesh run: losses within rtol 1e-5.
  * `train()` across 2 ranks against one process, at the strengths
    tests/test_distributed.py holds the JAX package to: every rank's input
    rows equal the global rows by CRC, step-0 losses rtol 1e-5, confusion
    counts exact, epoch losses rtol 1e-3, rank 0 alone writes; on the
    decode path, a replicated corpus, a corpus sharded by rows (the routed
    gather every step) and chunked windows.
"""

import contextlib
import io
import json
import os
import re
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

if __name__ != "__main__":  # a child rank pins its own thread and imports no test module
    from test_torch_models import one_torch_thread  # noqa: F401

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CHILD_TIMEOUT = 120


# -- the child ranks -------------------------------------------------------------------


def _child(out_dir: str) -> None:
    """One rank of the collectives scenario: inputs from <out_dir>/in.pt,
    results to <out_dir>/rank<r>.pt."""
    import torch.distributed as dist

    from cough_detector_tpu_torch import parallel
    from cough_detector_tpu_torch.config import default_config
    from cough_detector_tpu_torch.models import create_model
    from cough_detector_tpu_torch.models.layers import BatchNorm
    from cough_detector_tpu_torch.train import StepRandom, make_optimizer, train_step

    torch.set_num_threads(1)
    assert parallel.maybe_initialize_distributed() is True
    group = parallel.process_group()
    rank, world = dist.get_rank(), dist.get_world_size()
    assert dist.get_backend() == "gloo" and world == 2
    inp = torch.load(os.path.join(out_dir, "in.pt"), weights_only=True)
    res = {}

    # routed gather, for each pattern of indices
    corpus = inp["corpus"].numpy()
    shard = torch.from_numpy(parallel.corpus_shard(lambda i: corpus[i], len(corpus), rank, world))
    for pattern, idx in inp["idx"].items():
        lo, hi = parallel.local_row_bounds(len(idx), rank, world)
        res[f"gather_{pattern}"] = parallel.routed_gather(shard, idx[lo:hi], group)

    # BatchNorm on this rank's rows of the global batch
    x, g, mask = inp["bn_x"], inp["bn_g"], inp["bn_mask"]
    lo, hi = parallel.local_row_bounds(x.shape[0], rank, world)
    bn = BatchNorm(x.shape[1])
    bn.load_state_dict(inp["bn_state"])
    bn.train()
    xl = x[lo:hi].clone().requires_grad_(True)
    with parallel.batch_slice(parallel.BatchSlice(lo, hi, x.shape[0], group)):
        y = bn(xl, mask[lo:hi])
        dx, dw, db = torch.autograd.grad((y * g[lo:hi]).sum(), [xl, bn.weight, bn.bias])
    for t in (dw, db):
        dist.all_reduce(t)  # the rank shares of the parameter gradients
    res.update(bn_y=y.detach(), bn_dx=dx, bn_dw=dw, bn_db=db,
               bn_mean=bn.running_mean, bn_var=bn.running_var)

    # the DP train step on dist_common's problem
    model = create_model("small")
    model.classifier[3].p = 0.0  # dropout off, as on the JAX side
    model.load_state_dict(inp["step_state"])
    opt = make_optimizer(model.parameters(), default_config("small").train, 4)
    feats, labels = inp["step_feats"], inp["step_labels"]
    lo, hi = parallel.local_row_bounds(feats.shape[0], rank, world)
    rows = parallel.BatchSlice(lo, hi, feats.shape[0], group)
    cw = torch.ones(2)
    losses = []
    with parallel.batch_slice(rows):
        for _ in range(3):
            m = train_step(model, opt, feats[lo:hi], labels[lo:hi], cw, StepRandom("cpu").key(0, 0, 0))
            losses.append(float(m["loss"]))
    res["step_losses"] = torch.tensor(losses, dtype=torch.float64)
    res["step_params"] = [p.detach().clone() for p in model.parameters()]
    torch.save(res, os.path.join(out_dir, f"rank{rank}.pt"))
    dist.destroy_process_group()


if __name__ == "__main__":
    sys.path.insert(0, _REPO)
    _child(sys.argv[1])
    raise SystemExit(0)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _ranks(argv, world: int = 2, cwd: str = _REPO) -> list:
    """Run `argv` as `world` ranks of one gloo group on this host; returns
    each rank's stdout. Fails (all ranks killed) if a rank fails or
    outlives _CHILD_TIMEOUT."""
    port = _free_port()
    procs = []
    for r in range(world):
        env = dict(os.environ)
        env.update({
            "RANK": str(r), "WORLD_SIZE": str(world), "LOCAL_RANK": str(r),
            "LOCAL_WORLD_SIZE": str(world), "MASTER_ADDR": "127.0.0.1",
            "MASTER_PORT": str(port), "OMP_NUM_THREADS": "1",
            "CDT_DEBUG_STEP_METRICS": "1", "PYTHONPATH": _REPO,
        })
        procs.append(subprocess.Popen(
            [sys.executable] + list(argv), env=env, cwd=cwd,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        ))
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=_CHILD_TIMEOUT)
            assert p.returncode == 0, f"rank failed:\n{out}\n{err}"
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return outs


# -- collectives -----------------------------------------------------------------------


def test_initialize_is_a_no_op_without_a_torchrun_environment(monkeypatch):
    import torch.distributed as dist

    from cough_detector_tpu_torch import parallel

    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("RANK", "0")  # a partial environment is none either
    assert parallel.maybe_initialize_distributed() is False
    assert not dist.is_initialized() and parallel.process_group() is None
    assert parallel.rank_device("cpu") == torch.device("cpu")


@pytest.fixture(scope="module")
def collectives(tmp_path_factory):
    """The inputs and both ranks' results of the collectives scenario."""
    import jax

    import dist_common
    from cough_detector_tpu_torch.models import from_jax_variables

    rng = np.random.default_rng(11)
    variables = jax.tree_util.tree_map(np.asarray, dist_common.build_state().variables)
    feats, labels = dist_common.make_batch()
    inp = {
        "corpus": torch.from_numpy(rng.integers(-32768, 32767, (40, 16)).astype(np.int16)),
        "idx": {  # spread over both ranks' shards of 20 rows; rank 1's alone
            "spread": torch.from_numpy(rng.integers(0, 40, 16)),
            "one_owner": torch.from_numpy(rng.integers(20, 40, 16)),
        },
        "bn_x": torch.from_numpy(rng.standard_normal((12, 3, 4, 5)).astype(np.float32) * 2 + 1),
        "bn_g": torch.from_numpy(rng.standard_normal((12, 3, 4, 5)).astype(np.float32)),
        "bn_mask": torch.tensor([1.0] * 9 + [0.0] * 3),
        "bn_state": {
            "weight": torch.tensor([0.5, 1.5, -1.0]), "bias": torch.tensor([0.1, -0.2, 0.3]),
            "running_mean": torch.zeros(3), "running_var": torch.ones(3),
            "num_batches_tracked": torch.tensor(0),
        },
        "step_state": {k: torch.as_tensor(v) for k, v in from_jax_variables(variables, "small").items()},
        "step_feats": torch.from_numpy(feats),
        "step_labels": torch.from_numpy(labels.astype(np.int64)),
    }
    out = tmp_path_factory.mktemp("collectives")
    torch.save(inp, out / "in.pt")
    _ranks([os.path.abspath(__file__), str(out)])
    res = [torch.load(out / f"rank{r}.pt", weights_only=True) for r in range(2)]
    return inp, res, variables


@pytest.mark.parametrize("pattern", ["spread", "one_owner"])
def test_routed_gather_equals_index_select_and_jax(collectives, pattern):
    from jax.sharding import NamedSharding, PartitionSpec as P
    import jax

    from cough_detector_tpu.parallel import corpus_sharding, make_mesh, make_routed_gather

    inp, res, _ = collectives
    got = torch.cat([r[f"gather_{pattern}"] for r in res])
    want = inp["corpus"].index_select(0, inp["idx"][pattern])
    assert got.dtype == torch.int16 and torch.equal(got, want)
    mesh = make_mesh()
    corpus = jax.device_put(inp["corpus"].numpy(), corpus_sharding(mesh))
    idx = jax.device_put(inp["idx"][pattern].numpy().astype(np.int32), NamedSharding(mesh, P("data")))
    np.testing.assert_array_equal(np.asarray(make_routed_gather(mesh)(corpus, idx)), got.numpy())


def _one_process_bn(inp):
    from cough_detector_tpu_torch.models.layers import BatchNorm

    bn = BatchNorm(3)
    bn.load_state_dict(inp["bn_state"])
    bn.train()
    x = inp["bn_x"].clone().requires_grad_(True)
    y = bn(x, inp["bn_mask"])
    grads = torch.autograd.grad((y * inp["bn_g"]).sum(), [x, bn.weight, bn.bias])
    return y.detach(), grads, bn


def test_batchnorm_across_ranks_matches_one_process(collectives):
    inp, res, _ = collectives
    y, (dx, dw, db), bn = _one_process_bn(inp)
    close = dict(rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(torch.cat([r["bn_y"] for r in res]), y, **close)
    torch.testing.assert_close(torch.cat([r["bn_dx"] for r in res]), dx, **close)
    for r in res:
        torch.testing.assert_close(r["bn_dw"], dw, **close)
        torch.testing.assert_close(r["bn_db"], db, **close)
        torch.testing.assert_close(r["bn_mean"], bn.running_mean, **close)
        torch.testing.assert_close(r["bn_var"], bn.running_var, **close)


def test_dp_step_matches_jax_eight_device_mesh(collectives, monkeypatch):
    """dist_common's problem: the JAX package's DP step over its 8-device
    CPU mesh (tests/test_distributed.py's reference run) against the port's
    2 ranks, from the same parameters, with dropout off on both sides (the
    small model's 0.3 is fixed; no two packages share a dropout stream)."""
    import flax.linen as nn
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    import dist_common
    from cough_detector_tpu.parallel import make_mesh, replicate

    inp, res, _ = collectives
    monkeypatch.setattr(nn.Dropout, "__call__", lambda self, x, deterministic=None, rng=None: x)
    mesh = make_mesh()
    feats, labels = dist_common.make_batch()
    data_sh = NamedSharding(mesh, P("data"))
    want = dist_common.run_steps(
        replicate(dist_common.build_state(), mesh),
        jax.device_put(feats, data_sh), jax.device_put(labels, data_sh),
        replicate(np.asarray([1.0, 1.0], np.float32), mesh),
        replicate(np.asarray(jax.random.PRNGKey(123)), mesh),
    )
    got = [r["step_losses"].numpy() for r in res]
    np.testing.assert_array_equal(got[0], got[1])  # every rank holds the global loss
    np.testing.assert_allclose(got[0], want, rtol=1e-5)
    for a, b in zip(res[0]["step_params"], res[1]["step_params"]):
        assert torch.equal(a, b)  # and the same parameters after each update


# -- the loaders' process slices -------------------------------------------------------------


@pytest.fixture(scope="module")
def clips(tmp_path_factory):
    """12 coughs and 12 non-coughs of 1.2 s at 16 kHz (test_distributed.py's)."""
    from cough_detector_tpu_torch.data import audio_io, synth

    root = tmp_path_factory.mktemp("dp_clips")
    for label, gen in (("cough", synth.synthetic_cough), ("non_cough", synth.synthetic_non_cough)):
        (root / label).mkdir()
        for i in range(12):
            audio_io.write_wav(root / label / f"{label}_{i:02d}.wav", gen(300 + i, 1.2), 16000)
    return root


@pytest.fixture(scope="module")
def packed(clips, tmp_path_factory):
    from cough_detector_tpu_torch.cli import pack

    out = tmp_path_factory.mktemp("dp_packed") / "corpus"
    with contextlib.redirect_stdout(io.StringIO()):
        pack.main(["--data-dir", str(clips), "--output", str(out), "--shard-size", "6", "--num-workers", "2"])
    return out


@pytest.mark.parametrize("kind", ["shards", "decode"])
def test_process_slices_equal_global_rows_and_jax(kind, clips, packed):
    from cough_detector_tpu.data.datasets import BatchLoader as JaxBatchLoader
    from cough_detector_tpu.data.datasets import CoughDataset as JaxCoughDataset
    from cough_detector_tpu.data.shards import ShardLoader as JaxShardLoader
    from cough_detector_tpu_torch.data import BatchLoader, CoughDataset, ShardLoader

    if kind == "shards":
        def make(cls):
            return cls(str(packed / "train"), 8, weighted=True, seed=5)
        ours_cls, jax_cls = ShardLoader, JaxShardLoader
    else:
        def make(cls):
            ds = (CoughDataset if cls is BatchLoader else JaxCoughDataset)(str(clips))
            return cls(ds, 8, weighted=True, seed=5, num_workers=2, time_shift_limit=0.2,
                       time_shift_prob=0.5, **({"backend": "python"} if cls is BatchLoader else {}))
        ours_cls, jax_cls = BatchLoader, JaxBatchLoader
    whole = list(make(ours_cls))
    total = 0
    for lo, hi in ((0, 4), (4, 8)):
        ours, theirs = make(ours_cls), make(jax_cls)
        ours.set_process_slice(lo, hi, 8)
        theirs.set_process_slice(lo, hi, 8)
        for (w, lab, n), (wj, labj, nj), (gw, gl) in zip(ours, theirs, whole):
            np.testing.assert_array_equal(w, wj)
            np.testing.assert_array_equal(lab, labj)
            assert n == nj == len(gl)
            np.testing.assert_array_equal(w[: max(0, min(hi, n) - lo)], gw[lo:hi])
            np.testing.assert_array_equal(lab[: max(0, min(hi, n) - lo)], gl[lo:hi])
        assert ours.rows_built == theirs.rows_built
        total += ours.rows_built
    assert total == sum(len(gl) for _, gl in whole)


# -- train() across ranks ----------------------------------------------------------------------


def _train_argv(data: str, out: str, mode: str) -> list:
    argv = ["--output-dir", out, "--model-type", "small", "--epochs", "2", "--batch-size", "8",
            "--patience", "50", "--device", "cpu"]
    if mode == "decode":
        return argv + ["--data-dir", data, "--no-esc50", "--num-workers", "2", "--decode-backend", "python"]
    corpus = {"replicated": ["--device-corpus", "always"],
              "sharded": ["--device-corpus", "always", "--device-corpus-budget", "100000"],
              "chunked": ["--device-corpus", "chunked", "--device-corpus-budget", "200000"]}[mode]
    return argv + ["--shards", data] + corpus


def _probe(pattern: str, text: str) -> list:
    return [m.groups() for m in re.finditer(pattern, text)]


@pytest.mark.parametrize("mode", ["decode", "replicated", "sharded", "chunked"])
def test_train_across_two_ranks_reproduces_one_process(mode, clips, packed, tmp_path, monkeypatch):
    from cough_detector_tpu_torch.cli import train as cli

    data = str(clips if mode == "decode" else packed)
    monkeypatch.setenv("CDT_DEBUG_STEP_METRICS", "1")
    single = io.StringIO()
    with contextlib.redirect_stdout(single):
        cli.main(_train_argv(data, str(tmp_path / "single"), mode))
    single = single.getvalue()
    ranks = _ranks(["-m", "cough_detector_tpu_torch.cli.train", "--distributed"]
                   + _train_argv(data, str(tmp_path / "dist"), mode))

    layout = {"replicated": "replicated", "sharded": "sharded by rows over 2 ranks",
              "chunked": "Chunked device corpus"}.get(mode)
    if layout:
        assert layout in ranks[0] and layout in ranks[1]
    # Input rows: each rank holds exactly the single run's rows [lo, hi) of
    # every batch (CRC per row), and, on the streamed path, builds only those.
    want = _probe(r"ROW_HASHES lo=(\d+) (\[.*\])", single)
    assert want and all(lo == "0" for lo, _ in want)
    for out in ranks:
        got = _probe(r"ROW_HASHES lo=(\d+) (\[.*\])", out)
        assert len(got) == len(want)
        for (_, full), (lo, part) in zip(want, got):
            part = json.loads(part)
            assert json.loads(full)[int(lo) : int(lo) + len(part)] == part
    built = [tuple(map(int, _probe(r"Input rows built \(rank \d+\): train (\d+), val (\d+)", o)[0]))
             for o in [single] + ranks]
    if mode in ("decode", "sharded"):  # each rank built or holds only its rows
        assert built[1][0] + built[2][0] == built[0][0] and max(built[1][0], built[2][0]) < built[0][0]
        assert built[1][1] + built[2][1] == built[0][1] and max(built[1][1], built[2][1]) < built[0][1]
        if mode == "decode":  # full train batches (drop_last): exact halves
            assert built[1][0] == built[2][0]
    if mode != "decode":
        mats = _probe(r"SCAN_MATS epoch=(\d+) crc=(\d+)", single)
        assert len(mats) == 2 and all(_probe(r"SCAN_MATS epoch=(\d+) crc=(\d+)", o) == mats for o in ranks)

    # Step-0 losses: one reduction's rounding apart.
    def losses(text):
        return {int(e): json.loads(v) for e, v in _probe(r"STEP_LOSSES epoch=(\d+) (\[.*\])", text)}

    ls, ld = losses(single), losses(ranks[0])
    assert ls.keys() == ld.keys() == {0, 1} and losses(ranks[1]) == ld
    np.testing.assert_allclose(ld[0], ls[0], rtol=1e-5)

    # Rank 0 alone wrote; confusion counts exact, losses rtol 1e-3.
    recs = [[json.loads(line) for line in (tmp_path / d / "metrics.jsonl").read_text().splitlines()]
            for d in ("single", "dist")]
    assert [r["epoch"] for r in recs[1]] == [0, 1]
    exact = {"epoch", "tp", "fp", "fn", "tn", "train_acc", "val_acc", "precision", "recall", "f1"}
    for rs, rd in zip(*recs):
        for k in exact:
            assert rd[k] == rs[k], (rs["epoch"], k)
        for k in ("train_loss", "val_loss"):
            np.testing.assert_allclose(rd[k], rs[k], rtol=1e-3, err_msg=k)
    assert "Epoch 0" in ranks[0] and "Epoch 0" not in ranks[1]
    assert sorted(p.name for p in (tmp_path / "dist").iterdir()) == sorted(
        p.name for p in (tmp_path / "single").iterdir()
    )
    for name in ("best_model", "latest_model"):
        assert (tmp_path / "dist" / name / "state.pt").exists()
