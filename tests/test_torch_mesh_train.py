"""PyTorch port's `train(mesh=...)`: data-parallel training over a mesh of
devices from one call, the JAX package's production default
(tests/test_train.py::TestDataParallelProduction), on the CPU.

A mesh of ["cpu", "cpu"] runs two gloo ranks as child processes of the call
(parallel/launch.py). Held here:

  * one module-scoped mesh run against the one-process run on the same
    packed corpus, at the strengths test_torch_parallel.py holds torchrun's
    ranks to: every rank's input rows equal the one-process rows by CRC,
    step-0 losses rtol 1e-5, confusion counts exact, epoch losses rtol
    1e-3, rank 0 alone writes, and the returned path is the best
    checkpoint, which StreamingDetector loads; and the JAX test's own
    bounds (rtol 5e-2, atol 1e-2) on its four metrics;
  * a batch the mesh does not divide pads, and the metrics count only
    real rows (JAX: test_dp_padded_batches_count_only_real_rows);
  * `resolve_train_mesh`'s rules, the several-cards default with
    torch.cuda's count monkeypatched, through train() and cli.train;
  * a failing rank: the call raises naming it, within a deadline, and
    leaves no child process;
  * the children import no JAX;
  * `cli.train --mesh cpu,cpu --compile-cache DIR`.

This module's top level imports no JAX: the children of the launcher tests
import it for their entries.
"""

import contextlib
import io
import json
import os
import re
import threading
import time

import numpy as np
import pytest
import torch

@pytest.fixture(autouse=True)
def one_torch_thread():
    """Tiny tensors: one intra-op thread, as the port's other test files."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _children() -> list:
    """Pids of this process's live children (from /proc)."""
    me, kids = os.getpid(), []
    for entry in os.listdir("/proc"):
        if not entry.isdigit():
            continue
        try:
            with open(f"/proc/{entry}/stat") as f:
                fields = f.read().rsplit(")", 1)[1].split()
        except OSError:
            continue
        if int(fields[1]) == me and fields[0] != "Z":
            kids.append(int(entry))
    return kids


@pytest.fixture(autouse=True)
def nothing_left_behind():
    before = set(_children())
    yield
    assert set(_children()) <= before, "a rank outlived its call"
    assert not [t for t in threading.enumerate() if t.name.startswith("cdt-rank")]


# -- entries the launcher tests' children run ----------------------------------------


def _fail_on_rank(device, rank: int):
    """Rank `rank` raises; the other blocks in a collective it never
    completes."""
    import torch.distributed as dist

    if dist.get_rank() == rank:
        raise ValueError(f"rank {rank} fails on purpose")
    dist.barrier()


def _imported(device):
    """The trainer's whole import closure in a child: the top-level names in
    sys.modules after importing the training package, the CLI and the
    launcher."""
    import sys

    import cough_detector_tpu_torch.cli.train  # noqa: F401
    import cough_detector_tpu_torch.parallel.launch  # noqa: F401
    import cough_detector_tpu_torch.train  # noqa: F401

    return sorted({name.split(".")[0] for name in sys.modules})


# -- the corpus and the runs ----------------------------------------------------------


def _cfg(batch_size: int = 8, epochs: int = 2):
    from cough_detector_tpu_torch.config import Config, ModelConfig, TrainConfig

    return Config(model=ModelConfig(model_type="small"), train=TrainConfig(batch_size=batch_size, epochs=epochs, patience=50))


@pytest.fixture(scope="module")
def packed(tmp_path_factory):
    """32 training and 10 validation clips of 1 s, a cough every third."""
    from cough_detector_tpu_torch.data import pack_arrays, synth

    def corpus(n, seed):
        labels = (np.arange(n) % 3 == 0).astype(np.int64)
        waves = np.stack([(synth.synthetic_cough if lab else synth.synthetic_non_cough)(seed + i, 1.0)
                          for i, lab in enumerate(labels)])
        return waves, labels

    root = tmp_path_factory.mktemp("mesh_corpus")
    pack_arrays(*corpus(32, 0), str(root / "train"), shard_size=12)
    pack_arrays(*corpus(10, 400), str(root / "val"))
    return root


def _run(out, packed, mesh, batch_size=8, epochs=2, log_dir=None) -> tuple:
    """train() with the probes on; (returned path, what it printed)."""
    from cough_detector_tpu_torch.train import train

    buf = io.StringIO()
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("CDT_DEBUG_STEP_METRICS", "1")
        if log_dir is not None:
            mp.setenv("CDT_RANK_LOG_DIR", str(log_dir))
        with contextlib.redirect_stdout(buf):
            best = train(None, str(out), config=_cfg(batch_size, epochs), shards_dir=str(packed),
                         device="cpu", mesh=mesh)
    return best, buf.getvalue()


@pytest.fixture(scope="module")
def runs(packed, tmp_path_factory):
    """The one-process run and the mesh run of ["cpu", "cpu"] on the same
    corpus, 2 epochs of batch 8."""
    root = tmp_path_factory.mktemp("mesh_runs")
    single = _run(root / "single", packed, False)
    mesh = _run(root / "mesh", packed, ["cpu", "cpu"], log_dir=root / "logs")
    ranks = [(root / "logs" / f"rank{r}.log").read_text() for r in range(2)]
    return dict(root=root, single=single, mesh=mesh, ranks=ranks)


def _probe(pattern: str, text: str) -> list:
    return [m.groups() for m in re.finditer(pattern, text)]


def _records(out) -> list:
    return [json.loads(line) for line in (out / "metrics.jsonl").read_text().splitlines()]


# -- the mesh run against one process --------------------------------------------------


def test_mesh_run_starts_two_gloo_ranks_and_rank_zero_speaks(runs):
    _, printed = runs["mesh"]
    assert "Data-parallel over a mesh of 2 devices ['cpu', 'cpu'] (gloo): one rank a device" in printed
    for r, text in enumerate(runs["ranks"]):
        assert f"Data-parallel over 2 ranks (gloo): rank {r} on cpu" in text
        assert "Steps: eager (the CPU runs the plain steps)" in text
    # Rank 0's output reaches the caller; rank 1's stays in its log.
    assert "rank 0 on cpu" in printed and "rank 1 on cpu" not in printed


def test_mesh_ranks_hold_the_one_process_rows(runs):
    """Every rank's block of every batch equals the one-process run's rows
    by CRC, and the epochs' batch matrices are the same."""
    row_pat, mats_pat = r"ROW_HASHES lo=(\d+) (\[.*\])", r"SCAN_MATS epoch=(\d+) crc=(\d+)"
    want = _probe(row_pat, runs["single"][1])
    assert want and all(lo == "0" for lo, _ in want)
    for text in runs["ranks"]:
        got = _probe(row_pat, text)
        assert len(got) == len(want)
        for (_, full), (lo, part) in zip(want, got):
            part = json.loads(part)
            assert json.loads(full)[int(lo): int(lo) + len(part)] == part
        assert _probe(mats_pat, text) == _probe(mats_pat, runs["single"][1]) != []
    assert [lo for lo, _ in _probe(row_pat, runs["ranks"][1])][:1] == ["4"]


def test_mesh_step_losses_and_epochs_match_one_process(runs):
    def losses(text):
        return {int(e): json.loads(v) for e, v in _probe(r"STEP_LOSSES epoch=(\d+) (\[.*\])", text)}

    ls, l0, l1 = losses(runs["single"][1]), losses(runs["ranks"][0]), losses(runs["ranks"][1])
    assert ls.keys() == l0.keys() == {0, 1} and l1 == l0
    np.testing.assert_allclose(l0[0], ls[0], rtol=1e-5)
    single, mesh = _records(runs["root"] / "single"), _records(runs["root"] / "mesh")
    assert [r["epoch"] for r in mesh] == [0, 1]
    for rs, rd in zip(single, mesh):
        for k in ("tp", "fp", "fn", "tn", "train_acc", "val_acc", "precision", "recall", "f1"):
            assert rd[k] == rs[k], (rs["epoch"], k)
        for k in ("train_loss", "val_loss"):
            np.testing.assert_allclose(rd[k], rs[k], rtol=1e-3, err_msg=k)


def test_mesh_trajectory_within_the_jax_tests_bounds(runs):
    """JAX: test_dp_trajectory_matches_single_device's bounds."""
    single, mesh = _records(runs["root"] / "single"), _records(runs["root"] / "mesh")
    assert len(single) == len(mesh) == 2
    for s, d in zip(single, mesh):
        for k in ("train_loss", "val_loss", "train_acc", "val_acc"):
            np.testing.assert_allclose(d[k], s[k], rtol=5e-2, atol=1e-2, err_msg=k)


def test_mesh_rank_zero_alone_writes_and_returns_the_best_checkpoint(runs):
    from cough_detector_tpu_torch.stream import StreamingDetector
    from cough_detector_tpu_torch.train import checkpoint

    root = runs["root"]
    best, printed = runs["mesh"]
    assert "Epoch 0" in runs["ranks"][0] and "Epoch 0" in printed and "Epoch 0" not in runs["ranks"][1]
    assert sorted(p.name for p in (root / "mesh").iterdir()) == sorted(p.name for p in (root / "single").iterdir())
    assert best == str(root / "mesh" / "best_model") and runs["single"][0] == str(root / "single" / "best_model")
    best_f1 = max(r["f1"] for r in _records(root / "mesh"))
    assert checkpoint.load_checkpoint(best)[2]["f1"] == best_f1
    det = StreamingDetector(best, device="cpu")
    assert det.config.model.model_type == "small"


def test_mesh_padded_batches_count_only_real_rows(packed, tmp_path):
    """Batch 3 over 2 ranks pads every batch to 4 rows under a mask (the
    streamed placement); the 10 validation clips are counted once, as the
    one-process run counts them."""
    _run(tmp_path / "one", packed, False, batch_size=3, epochs=1)
    _, printed = _run(tmp_path / "mesh", packed, ["cpu", "cpu"], batch_size=3, epochs=1)
    assert "Input sharding: rank 0 builds batch rows [0, 2) of 4" in printed
    rec, one = _records(tmp_path / "mesh")[-1], _records(tmp_path / "one")[-1]
    assert rec["tp"] + rec["fp"] + rec["fn"] + rec["tn"] == 10
    assert 0.0 <= rec["val_acc"] <= 100.0 and 0.0 <= rec["train_acc"] <= 100.0
    for k in ("tp", "fp", "fn", "tn", "train_acc"):
        assert rec[k] == one[k], k


# -- resolve_train_mesh ---------------------------------------------------------------


@pytest.fixture
def cards(monkeypatch):
    """A host that reports `n` visible cards (torch.cuda monkeypatched)."""
    def visible(n: int) -> None:
        monkeypatch.setattr(torch.cuda, "is_available", lambda: n > 0)
        monkeypatch.setattr(torch.cuda, "device_count", lambda: n)
        monkeypatch.setattr(torch.cuda, "is_initialized", lambda: False)
    return visible


@pytest.mark.parametrize("n_cards, device, mesh, want", [
    (0, "cpu", None, None),
    (0, "cuda", None, None),
    (1, "cuda", None, None),
    (3, "cuda", None, ["cuda:0", "cuda:1", "cuda:2"]),
    (3, "cuda:1", None, None),
    (3, "cpu", None, None),
    (3, "cuda", False, None),
    (0, "cpu", ["cpu", "cpu"], ["cpu", "cpu"]),
    (0, "cpu", ("cpu",), ["cpu"]),
    (2, "cpu", ["cuda", "cuda:1"], ["cuda:0", "cuda:1"]),
    (1, "cuda", ["cuda:0", "cuda:0"], ["cuda:0", "cuda:0"]),
])
def test_resolve_train_mesh(cards, n_cards, device, mesh, want):
    from cough_detector_tpu_torch import parallel

    cards(n_cards)
    got = parallel.resolve_train_mesh(mesh, device)
    assert (None if got is None else [str(d) for d in got.devices]) == want
    given = parallel.Mesh(["cpu", "cpu"])
    assert parallel.resolve_train_mesh(given, "cpu").devices == given.devices


@pytest.mark.parametrize("mesh, batch_size, match", [
    (object(), None, "not a training mesh: .* expected a Mesh"),
    ("cpu,cpu", None, "not a training mesh: .* expected a Mesh"),
    (["cpu", "cuda:0"], None, "all cards or all the CPU"),
    (["cpu", "meta"], None, "all cards or all the CPU"),
    (["cuda:0", "cuda:2"], None, "past the 2 visible"),
    (["cpu", "not a device"], None, "not a training mesh"),
    (["cpu", "cpu"], 5, "does not split"),
])
def test_resolve_train_mesh_refuses(cards, mesh, batch_size, match):
    from cough_detector_tpu_torch import parallel

    cards(2)
    with pytest.raises(ValueError, match=match):
        parallel.resolve_train_mesh(mesh, "cpu", batch_size)


@pytest.mark.parametrize("kwargs", [
    dict(mesh=object()),
    dict(mesh=["cpu", "cuda:0"]),
    dict(mesh=["cpu", "cpu"], device_corpus=True, batch_size=5),
    dict(mesh=["cpu", "cpu"], device_corpus="chunked", batch_size=7),
    dict(mesh=["cpu", "cpu"], in_group=True),
])
def test_train_refuses_a_mesh_before_any_work(packed, tmp_path, kwargs):
    """A bad mesh raises ValueError from train() before a file is written;
    inside a process group (of one gloo rank here) any mesh does."""
    import socket

    import torch.distributed as dist

    from cough_detector_tpu_torch.train import train

    kwargs = dict(kwargs)
    in_group, bs = kwargs.pop("in_group", False), kwargs.pop("batch_size", 8)
    if in_group:
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=0, world_size=1)
    try:
        with pytest.raises(ValueError):
            train(None, str(tmp_path / "out"), config=_cfg(bs), shards_dir=str(packed), device="cpu", **kwargs)
    finally:
        if in_group:
            dist.destroy_process_group()
    assert not (tmp_path / "out").exists()


def test_several_cards_train_over_every_card_by_default(cards, packed, tmp_path, monkeypatch):
    """With 2 cards visible, no process group and device "cuda", train() and
    cli.train start a rank on each card (the launcher recorded here, not
    run); mesh=False and --mesh with one device keep one process on one
    card."""
    from cough_detector_tpu_torch.cli import train as cli
    from cough_detector_tpu_torch.parallel import launch
    from cough_detector_tpu_torch.train import loop, train

    cards(2)
    monkeypatch.setenv("CUBLAS_WORKSPACE_CONFIG", ":4096:8")  # restored after the one-process calls
    launched, one = [], []
    monkeypatch.setattr(launch, "run_ranks", lambda mesh, entry, kw: launched.append((mesh, entry, kw)) or "ranks")
    monkeypatch.setattr(loop, "_train", lambda output_dir, config, dev, ranks, *a: one.append((dev, ranks)) or "one")
    common = dict(config=_cfg(), shards_dir=str(packed))
    with contextlib.redirect_stdout(io.StringIO()):
        assert train(None, str(tmp_path / "a"), **common) == "ranks"
        assert train(None, str(tmp_path / "b"), mesh=False, **common) == "one"
        assert train(None, str(tmp_path / "c"), mesh=["cuda:1"], **common) == "one"
        cli.main(["--shards", str(packed), "--output-dir", str(tmp_path / "d"), "--model-type", "small"])
        cli.main(["--shards", str(packed), "--output-dir", str(tmp_path / "e"), "--model-type", "small",
                  "--mesh", "cuda:1"])
    assert len(launched) == 2
    for mesh, entry, kw in launched:
        assert [str(d) for d in mesh.devices] == ["cuda:0", "cuda:1"]
        assert entry is train and kw["mesh"] is None and "device" not in kw
    assert launched[0][2]["shards_dir"] == str(packed) and launched[0][2]["config"] == _cfg()
    assert [str(dev) for dev, _ in one] == ["cuda", "cuda:1", "cuda:1"]
    assert all(r.world == 1 and r.group is None for _, r in one)
    assert not (tmp_path / "a").exists() and not (tmp_path / "d").exists()


# -- the launcher ---------------------------------------------------------------------


@pytest.mark.parametrize("failing", [0, 1])
def test_a_failing_rank_raises_naming_it_and_leaves_no_child(failing):
    """One rank raises while the other waits in a collective it will never
    complete: the call raises within the deadline, naming the rank and its
    error, and kills the waiting rank."""
    from cough_detector_tpu_torch.parallel import Mesh, launch

    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match=rf"rank {failing} of 2 failed \(exit code 1\): "
                                           rf"ValueError: rank {failing} fails on purpose") as info:
        launch.run_ranks(Mesh(["cpu", "cpu"]), _fail_on_rank, {"rank": failing})
    assert time.monotonic() - t0 < 60
    assert "Traceback" in str(info.value)


def test_children_import_no_jax():
    """tests/conftest.py has imported JAX in this process; a rank is a fresh
    interpreter and the port's trainer imports none of it."""
    import sys

    from cough_detector_tpu_torch.parallel import Mesh, launch

    assert "jax" in sys.modules
    names = launch.run_ranks(Mesh(["cpu", "cpu"]), _imported, {})
    assert "cough_detector_tpu_torch" in names and "torch" in names
    assert "jax" not in names and "cough_detector_tpu" not in names and "flax" not in names


def test_cli_trains_over_a_mesh(packed, tmp_path, capsys):
    from cough_detector_tpu_torch.cli import train as cli
    from cough_detector_tpu_torch.stream import StreamingDetector

    out = tmp_path / "cli"
    cli.main(["--shards", str(packed), "--output-dir", str(out), "--model-type", "small", "--epochs", "1",
              "--batch-size", "8", "--device", "cpu", "--mesh", "cpu,cpu", "--compile-cache",
              str(tmp_path / "cache"), "--export-pt"])
    printed = capsys.readouterr().out
    assert "(gloo): one rank a device" in printed and "Epoch 0" in printed and "Exported" in printed
    assert [r["epoch"] for r in _records(out)] == [0]
    assert StreamingDetector(str(out / "best_model.pt"), device="cpu").config.model.model_type == "small"
    with pytest.raises(SystemExit):
        cli.main(["--shards", str(packed), "--device", "cpu", "--mesh", "cpu,cpu", "--distributed"])
