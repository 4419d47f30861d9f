"""PyTorch port's training path against the JAX package, on the CPU.

Same numpy inputs and carried weights through both packages: masked
BatchNorm (outputs and running stats ≤1e-5; a padded step equals the
unpadded one ≤1e-6), one residual train step (loss ≤1e-5 relative, every
grad ≤1e-3 max-relative, BN stats ≤1e-5) and eval step (confusion counts
exact), the optimizer on identical grads against optax (≤1e-6 relative,
across a warm restart), the schedule, loss and class weights, the shard
loader's batches (identical), checkpoints both ways through the reference
`.pt`, and `train()` on a shard corpus and on a data directory (the decode
path), whose resumes must reproduce the uninterrupted runs bit for bit. On
the decode path the loader shifts each clip at crop time and the device
does not shift it again; its first step from a decoded batch matches the
JAX package's loss and grads (≤1e-3).
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cough_detector_tpu.config import TrainConfig as JaxTrainConfig
from cough_detector_tpu.config import default_config as jax_default_config
from cough_detector_tpu.data.datasets import BatchLoader as JaxBatchLoader
from cough_detector_tpu.data.datasets import CoughDataset as JaxCoughDataset
from cough_detector_tpu.data.shards import ShardLoader as JaxShardLoader
from cough_detector_tpu.models import convert as jax_convert
from cough_detector_tpu.models import create_model as jax_create_model
from cough_detector_tpu.models.layers import BatchNorm as JaxBatchNorm
from cough_detector_tpu.ops import frontend as jax_frontend
from cough_detector_tpu.train import checkpoint as jax_ckpt
from cough_detector_tpu.train import schedule as jax_schedule
from cough_detector_tpu.train import steps as jax_steps
from cough_detector_tpu_torch.config import Config, ModelConfig, TrainConfig, default_config
from cough_detector_tpu_torch.data import BatchLoader, CoughDataset, ShardLoader, audio_io, pack_arrays, synth
from cough_detector_tpu_torch.models import create_model, from_jax_variables
from cough_detector_tpu_torch.models.layers import BatchNorm
from cough_detector_tpu_torch.stream import StreamingDetector
from cough_detector_tpu_torch.train import (
    StepRandom,
    checkpoint,
    compute_class_weights,
    cosine_warm_restarts_lr,
    eval_step,
    loss_and_grads,
    make_epoch_schedule,
    make_optimizer,
    train,
    train_step,
    weighted_cross_entropy,
)
from cough_detector_tpu_torch.train import loop
from cough_detector_tpu_torch.train import steps as steps_mod
from test_torch_models import one_torch_thread, randomized_jax_variables  # noqa: F401

# The keys of the JAX loop's per-epoch record (train/loop.py epoch_tail),
# with the logger's "t".
RECORD_KEYS = {
    "epoch", "train_loss", "train_acc", "val_loss", "val_acc", "precision",
    "recall", "f1", "tp", "fp", "fn", "tn", "train_clips_per_sec",
    "val_clips_per_sec", "wall_s", "t",
}


def _max_rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-12))


def _check_grads(model, grads, want, tol) -> int:
    """Each grad within `tol` of its own largest element, except the conv
    biases: every conv of these models feeds a BatchNorm, whose batch mean
    removes a per-channel constant, so in train mode their exact gradient
    is 0 and what both sides compute is rounding; their difference must
    stay within `tol` of the model's largest grad."""
    named = dict(model.named_parameters())
    scale = max(float(np.abs(np.asarray(want[n])).max()) for n in named)
    assert len(named) == len(grads)
    for (name, p), g in zip(named.items(), grads):
        g, w = np.asarray(g), np.asarray(want[name])
        if name.endswith(".bias") and named[name[: -len("bias")] + "weight"].ndim == 4:
            assert np.abs(g - w).max() < tol * scale, name
        else:
            assert _max_rel(g, w) < tol, name
    return len(named)


# -- masked BatchNorm ----------------------------------------------------------


def _bn_pair(c: int, seed: int):
    """A JAX BatchNorm's variables and the port's BatchNorm with the same
    randomized scale, bias and running stats."""
    rng = np.random.default_rng(seed)
    scale, bias = rng.normal(1, 0.2, c), rng.normal(0, 0.2, c)
    mean, var = rng.normal(0, 0.5, c), rng.uniform(0.5, 2, c)
    f32 = lambda a: np.asarray(a, np.float32)  # noqa: E731
    jvars = {
        "params": {"scale": f32(scale), "bias": f32(bias)},
        "batch_stats": {"mean": f32(mean), "var": f32(var)},
    }
    bn = BatchNorm(c)
    bn.load_state_dict({
        "weight": torch.from_numpy(f32(scale)), "bias": torch.from_numpy(f32(bias)),
        "running_mean": torch.from_numpy(f32(mean)), "running_var": torch.from_numpy(f32(var)),
        "num_batches_tracked": torch.tensor(0),
    })
    return jvars, bn.train()


@pytest.mark.parametrize("masked", [False, True])
def test_batchnorm_train_mode_matches_jax(masked):
    x = np.random.default_rng(0).normal(0.3, 1.5, (8, 6, 5, 7)).astype(np.float32)
    mask = np.array([1, 1, 0, 1, 1, 1, 0, 1], np.float32) if masked else None
    jvars, bn = _bn_pair(6, 1)
    out_j, mut = JaxBatchNorm().apply(
        jvars, jnp.asarray(x.transpose(0, 2, 3, 1)), train=True,
        mask=None if mask is None else jnp.asarray(mask), mutable=["batch_stats"],
    )
    out = bn(torch.from_numpy(x), None if mask is None else torch.from_numpy(mask))
    real = slice(None) if mask is None else mask > 0
    assert _max_rel(out.detach().numpy()[real], np.asarray(out_j).transpose(0, 3, 1, 2)[real]) < 1e-5
    np.testing.assert_allclose(bn.running_mean.numpy(), mut["batch_stats"]["mean"], atol=1e-5)
    np.testing.assert_allclose(bn.running_var.numpy(), mut["batch_stats"]["var"], atol=1e-5)


def test_padded_step_equals_the_unpadded_step():
    """6 real rows and 2 padded rows under a mask: loss, every grad and
    every running stat of the residual model equal the 6-row step's under
    the same (all-ones) mask within 1e-6. The masked formula and torch's
    own batch norm (what an unmasked step runs) agree within 1e-5."""
    variables = randomized_jax_variables("residual", seed=2)
    rng = np.random.default_rng(3)
    feats = torch.from_numpy(rng.standard_normal((8, 90, 101)).astype(np.float32))
    feats[6:] = 100.0  # padding garbage that must not leak into the real rows
    labels = torch.tensor([0, 1, 1, 0, 1, 0, 1, 1])
    cw = torch.tensor([0.8, 1.7])
    mask = torch.tensor([1, 1, 1, 1, 1, 1, 0, 0], dtype=torch.float32)
    results = []
    for x, y, m in ((feats, labels, mask), (feats[:6], labels[:6], mask[:6]), (feats[:6], labels[:6], None)):
        model = create_model("residual", dropout=0.0)
        model.load_state_dict(from_jax_variables(variables, "residual"))
        loss, _, grads = loss_and_grads(model, x, y, cw, mask=m)
        stats = [b for k, b in model.state_dict().items() if "running" in k]
        results.append((loss, grads, stats))
    names = [n for n, _ in model.named_parameters()]
    for (loss_a, grads_a, stats_a), (loss_b, grads_b, stats_b), tol in (
        (results[0], results[1], 1e-6), (results[1], results[2], 1e-5),
    ):
        assert _max_rel(loss_a, loss_b) < tol
        assert _check_grads(model, grads_a, dict(zip(names, grads_b)), tol) == 30
        for sa, sb in zip(stats_a, stats_b):
            np.testing.assert_allclose(sa.numpy(), sb.numpy(), atol=tol)


def test_fully_padded_batch_leaves_running_stats_unchanged():
    _, bn = _bn_pair(4, 5)
    before = {k: v.clone() for k, v in bn.state_dict().items()}
    bn(torch.randn(3, 4, 5, 5), torch.zeros(3))
    for k, v in bn.state_dict().items():
        assert torch.equal(v, before[k]), k


# -- one step of the residual model ----------------------------------------------


@pytest.fixture(scope="module")
def residual_step():
    """A residual model (dropout 0, carried weights), one feature batch, and
    the JAX side's state after one train_step, its metrics and its grads."""
    variables = randomized_jax_variables("residual", seed=4)
    rng = np.random.default_rng(5)
    feats = rng.standard_normal((8, 90, 101)).astype(np.float32)
    labels = np.array([0, 1, 1, 0, 1, 0, 0, 1], np.int32)
    cw = np.array([0.8, 1.7], np.float32)
    jmodel = jax_create_model("residual", dropout=0.0)
    state = jax_steps.create_train_state(
        jmodel, variables, jax_steps.make_optimizer(JaxTrainConfig(), 10)
    )
    key = jax.random.PRNGKey(0)
    new_state, metrics = jax.jit(jax_steps.train_step)(state, feats, labels, key, cw)

    def loss_fn(params):
        logits, _ = jmodel.apply(
            {"params": params, "batch_stats": variables["batch_stats"]}, feats,
            train=True, mutable=["batch_stats"], rngs={"dropout": key},
        )
        return jax_steps.weighted_cross_entropy(logits, labels, cw)

    grads = jax.jit(jax.grad(loss_fn))(variables["params"])
    return dict(
        variables=variables, feats=feats, labels=labels, cw=cw, state=state,
        new_state=new_state, metrics=metrics, grads=grads,
    )


def _port_model(variables, model_type="residual"):
    model = create_model(model_type, dropout=0.0)
    model.load_state_dict(from_jax_variables(variables, model_type))
    return model


def test_train_step_matches_jax(residual_step):
    r = residual_step
    model = _port_model(r["variables"])
    opt = make_optimizer(model.parameters(), TrainConfig(), 10)
    m = train_step(
        model, opt, torch.from_numpy(r["feats"]), torch.from_numpy(r["labels"]).long(),
        torch.from_numpy(r["cw"]), StepRandom("cpu").key(0, 0, 0),
    )
    assert _max_rel(m["loss"], r["metrics"]["loss"]) < 1e-5
    assert int(m["count"]) == int(r["metrics"]["count"]) == 8
    assert int(m["correct"]) == int(r["metrics"]["correct"])
    want = jax_convert.variables_to_torch_state_dict(
        jax.tree_util.tree_map(np.asarray, r["new_state"].variables), "residual"
    )
    checked = 0
    for k, v in model.state_dict().items():
        if "running" in k:
            np.testing.assert_allclose(v.numpy(), want[k], atol=1e-5, err_msg=k)
            checked += 1
    assert checked == 14


def test_grads_match_jax(residual_step):
    r = residual_step
    model = _port_model(r["variables"])
    loss, _, grads = loss_and_grads(
        model, torch.from_numpy(r["feats"]), torch.from_numpy(r["labels"]).long(),
        torch.from_numpy(r["cw"]),
    )
    assert _max_rel(loss, r["metrics"]["loss"]) < 1e-5
    want = jax_convert.variables_to_torch_state_dict(
        jax.tree_util.tree_map(
            np.asarray, {"params": r["grads"], "batch_stats": r["variables"]["batch_stats"]}
        ),
        "residual",
    )
    assert _check_grads(model, grads, want, 1e-3) == 30


def test_eval_step_matches_jax(residual_step):
    r = residual_step
    mask = np.array([1, 1, 1, 1, 1, 0, 1, 0], np.float32)
    want = jax_steps.eval_step(r["state"], r["feats"], r["labels"], r["cw"], mask=mask)
    got = eval_step(
        _port_model(r["variables"]), torch.from_numpy(r["feats"]),
        torch.from_numpy(r["labels"]).long(), torch.from_numpy(r["cw"]),
        mask=torch.from_numpy(mask),
    )
    assert _max_rel(got["loss"], want["loss"]) < 1e-5
    for k in ("correct", "count", "tp", "fp", "fn", "tn"):
        assert int(got[k]) == int(want[k]), k


@pytest.mark.parametrize("model_type", ["standard", "small"])
def test_other_models_train(model_type):
    """Their dropout is fixed in the reference, so no JAX comparison: five
    steps on one batch, with dropout from the step's generator, lower the
    loss."""
    torch.manual_seed(0)
    model = create_model(model_type)
    opt = make_optimizer(model.parameters(), TrainConfig(learning_rate=1e-3), 5)
    rng = np.random.default_rng(6)
    feats = torch.from_numpy(rng.standard_normal((8, 90, 101)).astype(np.float32))
    labels = torch.tensor([0, 1, 0, 1, 1, 0, 1, 0])
    losses = [
        float(train_step(
            model, opt, feats, labels, torch.tensor([1.0, 1.0]), StepRandom("cpu").key(0, 0, s),
        )["loss"])
        for s in range(5)
    ]
    assert np.isfinite(losses).all() and losses[-1] < losses[0], losses


# -- optimizer, schedule, loss, class weights ---------------------------------


def test_optimizer_matches_optax_on_identical_grads():
    """clip + AdamW + schedule over 7 steps at 3 steps an epoch with T0 = 1
    (restarts after epochs 0 and 2), with grad norms on both sides of the
    clip."""
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
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    opt = make_optimizer(list(tp.values()), TrainConfig(sched_t0=1), 3)
    for g in grads:
        updates, opt_state = tx.update(g, opt_state, jp)
        jp = jax.tree_util.tree_map(lambda p, u: p + u, jp, updates)
        opt.step([torch.from_numpy(g[k]) for k in tp])
    assert opt.count == 7
    for k in shapes:
        assert _max_rel(tp[k], jp[k]) < 1e-6, k


@pytest.mark.parametrize("t0,t_mult", [(10, 2), (1, 2), (3, 1)])
def test_schedule_matches_jax_and_torch(t0, t_mult):
    for e in range(60):
        assert cosine_warm_restarts_lr(e, 5e-4, t0, t_mult) == jax_schedule.cosine_warm_restarts_lr(
            e, 5e-4, t0, t_mult
        )
    ours = make_epoch_schedule(5e-4, 7, t0, t_mult)
    theirs = jax_schedule.make_epoch_schedule(5e-4, 7, t0, t_mult)
    steps = np.arange(300)
    np.testing.assert_array_equal(
        np.array([ours(s) for s in steps], np.float32), np.asarray(theirs(jnp.asarray(steps)))
    )
    # The reference's own scheduler, stepped once per epoch.
    opt = torch.optim.SGD([torch.zeros(1, requires_grad=True)], lr=5e-4)
    sched = torch.optim.lr_scheduler.CosineAnnealingWarmRestarts(
        opt, T_0=t0, T_mult=t_mult, eta_min=1e-6
    )
    for e in range(60):
        assert cosine_warm_restarts_lr(e, 5e-4, t0, t_mult) == pytest.approx(
            opt.param_groups[0]["lr"], rel=1e-9
        )
        sched.step()


@pytest.mark.parametrize("kind", ["hard", "soft", "masked"])
def test_weighted_cross_entropy_matches_jax(kind):
    rng = np.random.default_rng(8)
    logits = rng.normal(0, 2, (8, 2)).astype(np.float32)
    labels = rng.integers(0, 2, 8).astype(np.int32)
    cw = np.array([0.7, 2.3], np.float32)
    mask = np.array([1, 1, 0, 1, 1, 1, 0, 1], np.float32) if kind == "masked" else None
    soft = None
    if kind == "soft":
        lam = rng.uniform(0, 1, (8, 1)).astype(np.float32)
        soft = np.concatenate([lam, 1 - lam], axis=1)
    want = jax_steps.weighted_cross_entropy(
        logits, labels, cw, None if mask is None else jnp.asarray(mask),
        soft_labels=None if soft is None else jnp.asarray(soft),
    )
    got = weighted_cross_entropy(
        torch.from_numpy(logits), torch.from_numpy(labels).long(), torch.from_numpy(cw),
        None if mask is None else torch.from_numpy(mask),
        None if soft is None else torch.from_numpy(soft),
    )
    assert abs(float(got) - float(want)) <= 1e-6 * abs(float(want))


@pytest.mark.parametrize("counts", [{0: 100, 1: 10}, {0: 1000, 1: 10}, {0: 5, 1: 50}, {}])
def test_class_weights_match_jax(counts):
    assert compute_class_weights(counts) == jax_steps.compute_class_weights(counts)


# -- shard loader ------------------------------------------------------------------


def _corpus(n: int, seed: int):
    """n 1 s clips, coughs at every third row, and their labels."""
    labels = (np.arange(n) % 3 == 0).astype(np.int64)
    waves = np.stack([
        synth.synthetic_cough(seed + i, 1.0) if labels[i] else synth.synthetic_non_cough(seed + i, 1.0)
        for i in range(n)
    ])
    return waves, labels


@pytest.fixture(scope="module")
def shard_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("shards")
    pack_arrays(*_corpus(64, 0), str(root / "train"), shard_size=24)
    pack_arrays(*_corpus(20, 500), str(root / "val"))
    return root


@pytest.mark.parametrize("mode", [
    dict(weighted=True, drop_last=True), dict(shuffle=True), dict(),
])
def test_shard_loader_batches_match_jax(shard_dir, mode):
    ours = ShardLoader(str(shard_dir / "train"), 10, seed=3, **mode)
    theirs = JaxShardLoader(str(shard_dir / "train"), 10, seed=3, **mode)
    assert len(ours) == len(theirs) and ours.class_counts == theirs.class_counts
    for epoch in (0, 1):
        for a, b in zip(ours.epoch_batches(epoch), theirs.epoch_batches(epoch)):
            np.testing.assert_array_equal(a, b)
        ours.set_epoch(epoch)
        theirs.set_epoch(epoch)
        got, want = list(ours), list(theirs)
        assert len(got) == len(want) == len(ours)
        for (wa, la), (wb, lb) in zip(got, want):
            np.testing.assert_array_equal(wa, wb)
            np.testing.assert_array_equal(la, lb)
    np.testing.assert_array_equal(ours.corpus(), theirs.corpus())


# -- checkpoints ---------------------------------------------------------------------


def _trained_pair(model_type="small"):
    """A port model with randomized weights and an optimizer one step in."""
    model = create_model(model_type)
    model.load_state_dict(from_jax_variables(randomized_jax_variables(model_type, seed=9), model_type))
    opt = make_optimizer(model.parameters(), TrainConfig(), 4)
    opt.step([torch.randn_like(p) for p in model.parameters()])
    return model, opt


def test_checkpoint_round_trip_is_bit_exact(tmp_path):
    model, opt = _trained_pair()
    cfg = default_config("small")
    path = checkpoint.save_checkpoint(
        str(tmp_path), "latest_model", model, opt, 3, {"f1": 0.5, "tp": 2}, cfg,
        extra={"early_stop": {"best_loss": 0.4, "counter": 1}},
    )
    tree, epoch, metrics, config = checkpoint.load_checkpoint(path)
    assert (epoch, metrics, config) == (3, {"f1": 0.5, "tp": 2.0}, cfg)
    for k, v in model.state_dict().items():
        assert torch.equal(tree["model"][k], v), k
    state = opt.state_dict()
    assert tree["optimizer"]["count"] == state["count"] == tree["step"] == 1
    for a, b in zip(tree["optimizer"]["mu"] + tree["optimizer"]["nu"], state["mu"] + state["nu"]):
        assert torch.equal(a, b)
    meta = json.loads((tmp_path / "latest_model" / "meta.json").read_text())
    assert set(meta) == {"epoch", "metrics", "config", "config_full", "extra"}
    assert meta["extra"]["early_stop"] == {"best_loss": 0.4, "counter": 1}


def _logits(model, x):
    model.eval()
    with torch.no_grad():
        return model(torch.from_numpy(x)).numpy()


def test_exported_pt_loads_in_jax_and_back(tmp_path):
    model, _ = _trained_pair("residual")
    x = np.random.default_rng(10).standard_normal((4, 90, 101)).astype(np.float32)
    ours = tmp_path / "port.pt"
    checkpoint.export_torch_checkpoint(str(ours), model.state_dict(), default_config("residual"), 2, {"f1": 0.7})
    variables, jcfg, epoch, metrics = jax_ckpt.import_torch_checkpoint(str(ours))
    assert (jcfg.model.model_type, epoch, metrics) == ("residual", 2, {"f1": 0.7})
    want = np.asarray(jax_create_model("residual").apply(variables, x))
    assert _max_rel(want, _logits(model, x)) < 1e-3

    jax_vars = randomized_jax_variables("small", seed=11)
    theirs = tmp_path / "jax.pt"
    jax_ckpt.export_torch_checkpoint(str(theirs), jax_vars, jax_default_config("small"), 4)
    state_dict, config, epoch, _ = checkpoint.import_torch_checkpoint(str(theirs))
    assert (config.model.model_type, epoch) == ("small", 4)
    port = create_model("small")
    port.load_state_dict(state_dict)
    want = np.asarray(jax_create_model("small").apply(jax_vars, x))
    assert _max_rel(_logits(port, x), want) < 1e-3


# -- train() -------------------------------------------------------------------------


def _cfg(epochs: int, model_type: str = "residual") -> Config:
    return Config(
        model=ModelConfig(model_type=model_type),
        train=TrainConfig(batch_size=16, epochs=epochs, patience=50),
    )


def _records(out) -> list:
    return [json.loads(line) for line in (out / "metrics.jsonl").read_text().splitlines()]


def _final_state(out) -> dict:
    return checkpoint.load_checkpoint(str(out / "latest_model"))[0]


@pytest.fixture(scope="module")
def straight_run(shard_dir, tmp_path_factory):
    # One intra-op thread, as the tests that resume against this run use
    # (module fixtures start before the per-test thread pin): the CPU's
    # convolution reductions follow the thread count.
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        out = tmp_path_factory.mktemp("straight")
        best = train(None, str(out), config=_cfg(2), shards_dir=str(shard_dir), device="cpu")
    finally:
        torch.set_num_threads(n)
    return out, best


def test_train_from_shards_writes_the_jax_records(straight_run):
    out, best = straight_run
    recs = _records(out)
    assert [r["epoch"] for r in recs] == [0, 1]
    for r in recs:
        assert set(r) == RECORD_KEYS
        assert np.isfinite([r["train_loss"], r["val_loss"]]).all()
        assert r["tp"] + r["fp"] + r["fn"] + r["tn"] == 20
    assert best == str(out / "best_model")
    for name in ("best_model", "latest_model"):
        assert (out / name / "state.pt").exists() and (out / name / "meta.json").exists()
    assert json.loads((out / "config.json").read_text())["model"]["model_type"] == "residual"


def _assert_same_run(out_a, out_b):
    a, b = _final_state(out_a), _final_state(out_b)
    for k, v in a["model"].items():
        assert torch.equal(b["model"][k], v), k
    for x, y in zip(a["optimizer"]["mu"] + a["optimizer"]["nu"], b["optimizer"]["mu"] + b["optimizer"]["nu"]):
        assert torch.equal(x, y)
    skip = {"train_clips_per_sec", "val_clips_per_sec", "wall_s", "t"}
    for ra, rb in zip(_records(out_a), _records(out_b)):
        assert {k: v for k, v in ra.items() if k not in skip} == {
            k: v for k, v in rb.items() if k not in skip
        }


def test_resume_reproduces_the_uninterrupted_run(straight_run, shard_dir, tmp_path):
    out_a, _ = straight_run
    out_b = tmp_path / "resumed"
    train(None, str(out_b), config=_cfg(1), shards_dir=str(shard_dir), device="cpu")
    train(
        None, str(out_b), config=_cfg(2), shards_dir=str(shard_dir), device="cpu",
        resume=str(out_b / "latest_model"),
    )
    assert [r["epoch"] for r in _records(out_b)] == [0, 1]
    _assert_same_run(out_a, out_b)


def test_streamed_batches_give_the_resident_run(shard_dir, tmp_path):
    runs = []
    for mode in (True, False):
        out = tmp_path / str(mode)
        train(None, str(out), config=_cfg(1), shards_dir=str(shard_dir), device="cpu",
              device_corpus=mode)
        runs.append(out)
    _assert_same_run(*runs)


def test_chunked_windows_give_the_resident_run(straight_run, shard_dir, tmp_path):
    """Windows of 1 step (a budget of 1.1 MB: 4 train windows an epoch and
    2 val windows, each buffer holding only its rows, renumbered) reproduce
    the resident run bit for bit: parameters, moments and records
    (tests/test_shards.py's chunked-vs-resident guard, at bit equality)."""
    out = tmp_path / "chunked"
    train(None, str(out), config=_cfg(2), shards_dir=str(shard_dir), device="cpu",
          device_corpus="chunked", device_corpus_budget=1_100_000)
    _assert_same_run(straight_run[0], out)


def test_auto_picks_chunked_windows_past_the_budget(straight_run, shard_dir, tmp_path, capsys):
    """"auto" with a corpus past the budget runs chunked windows (2 steps
    each here), not the streamed loop, and still gives the resident run."""
    out = tmp_path / "auto"
    train(None, str(out), config=_cfg(2), shards_dir=str(shard_dir), device="cpu",
          device_corpus_budget=2_100_000)
    assert "Chunked device corpus" in capsys.readouterr().out
    _assert_same_run(straight_run[0], out)


def test_chunked_resume_through_the_background_writer_is_bit_exact(straight_run, shard_dir, tmp_path, monkeypatch):
    """One process writes every checkpoint on the background writer; a
    chunked run of 1 epoch resumed to 2 equals the resident run."""
    submitted = []
    real = checkpoint._submit
    monkeypatch.setattr(checkpoint, "_submit", lambda fn: submitted.append(1) or real(fn))
    out = tmp_path / "resumed"
    kw = dict(shards_dir=str(shard_dir), device="cpu", device_corpus="chunked", device_corpus_budget=1_100_000)
    train(None, str(out), config=_cfg(1), **kw)
    train(None, str(out), config=_cfg(2), resume=str(out / "latest_model"), **kw)
    assert len(submitted) >= 3  # best and latest at epoch 0, latest at 1
    _assert_same_run(straight_run[0], out)


def test_best_path_is_committed_when_train_returns(shard_dir, tmp_path, monkeypatch):
    """Slow background writes: train() returns only after they land, so
    the path it returns loads at once, and no writer thread outlives it."""
    import threading
    import time

    real = checkpoint._replace_into

    def slow(path, write):
        time.sleep(0.2)
        real(path, write)

    monkeypatch.setattr(checkpoint, "_replace_into", slow)
    best = train(None, str(tmp_path / "run"), config=_cfg(1, "small"), shards_dir=str(shard_dir), device="cpu")
    assert not list((tmp_path / "run").rglob("*.tmp"))
    assert not [t for t in threading.enumerate() if t.name.startswith("cdt-ckpt")]  # the writer stopped
    tree, epoch, _, config = checkpoint.load_checkpoint(best)
    assert epoch == 0 and config.model.model_type == "small" and tree["model"]


@pytest.mark.parametrize("save_fails", [False, True])
def test_a_failed_train_stops_the_writer_and_raises_its_own_error(save_fails, shard_dir, tmp_path, monkeypatch):
    """An error in epoch 1, after epoch 0's saves were queued: train()
    waits for them and stops the writer before the error leaves it, and a
    save that failed too is noted on the loop's error, not raised instead."""
    import threading
    import time

    real_replace, real_steps = checkpoint._replace_into, steps_mod.train_steps

    def slow(path, write):
        time.sleep(0.2)
        if save_fails:
            raise OSError("disk full")
        real_replace(path, write)

    def steps_then_fail(*args):
        if args[6] == 1:  # the epoch
            raise RuntimeError("step failed")
        return real_steps(*args)

    monkeypatch.setattr(checkpoint, "_replace_into", slow)
    monkeypatch.setattr(steps_mod, "train_steps", steps_then_fail)
    with pytest.raises(RuntimeError, match="step failed") as info:
        train(None, str(tmp_path / "run"), config=_cfg(2, "small"), shards_dir=str(shard_dir), device="cpu")
    assert not [t for t in threading.enumerate() if t.name.startswith("cdt-ckpt")]
    notes = getattr(info.value, "__notes__", [])
    if save_fails:
        assert len(notes) == 1 and "disk full" in notes[0]
    else:
        assert not notes and checkpoint.load_checkpoint(str(tmp_path / "run" / "latest_model"))[1] == 0


@pytest.mark.parametrize("kwargs", [
    dict(device_corpus="resident"),
    dict(device_corpus="chunked", shards_dir=None),
    dict(mesh=object()),
    dict(device_corpus=True, shards_dir=None),
])
def test_unported_modes_raise(shard_dir, tmp_path, kwargs):
    """Every corpus mode and data parallelism are ported now (the chunked
    and past-budget modes run in the tests below, several ranks in
    test_torch_parallel.py, meshes in test_torch_mesh_train.py); what still
    raises, before any work, is a request no placement satisfies: an
    unknown mode, a device corpus with no shards to put there, and a mesh
    of the wrong type (neither a Mesh, a device list, None nor False)."""
    args = dict(data_dir=None, shards_dir=str(shard_dir))
    args.update(kwargs)
    with pytest.raises(ValueError):
        train(output_dir=str(tmp_path / "out"), config=_cfg(1), device="cpu", **args)
    assert not (tmp_path / "out").exists()


def test_cli_trains_exports_and_serves(shard_dir, tmp_path):
    from cough_detector_tpu_torch.cli import train as cli

    out = tmp_path / "cli"
    cli.main([
        "--shards", str(shard_dir), "--output-dir", str(out), "--model-type", "small",
        "--epochs", "1", "--batch-size", "16", "--device", "cpu", "--export-pt", "--mixup",
    ])
    windows = _corpus(3, 900)[0]
    for path in (out / "best_model.pt", out / "best_model"):
        det = StreamingDetector(str(path), device="cpu")
        assert det.config.model.model_type == "small"
        p = det.scores_for(windows)
        assert p.shape == (3,) and np.isfinite(p).all()


# -- the decode path: train(data_dir=...) ---------------------------------------------


@pytest.fixture(scope="module")
def clip_dir(tmp_path_factory):
    """20 coughs and 20 non-coughs of 1.2 s, every fifth at 44.1 kHz."""
    root = tmp_path_factory.mktemp("clips")
    for label, gen in (("cough", synth.synthetic_cough), ("non_cough", synth.synthetic_non_cough)):
        (root / label).mkdir()
        for i in range(20):
            rate = 44100 if i % 5 == 4 else 16000
            audio_io.write_wav(root / label / f"{i:02d}.wav", gen(1000 + i, 1.2, rate), rate)
    return root


def _decode_cfg(epochs: int) -> Config:
    return Config(
        model=ModelConfig(model_type="small"),
        train=TrainConfig(batch_size=8, epochs=epochs, patience=50),
    )


def test_decode_path_step_matches_jax(clip_dir):
    """One residual step from identical weights on the first decoded batch
    (crop shifts on, augmentation on the device off): the batch equals
    the JAX loader's, the features its jnp chain's (1e-3), the loss and
    every grad JAX's from those features (1e-3)."""
    cfg = Config(model=ModelConfig(dropout=0.0), train=TrainConfig(p_augment=0.0))
    kw = dict(weighted=True, drop_last=True, seed=0, time_shift_limit=0.2, time_shift_prob=0.5, num_workers=2)
    waves, labels = next(iter(BatchLoader(CoughDataset(str(clip_dir)), 8, backend="python", **kw)))
    jwaves, jlabels = next(iter(JaxBatchLoader(JaxCoughDataset(str(clip_dir)), 8, backend="python", **kw)))
    assert np.array_equal(waves, jwaves) and np.array_equal(labels, jlabels)

    train_features, _ = loop.make_feature_fns(cfg, torch.device("cpu"), use_time_shift=False)
    feats = train_features(torch.from_numpy(waves), torch.Generator().manual_seed(0))
    jfeats = np.asarray(jax_frontend.extract_features_fast(
        jax_frontend.peak_normalize(jnp.asarray(jwaves)), jax_default_config().features
    ))
    assert _max_rel(feats.numpy(), jfeats) < 1e-3

    variables = randomized_jax_variables("residual", seed=12)
    cw = np.array([1.0, 1.0], np.float32)
    jmodel = jax_create_model("residual", dropout=0.0)

    def loss_fn(params):
        logits, _ = jmodel.apply(
            {"params": params, "batch_stats": variables["batch_stats"]}, jfeats,
            train=True, mutable=["batch_stats"],
        )
        return jax_steps.weighted_cross_entropy(logits, jlabels, cw)

    jloss, jgrads = jax.jit(jax.value_and_grad(loss_fn))(variables["params"])
    model = _port_model(variables)
    loss, _, grads = loss_and_grads(model, feats, torch.from_numpy(labels).long(), torch.from_numpy(cw))
    assert _max_rel(loss, jloss) < 1e-3
    want = jax_convert.variables_to_torch_state_dict(
        jax.tree_util.tree_map(np.asarray, {"params": jgrads, "batch_stats": variables["batch_stats"]}),
        "residual",
    )
    assert _check_grads(model, grads, want, 1e-3) == 30


def test_make_feature_fns_takes_the_shift_from_the_caller():
    """Decoded batches were shifted at crop time: their feature function
    must not shift again; shard batches are shifted on the device."""
    cfg = Config(train=TrainConfig(p_augment=1.0))
    waves = torch.from_numpy(synth.fixture_batch(n_clips=4, seed=2).astype(np.float32))
    feats = {}
    for shift in (False, True):
        fn, _ = loop.make_feature_fns(cfg, torch.device("cpu"), use_time_shift=shift)
        feats[shift] = fn(waves, torch.Generator().manual_seed(3))
    g = torch.Generator().manual_seed(3)
    from cough_detector_tpu_torch.augment import augment_waveforms, spec_augment
    from cough_detector_tpu_torch.ops import frontend

    aug = augment_waveforms(waves, g, p=1.0, use_time_shift=False)
    want = spec_augment(
        frontend.extract_features(frontend.peak_normalize(aug), cfg.features), g, p=1.0,
        freq_mask_param=cfg.train.freq_mask_param, time_mask_param=cfg.train.time_mask_param,
        n_freq_masks=cfg.train.n_freq_masks, n_time_masks=cfg.train.n_time_masks,
    )
    assert torch.equal(feats[False], want) and not torch.equal(feats[True], want)


def test_train_shifts_decoded_batches_at_crop_time_only(clip_dir, shard_dir, tmp_path, monkeypatch):
    seen = []
    real = loop.augment_waveforms

    def spy(*args, **kwargs):
        seen.append(kwargs["use_time_shift"])
        return real(*args, **kwargs)

    monkeypatch.setattr(loop, "augment_waveforms", spy)
    train(str(clip_dir), str(tmp_path / "decode"), config=_decode_cfg(1), num_workers=2, device="cpu")
    assert seen and not any(seen)
    seen.clear()
    train(None, str(tmp_path / "shards"), config=_decode_cfg(1), shards_dir=str(shard_dir), device="cpu")
    assert seen and all(seen)


@pytest.fixture(scope="module")
def decode_run(clip_dir, tmp_path_factory):
    n = torch.get_num_threads()
    torch.set_num_threads(1)  # as the resumed run's test pins it
    try:
        out = tmp_path_factory.mktemp("decode_straight")
        train(str(clip_dir), str(out), config=_decode_cfg(3), num_workers=2, device="cpu")
    finally:
        torch.set_num_threads(n)
    return out


def test_train_from_a_data_dir_writes_the_jax_records(decode_run):
    recs = _records(decode_run)
    assert [r["epoch"] for r in recs] == [0, 1, 2]
    for r in recs:
        assert set(r) == RECORD_KEYS
        assert np.isfinite([r["train_loss"], r["val_loss"]]).all()
        assert r["tp"] + r["fp"] + r["fn"] + r["tn"] == 8  # the 20% split of 40 clips


def test_decode_path_resume_reproduces_the_uninterrupted_run(decode_run, clip_dir, tmp_path):
    out = tmp_path / "resumed"
    train(str(clip_dir), str(out), config=_decode_cfg(2), num_workers=2, device="cpu")
    train(str(clip_dir), str(out), config=_decode_cfg(3), num_workers=3, device="cpu",
          resume=str(out / "latest_model"))
    assert [r["epoch"] for r in _records(out)] == [0, 1, 2]
    _assert_same_run(decode_run, out)


def test_decode_path_input_errors(clip_dir, tmp_path):
    with pytest.raises(ValueError, match="No training data"):
        train(str(tmp_path / "nowhere"), str(tmp_path / "o"), config=_decode_cfg(1), device="cpu")
    with pytest.raises(ValueError, match="shards_dir"):
        train(str(clip_dir), str(tmp_path / "o"), config=_decode_cfg(1), device="cpu", device_corpus=True)


def test_deterministic_sets_the_flags_without_importing_inductor():
    """loop.deterministic on a card: deterministic algorithms and cuDNN's
    deterministic, non-benchmarked convolutions for the duration, warn_only
    and every flag restored after, and torch._inductor (with dynamo, sympy
    and triton, ~8 s of a fresh rank's start) never imported. Run in a fresh
    interpreter, since the flags set no device state: it needs no card."""
    import subprocess
    import sys
    from pathlib import Path

    code = r'''
import sys, torch
from cough_detector_tpu_torch.train.loop import deterministic
cudnn, fill = torch.backends.cudnn, torch.utils.deterministic
torch._C._set_deterministic_algorithms(False, warn_only=True)  # the flag alone: no inductor import
cudnn.deterministic, cudnn.benchmark = False, True
before = (torch.are_deterministic_algorithms_enabled(), torch.is_deterministic_algorithms_warn_only_enabled(),
          cudnn.deterministic, cudnn.benchmark, fill.fill_uninitialized_memory)
with deterministic(torch.device("cuda")):
    inside = (torch.are_deterministic_algorithms_enabled(), torch.is_deterministic_algorithms_warn_only_enabled(),
              cudnn.deterministic, cudnn.benchmark, fill.fill_uninitialized_memory)
after = (torch.are_deterministic_algorithms_enabled(), torch.is_deterministic_algorithms_warn_only_enabled(),
         cudnn.deterministic, cudnn.benchmark, fill.fill_uninitialized_memory)
print(before, inside, after, "torch._inductor" in sys.modules)
'''
    repo = Path(__file__).resolve().parents[1]
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, cwd=repo, check=True,
                         env={**__import__("os").environ, "PYTHONPATH": str(repo)}).stdout.split("\n")[0]
    before = "(False, True, False, True, True)"
    assert out == f"{before} (True, False, True, False, False) {before} False", out
