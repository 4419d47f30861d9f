"""PyTorch port's serving export, export CLI and observability helpers, on
the CPU.

The `.pt2` written by `models/export.py` (torch.export of peak normalize →
front end → classifier → softmax) is loaded back and must equal the eager
serving function within 1e-6; the front end's launches are custom ops
(`cdt::power_mel`, `cdt::mel_epilogue`, `cdt::spectral_contrast`) whose fake implementations give
the real shapes (torch.library.opcheck) and which a traced program calls.
`cli.export --pt` writes a reference `.pt` that the JAX package's
`import_torch_checkpoint` loads to the same logits within 1e-3.
"""

import json
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cough_detector_tpu.models import model_from_config as jax_model_from_config
from cough_detector_tpu.train.checkpoint import import_torch_checkpoint as jax_import
from cough_detector_tpu_torch.cli import export as export_cli
from cough_detector_tpu_torch.config import Config, FeatureConfig, default_config
from cough_detector_tpu_torch.models import create_model, fold_batchnorm, init_weights
from cough_detector_tpu_torch.models import export
from cough_detector_tpu_torch.ops import frontend, frontend_kernel
from cough_detector_tpu_torch.train.checkpoint import export_torch_checkpoint
from cough_detector_tpu_torch.utils.observability import Throughput, capture_trace, trace_span
from test_torch_frontend import _clips
from test_torch_models import one_torch_thread  # noqa: F401

CONFIGS = {
    "shipped": default_config("residual"),
    "contrast": Config(features=FeatureConfig(use_spectral_contrast=True)),
}


def _weights() -> dict:
    """Residual weights from a seed, with randomized BatchNorm statistics."""
    model = init_weights(create_model("residual"), torch.Generator().manual_seed(3))
    gen = torch.Generator().manual_seed(4)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.normal_(0.0, 0.3, generator=gen)
                m.running_var.uniform_(0.5, 2.0, generator=gen)
    return model.state_dict()


@pytest.fixture(scope="module")
def weights():
    return _weights()


@pytest.fixture(scope="module")
def ckpt(weights, tmp_path_factory):
    """Per config name, a reference `.pt` of the weights."""
    root = tmp_path_factory.mktemp("export_ckpt")
    out = {}
    for name, cfg in CONFIGS.items():
        out[name] = root / f"{name}.pt"
        export_torch_checkpoint(str(out[name]), weights, cfg)
    return out


@pytest.mark.parametrize("name", list(CONFIGS))
def test_pt2_round_trip_equals_eager(weights, tmp_path, name):
    cfg = CONFIGS[name]
    fn = export.make_serving_fn(weights, cfg, "cpu")
    program = export.aot_compile(fn, 4, cfg.features.segment_samples)
    path = export.export_serialized(program, str(tmp_path / "serving.pt2"))
    loaded = export.load_serialized(path)
    w = torch.from_numpy(_clips(4, seed=11))
    with torch.no_grad():
        got, want = loaded(w), fn(w)
    assert got.shape == (4, 2)
    np.testing.assert_allclose(got.sum(-1).numpy(), 1.0, atol=1e-5)
    assert float((got - want).abs().max()) <= 1e-6


@pytest.mark.parametrize("name", list(CONFIGS))
def test_traced_launcher_calls_the_custom_ops(tmp_path, name):
    """A traced extract_features_fused holds its launches as custom-op
    nodes (the pair's two, and the contrast launch's on a contrast
    config), and the loaded program runs the same wrappers: on CPU tensors
    their plain versions, equal to the eager launcher."""
    fcfg = CONFIGS[name].features

    class Fused(torch.nn.Module):
        def forward(self, w):
            return frontend_kernel.extract_features_fused(w, fcfg)

    w = torch.from_numpy(_clips(3, seed=12))
    program = torch.export.export(Fused(), (w,))
    ops = [str(n.target) for n in program.graph.nodes if "cdt" in str(n.target)]
    contrast = ["cdt.spectral_contrast.default"] if fcfg.use_spectral_contrast else []
    assert ops == ["cdt.power_mel.default", "cdt.mel_epilogue.default"] + contrast
    torch.export.save(program, str(tmp_path / "fused.pt2"))
    loaded = export.load_serialized(str(tmp_path / "fused.pt2"))
    got = loaded(w)
    assert got.shape == (3, fcfg.num_features, fcfg.num_frames)
    np.testing.assert_array_equal(got.numpy(), frontend_kernel.extract_features_fused(w, fcfg).numpy())


def test_custom_op_fakes_give_the_real_shapes():
    """torch.library.opcheck runs each op's fake implementation beside the
    real one (here, on CPU tensors, the plain version) and checks the
    schema and the output metadata."""
    cfg = FeatureConfig(use_delta_delta=True)
    args = frontend_kernel._op_args(cfg)
    w = torch.from_numpy(_clips(2, seed=13))
    mel = torch.ops.cdt.power_mel(w, *args)
    assert mel.shape == (2, cfg.n_mels, cfg.num_frames)
    torch.library.opcheck(torch.ops.cdt.power_mel.default, (w, *args))
    torch.library.opcheck(torch.ops.cdt.mel_epilogue.default, (mel, *args))
    feats = torch.ops.cdt.mel_epilogue(mel, *args)
    np.testing.assert_array_equal(feats.numpy(), frontend_kernel.extract_features_fused(w, cfg).numpy())


def test_graph_text_names_the_program(weights):
    program = export.aot_compile(export.make_serving_fn(weights, CONFIGS["shipped"], "cpu"), 2)
    text = export.graph_text(program)
    assert "def forward" in text and "softmax" in text


def test_device_cache_is_bypassed_while_tracing(weights):
    """Constant tensors built while torch traces belong to the trace; the
    cache keeps the eager ones, so eager calls after an export still get
    real tensors."""
    cfg = CONFIGS["contrast"]
    w = torch.from_numpy(_clips(2, seed=14))
    eager = frontend.extract_features(w, cfg.features)
    export.aot_compile(export.make_serving_fn(weights, cfg, "cpu"), 2)
    np.testing.assert_array_equal(frontend.extract_features(w, cfg.features).numpy(), eager.numpy())


@pytest.mark.parametrize("name", list(CONFIGS))
def test_export_cli_pt_loads_into_jax(ckpt, tmp_path, capsys, name):
    """--pt --fold-bn: the reference `.pt` the CLI writes holds the folded
    weights; the JAX package loads it and its logits on the port's
    features equal the port's unfolded model's within 1e-3."""
    out = tmp_path / "out"
    export_cli.main(["--model", str(ckpt[name]), "--output-dir", str(out), "--pt", "--fold-bn"])
    printed = capsys.readouterr().out
    assert "BatchNorm folded" in printed and "model.pt" in printed
    variables, jcfg, _, _ = jax_import(str(out / "model.pt"))
    assert jcfg.features.use_spectral_contrast == (name == "contrast")
    cfg = CONFIGS[name]
    w = torch.from_numpy(_clips(4, seed=15))
    feats = frontend.extract_features(frontend.peak_normalize(w), cfg.features)
    jax_logits = np.asarray(
        jax_model_from_config(jcfg.model).apply(variables, jnp.asarray(feats.numpy()), train=False)
    )
    from cough_detector_tpu_torch.stream.detector import _load_checkpoint

    state, _ = _load_checkpoint(str(ckpt[name]))
    model = export.make_serving_fn(state, cfg, "cpu").model
    with torch.no_grad():
        logits = model(feats).numpy()
    assert float(np.abs(jax_logits - logits).max() / np.abs(logits).max()) < 1e-3
    folded = fold_batchnorm(state, "residual")
    saved = torch.load(out / "model.pt", weights_only=True)["model_state_dict"]
    assert all(torch.equal(saved[k], v) for k, v in folded.items())


def test_export_cli_program(ckpt, tmp_path, capsys):
    out = tmp_path / "prog"
    export_cli.main([
        "--model", str(ckpt["shipped"]), "--output-dir", str(out), "--program",
        "--batch-size", "2", "--device", "cpu",
    ])
    assert "serving.pt2" in capsys.readouterr().out
    assert "def forward" in (out / "serving.graph.txt").read_text()
    loaded = export.load_serialized(str(out / "serving.pt2"))
    probs = loaded(torch.from_numpy(_clips(2, seed=16)))
    assert probs.shape == (2, 2) and bool(torch.isfinite(probs).all())


def test_export_cli_needs_something_to_write(ckpt, tmp_path):
    with pytest.raises(SystemExit, match="Nothing to do"):
        export_cli.main(["--model", str(ckpt["shipped"]), "--output-dir", str(tmp_path)])


def test_throughput_discards_warmup():
    tp = Throughput(warmup=1)
    for n in (100, 10, 10):
        tp.start()
        time.sleep(0.01)
        tp.stop(n)
    assert 0 < tp.items_per_sec < 20 / 0.02
    with pytest.raises(RuntimeError):
        Throughput().stop(1)


def test_capture_trace_writes_a_trace_with_the_span(tmp_path):
    with capture_trace(str(tmp_path / "trace")):
        with trace_span("cdt.test_span"):
            torch.ones(8).sum()
    files = list((tmp_path / "trace").glob("*.json"))
    assert len(files) == 1
    names = {e.get("name") for e in json.loads(files[0].read_text())["traceEvents"]}
    assert "cdt.test_span" in names
