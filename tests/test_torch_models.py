"""PyTorch port's config and classifiers against the JAX package, on the CPU.

Weights are carried from a Flax `init_model` (with BatchNorm parameters and
running statistics randomized by numpy, so eval-mode BN is exercised) by
`from_jax_variables`; logits must match Flax `apply` within ≤1e-3
max-relative. Reference `.pt` state dicts (tests/torch_models.py) load with
`load_state_dict` and no conversion.
"""

import jax
import numpy as np
import pytest
import torch

import torch_models
from cough_detector_tpu.config import Config as JaxConfig
from cough_detector_tpu.config import ModelConfig as JaxModelConfig
from cough_detector_tpu.config import default_config as jax_default_config
from cough_detector_tpu.models import create_model as jax_create_model
from cough_detector_tpu.models import init_model
from cough_detector_tpu.models import model_from_config as jax_model_from_config
from cough_detector_tpu.models.fuse import fold_batchnorm as jax_fold_batchnorm
from cough_detector_tpu_torch.config import Config, ModelConfig, default_config
from cough_detector_tpu_torch.models import (
    count_parameters,
    create_model,
    fold_batchnorm,
    from_jax_variables,
    model_from_config,
    predict,
)

TOL = 1e-3
MODEL_TYPES = ["standard", "small", "residual"]


@pytest.fixture(autouse=True)
def one_torch_thread():
    """The port's tests use tiny tensors: one intra-op thread keeps them
    off the cores that timing-sensitive tests in other workers share."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def randomized_jax_variables(model_type: str, seed: int = 0) -> dict:
    """Flax variables with numpy-randomized BN scale/bias/mean/var."""
    # One jitted init: op-by-op Flax init costs seconds of compiles.
    variables = jax.jit(init_model, static_argnums=(0, 2))(
        jax_create_model(model_type), jax.random.PRNGKey(seed), (90, 101)
    )
    rng = np.random.default_rng(seed)

    def perturb(path, leaf):
        name = path[-1].key
        leaf = np.asarray(leaf)
        if name == "mean":
            return rng.normal(0.0, 0.5, leaf.shape).astype(np.float32)
        if name == "var":
            return rng.uniform(0.5, 2.0, leaf.shape).astype(np.float32)
        if name == "scale":
            return rng.normal(1.0, 0.2, leaf.shape).astype(np.float32)
        return leaf

    return jax.tree_util.tree_map_with_path(perturb, variables)


@pytest.mark.parametrize("model_type", MODEL_TYPES)
def test_logits_match_flax(model_type):
    variables = randomized_jax_variables(model_type, seed=1)
    x = np.random.default_rng(2).standard_normal((4, 90, 101)).astype(np.float32)
    want = np.asarray(
        jax.jit(jax_create_model(model_type).apply)(variables, x)
    )
    model = create_model(model_type)
    model.load_state_dict(from_jax_variables(variables, model_type))
    model.eval()
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
        got_nchw = model(torch.from_numpy(x[:, None])).numpy()
    assert np.abs(got - want).max() / np.abs(want).max() < TOL
    np.testing.assert_array_equal(got, got_nchw)


@pytest.mark.parametrize(
    "model_type, n", [("standard", 421954), ("small", 21122), ("residual", 290370)]
)
def test_parameter_counts(model_type, n):
    assert count_parameters(create_model(model_type)) == n


@pytest.mark.parametrize("model_type", MODEL_TYPES)
def test_reference_state_dict_loads(model_type):
    """A reference .pt model_state_dict loads strictly and gives the
    reference module's logits."""
    ref = torch_models.randomized(model_type, seed=3)
    model = create_model(model_type)
    model.load_state_dict(ref.state_dict())
    model.eval()
    x = torch.from_numpy(
        np.random.default_rng(4).standard_normal((2, 1, 90, 101)).astype(np.float32)
    )
    with torch.no_grad():
        torch.testing.assert_close(model(x), ref(x), rtol=0, atol=1e-6)


def test_missing_weight_raises_key_error():
    variables = randomized_jax_variables("small")
    del variables["params"]["sep2"]["pw"]["kernel"]
    with pytest.raises(KeyError, match="sep2/pw/kernel"):
        from_jax_variables(variables, "small")


def _compute_modes(model) -> dict:
    return {n: m.compute for n, m in model.named_modules() if hasattr(m, "compute")}


def test_model_from_config_refuses_unported_modes():
    """Unknown dtypes and precision modes raise; "serve" and bfloat16 set
    each layer's compute mode (the dense layers and skip projections stay
    float32 in "serve")."""
    with pytest.raises(ValueError):
        model_from_config(ModelConfig(compute_dtype="float16"))
    with pytest.raises(ValueError, match="precision_mode"):
        model_from_config(ModelConfig(), precision_mode="highest")
    model = model_from_config(ModelConfig(model_type="standard", dropout=0.25))
    assert model.fc[2].p == 0.25
    assert set(_compute_modes(model).values()) == {"fp32"}
    serve = _compute_modes(model_from_config(ModelConfig(model_type="residual"), "serve"))
    assert {n for n, c in serve.items() if c == "fp32"} == {
        "res_blocks.0.skip.0", "res_blocks.1.skip.0", "fc.2",
    }
    assert len(serve) == 8 and list(serve.values()).count("tf32") == 5
    bf16 = model_from_config(ModelConfig(model_type="small", compute_dtype="bfloat16"))
    assert set(_compute_modes(bf16).values()) == {"bf16"}
    assert all(p.dtype == torch.float32 for p in bf16.parameters())


def _ported(variables, model_type: str, **kw):
    model = model_from_config(ModelConfig(model_type=model_type, **kw.pop("config", {})), **kw)
    model.load_state_dict(from_jax_variables(variables, model_type))
    return model.eval()


def _logits(model, x: np.ndarray) -> np.ndarray:
    with torch.no_grad():
        out = model(torch.from_numpy(x))
    assert out.dtype == torch.float32
    return out.numpy()


def _max_rel(got, want) -> float:
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("model_type", MODEL_TYPES)
def test_fold_batchnorm_matches_jax(model_type):
    """The folded state dict equals the JAX package's folded variables
    (converted) array by array within 1e-6; folded logits equal the
    unfolded model's within 2e-4 max-relative (docs/PARITY.md)."""
    variables = randomized_jax_variables(model_type, seed=21)
    state = from_jax_variables(variables, model_type)
    before = {k: v.clone() for k, v in state.items()}
    folded = fold_batchnorm(state, model_type)
    want = from_jax_variables(jax_fold_batchnorm(variables, model_type), model_type)
    assert folded.keys() == want.keys()
    for k in want:
        assert folded[k].dtype == want[k].dtype, k
        torch.testing.assert_close(folded[k], want[k], rtol=0, atol=1e-6)
    assert all(torch.equal(state[k], v) for k, v in before.items())  # the input is left as it was
    x = np.random.default_rng(22).standard_normal((4, 90, 101)).astype(np.float32)
    model = _ported(variables, model_type)
    unfolded = _logits(model, x)
    model.load_state_dict(folded)
    assert _max_rel(_logits(model, x), unfolded) < 2e-4
    with pytest.raises(ValueError):
        fold_batchnorm(state, "tiny")


@pytest.mark.parametrize("model_type", MODEL_TYPES)
def test_serve_mode_matches_jax_serve(model_type):
    """precision_mode="serve" against the JAX package's: both are full
    float32 on a CPU (TF32 and the MXU's single pass exist only on the
    accelerators), held to the port's 1e-3 logits budget."""
    variables = randomized_jax_variables(model_type, seed=23)
    x = np.random.default_rng(24).standard_normal((4, 90, 101)).astype(np.float32)
    jmodel = jax_model_from_config(JaxModelConfig(model_type=model_type), precision_mode="serve")
    want = np.asarray(jax.jit(jmodel.apply)(variables, x))
    flags = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    got = _logits(_ported(variables, model_type, precision_mode="serve"), x)
    assert (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32) == flags
    assert _max_rel(got, want) < TOL


@pytest.mark.parametrize("model_type", MODEL_TYPES)
def test_bfloat16_compute_matches_jax_bfloat16(model_type):
    """compute_dtype="bfloat16": float32 parameters, bf16 convs and dense
    layers, float32 logits. The two packages round at different points
    (the port normalizes BatchNorm in float32), so they are held to 2e-2
    of max|logit| of each other, and each to 5e-2 of the float32 logits."""
    variables = randomized_jax_variables(model_type, seed=25)
    x = np.random.default_rng(26).standard_normal((4, 90, 101)).astype(np.float32)
    jmodel = jax_model_from_config(JaxModelConfig(model_type=model_type, compute_dtype="bfloat16"))
    want = np.asarray(jax.jit(jmodel.apply)(variables, x))
    assert want.dtype == np.float32
    got = _logits(_ported(variables, model_type, config={"compute_dtype": "bfloat16"}), x)
    assert _max_rel(got, want) < 2e-2
    exact = _logits(_ported(variables, model_type), x)
    assert _max_rel(got, exact) < 5e-2 and _max_rel(want, exact) < 5e-2
    assert not np.array_equal(got, exact)


def test_predict_softmax_argmax():
    model = create_model("small").eval()
    x = torch.from_numpy(
        np.random.default_rng(5).standard_normal((3, 90, 101)).astype(np.float32)
    )
    preds, probs = predict(model, x)
    assert probs.shape == (3, 2) and preds.shape == (3,)
    torch.testing.assert_close(probs.sum(dim=1), torch.ones(3))
    assert torch.equal(preds, probs.argmax(dim=1))


@pytest.mark.parametrize("model_type", MODEL_TYPES)
def test_config_json_identical(model_type):
    """Both packages write the same config JSON and flat dict, and read
    each other's."""
    ours, theirs = default_config(model_type), jax_default_config(model_type)
    assert ours.to_json() == theirs.to_json()
    assert ours.to_flat_dict() == theirs.to_flat_dict()
    assert Config.from_json(theirs.to_json()) == ours
    assert JaxConfig.from_json(ours.to_json()) == theirs
    flat = dict(theirs.to_flat_dict(), use_pcen=True, n_mels=32)
    assert Config.from_flat_dict(flat).to_json() == JaxConfig.from_flat_dict(flat).to_json()
