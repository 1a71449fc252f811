"""Port TimeSformer against the JAX TimeSformer (flat layout): same Flax
weights carried across by ``compat.flax_weights``, same inputs. Also its
preprocessing regime, three AdamW train steps and an eval step against the
JAX train step, the training CLI and ``Predictor.from_checkpoint``.

Tiny config: hidden 32, 2 layers, 2 heads, 4 frames, 32x32 (16 patches):
temporal N = 4 and spatial N = 17, both < 512, so the JAX pallas route takes
its short-sequence kernel (interpret mode here) and the port the short
twins. Weights are the port's seeded init carried to Flax by the JAX
package's ``port_timesformer``, perturbed so every weight matters (no eager
Flax init, which is slow on this CPU).

Tolerances: logits 1e-4 absolute (f32, another summation order); train
steps 1e-5 relative, as ``tests/test_torch_train.py`` states them;
preprocessing 1e-4 absolute on the normalised scale.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import laryngeal_tpu.ops.attention as jax_attention
from laryngeal_tpu.compat.torch_port import port_timesformer
from laryngeal_tpu.models.layers import gelu_exact as jax_gelu_exact
from laryngeal_tpu.models.registry import get_model_spec as jax_get_model_spec
from laryngeal_tpu.models.timesformer import create_timesformer as jax_create_timesformer
from laryngeal_tpu.preprocess import transforms as jt
from laryngeal_tpu.train.state import TrainState as JaxTrainState
from laryngeal_tpu.train.state import make_optimizer as jax_make_optimizer
from laryngeal_tpu.train.steps import make_eval_step as jax_make_eval_step
from laryngeal_tpu.train.steps import make_train_step as jax_make_train_step
from laryngeal_tpu_torch.cli import main as cli
from laryngeal_tpu_torch.compat.flax_weights import timesformer_state_dict_from_flax
from laryngeal_tpu_torch.data.synthetic import make_synthetic_dataset
from laryngeal_tpu_torch.infer.predictor import Predictor
from laryngeal_tpu_torch.models import layers as torch_layers
from laryngeal_tpu_torch.models.registry import create_model, get_model_spec
from laryngeal_tpu_torch.models.timesformer import TimesformerConfig, create_timesformer
from laryngeal_tpu_torch.ops import attention as att
from laryngeal_tpu_torch.preprocess import transforms as tt
from laryngeal_tpu_torch.train import checkpoint as ckpt
from laryngeal_tpu_torch.train import state as st
from laryngeal_tpu_torch.train import steps

TINY = dict(hidden_size=32, num_layers=2, num_heads=2, intermediate_size=64)
FRAMES, SIZE = 4, 32


@pytest.fixture(scope="module")
def flax_params():
    model = jax_create_timesformer(num_frames=FRAMES, image_size=SIZE, **TINY)
    weights = create_timesformer(num_frames=FRAMES, image_size=SIZE, seed=0, **TINY).state_dict()
    rng = np.random.default_rng(1)
    params = jax.tree_util.tree_map(
        lambda p: p + 0.02 * rng.standard_normal(p.shape).astype(np.float32),
        port_timesformer(weights, num_layers=TINY["num_layers"]))
    return model, params


@pytest.fixture(scope="module")
def port_model(flax_params):
    _, params = flax_params
    model = create_timesformer(num_frames=FRAMES, image_size=SIZE, seed=None, **TINY)
    model.load_state_dict(timesformer_state_dict_from_flax(params))
    return model


@pytest.fixture(scope="module")
def pixels():
    return np.random.default_rng(2).standard_normal((2, FRAMES, SIZE, SIZE, 3)).astype(np.float32)


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_logits_match_jax(flax_params, port_model, pixels, impl, monkeypatch):
    model, params = flax_params
    monkeypatch.setattr(jax_attention, "_IMPL", impl)
    ref = np.asarray(model.apply({"params": params}, jnp.asarray(pixels)))
    with torch.inference_mode():
        out = port_model(torch.from_numpy(pixels))
    assert out.dtype == torch.float32 and out.shape == (2, 2)
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-4, rtol=0)


def test_both_attention_calls_take_the_short_route(port_model, pixels, monkeypatch):
    """Every layer sends its temporal (N = T) and spatial (N = 1 + patches)
    attention to ``short_attention``, as the JAX pallas router does."""
    calls = []
    real = att.short_attention
    monkeypatch.setattr(att, "short_attention",
                        lambda q, k, v: calls.append(tuple(q.shape)) or real(q, k, v))
    monkeypatch.setattr(att, "_IMPL", "kernel")
    with torch.inference_mode():
        port_model(torch.from_numpy(pixels))
    n = (SIZE // 16) ** 2
    assert calls == [(2 * n, FRAMES, 2, 16), (2 * FRAMES, 1 + n, 2, 16)] * TINY["num_layers"]


def test_state_dict_round_trips_to_flax(flax_params, port_model):
    """port_timesformer(state_dict) gives back arrays identical to the Flax
    params."""
    _, params = flax_params
    back = port_timesformer(dict(port_model.state_dict()), num_layers=TINY["num_layers"])
    flat_a = jax.tree_util.tree_flatten_with_path(params)[0]
    flat_b = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert len(flat_a) == len(flat_b)
    for path, a in flat_a:
        np.testing.assert_array_equal(np.asarray(flat_b[path]), np.asarray(a))


def test_flax_weights_are_copied(flax_params):
    _, params = flax_params
    sd = timesformer_state_dict_from_flax(params)
    before = np.asarray(params["embeddings"]["time_embeddings"]).copy()
    sd["timesformer.embeddings.time_embeddings"].add_(1.0)
    np.testing.assert_array_equal(np.asarray(params["embeddings"]["time_embeddings"]), before)


def test_state_dict_names_are_hf():
    model = create_timesformer(num_frames=4, image_size=32, **TINY)
    names = set(model.state_dict())
    e, layer = "timesformer.embeddings", "timesformer.encoder.layer.1"
    for name in (f"{e}.cls_token", f"{e}.position_embeddings", f"{e}.time_embeddings",
                 f"{e}.patch_embeddings.projection.weight",
                 f"{layer}.attention.attention.qkv.weight",
                 f"{layer}.attention.output.dense.bias",
                 f"{layer}.temporal_attention.attention.qkv.bias",
                 f"{layer}.temporal_attention.output.dense.weight",
                 f"{layer}.temporal_dense.weight", f"{layer}.intermediate.dense.weight",
                 f"{layer}.output.dense.bias", f"{layer}.layernorm_before.weight",
                 f"{layer}.temporal_layernorm.bias", f"{layer}.layernorm_after.weight",
                 "timesformer.layernorm.weight", "classifier.weight"):
        assert name in names, name
    assert len(names) == 5 + 2 * 20 + 2 + 2


def test_bf16_compute_keeps_f32_params_and_logits(port_model, pixels):
    model = create_timesformer(num_frames=FRAMES, image_size=SIZE, seed=None,
                               dtype=torch.bfloat16, **TINY)
    model.load_state_dict(port_model.state_dict())
    assert all(p.dtype == torch.float32 for p in model.parameters())
    with torch.inference_mode():
        out = model(torch.from_numpy(pixels))
        ref = port_model(torch.from_numpy(pixels))
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), ref.numpy(), atol=0.1)


def test_init_weights_is_seeded_with_zero_embeddings():
    a, b = (create_timesformer(num_frames=4, image_size=32, seed=5, **TINY) for _ in range(2))
    for (n, p), q in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(p, q), n
    emb = a.timesformer.embeddings
    for p in (emb.cls_token, emb.position_embeddings, emb.time_embeddings):
        assert torch.count_nonzero(p) == 0
    w = emb.patch_embeddings.projection.weight
    assert abs(w.std().item() - 1 / np.sqrt(3 * 16 * 16)) < 0.01


@pytest.mark.parametrize("kwargs", [dict(layout="nt"), dict(remat=True)], ids=["nt", "remat"])
def test_unported_options_raise(kwargs):
    with pytest.raises(NotImplementedError, match="not yet ported"):
        TimesformerConfig(**kwargs)
    with pytest.raises(ValueError):
        TimesformerConfig(layout="nope")


def test_gelu_exact_matches_jax():
    x = np.linspace(-6, 6, 101, dtype=np.float32)
    np.testing.assert_allclose(torch_layers.gelu_exact(torch.from_numpy(x)).numpy(),
                               np.asarray(jax_gelu_exact(jnp.asarray(x))), atol=1e-6)


def test_registry_spec_matches_jax():
    a, b = get_model_spec("timesformer"), jax_get_model_spec("timesformer")
    for field in ("preprocess_regime", "loss", "optimizer", "default_num_frames", "default_lr",
                  "default_weight_decay", "label_policy", "selection", "per_video_seed"):
        assert getattr(a, field) == getattr(b, field), field
    model = create_model("timesformer", num_frames=4, image_size=32, **TINY)
    assert model.config.num_frames == 4 and model.config.dtype == torch.float32


# ---------- preprocessing ----------

@pytest.mark.parametrize("shape,crop", [((2, 224, 224, 3), 224), ((3, 64, 80, 3), 32),
                                        ((2, 40, 56, 3), 224)])
def test_timesformer_pixels_matches_jax(shape, crop):
    clip = np.random.default_rng(crop).integers(0, 256, shape, dtype=np.uint8)
    ref = jt.timesformer_pixels(jnp.asarray(clip), crop=crop, size=crop)
    out = tt.timesformer_pixels(torch.from_numpy(clip), crop=crop, size=crop)
    assert out.shape == (shape[0], crop, crop, 3)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-4, rtol=0)


def test_batch_preprocess_timesformer_matches_jax():
    clips = np.random.default_rng(4).integers(0, 256, (2, 3, 72, 80, 3), dtype=np.uint8)
    ref = jt.batch_preprocess(jnp.asarray(clips), "timesformer", False, crop=SIZE)
    out = tt.batch_preprocess(torch.from_numpy(clips), "timesformer", crop=SIZE)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-4, rtol=0)


# ---------- train and eval steps against the JAX train step ----------

def _rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


@pytest.fixture(scope="module")
def batches():
    rng = np.random.default_rng(3)
    return [(rng.integers(0, 256, (3, FRAMES, 40, 48, 3), dtype=np.uint8),
             rng.integers(0, 2, 3).astype(np.int32), np.array([True, True, False]))
            for _ in range(3)]


def _jax_state(params, lr=1e-3, wd=0.01):
    tx = jax_make_optimizer("adamw", lr, wd)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    return JaxTrainState(step=jnp.zeros((), jnp.int32), params=jp, opt_state=tx.init(jp),
                         batch_stats={}, tx=tx)


def _port_state(params, lr=1e-3, wd=0.01):
    model = create_timesformer(num_frames=FRAMES, image_size=SIZE, seed=None, **TINY)
    model.load_state_dict(timesformer_state_dict_from_flax(params))
    return model, st.create_train_state(model, "adamw", lr, wd)


def _torch_batch(batch):
    return tuple(torch.from_numpy(x) for x in batch)


def test_three_adamw_steps_and_an_eval_step_match_jax(flax_params, batches):
    """Per-step loss within 1e-5 relative; afterwards every parameter tensor
    within 1e-5 relative (L2). The key slice of each fused qkv bias gets only
    round-off gradient (softmax is shift-invariant per query row), so Adam
    steps it on the sign of that round-off: it is held to 3 lr per step and
    side instead. Then the eval step on the trained weights."""
    jmodel, params = flax_params
    jstate = _jax_state(params)
    jstep = jax_make_train_step(jmodel, "timesformer", "ce", crop=SIZE)
    model, state = _port_state(params)
    step = steps.make_train_step(model, "timesformer", "ce", crop=SIZE)
    for batch in batches:
        jstate, jm = jstep(jstate, *(jnp.asarray(x) for x in batch), jax.random.PRNGKey(0))
        state, m = step(state, *_torch_batch(batch))
        assert abs(m["loss"].item() - float(jm["loss"])) <= 1e-5 * abs(float(jm["loss"]))
        assert m["correct"].item() == float(jm["correct"]) and m["count"].item() == 2.0
        np.testing.assert_allclose(m["probs"].numpy(), np.asarray(jm["probs"]), atol=1e-5)
    want = timesformer_state_dict_from_flax(jax.tree_util.tree_map(np.asarray, jstate.params))
    got = model.state_dict()
    hidden = TINY["hidden_size"]
    for name, w in want.items():
        a, b = got[name].numpy(), w.numpy()
        if name.endswith("attention.attention.qkv.bias"):
            key = slice(hidden, 2 * hidden)
            assert np.abs(a[key] - b[key]).max() <= 2 * 3 * 3 * 1e-3, name
            a, b = np.delete(a, np.s_[key]), np.delete(b, np.s_[key])
        assert _rel_l2(a, b) <= 1e-5, name
    jm = jax_make_eval_step(jmodel, "timesformer", "ce", crop=SIZE)(
        jstate, *(jnp.asarray(x) for x in batches[0]))
    m = steps.make_eval_step(model, "timesformer", "ce", crop=SIZE)(
        state, *_torch_batch(batches[0]))
    assert abs(m["loss"].item() - float(jm["loss"])) <= 1e-5 * abs(float(jm["loss"]))
    np.testing.assert_allclose(m["probs"].numpy(), np.asarray(jm["probs"]), atol=1e-5)


# ---------- the training CLI and the predictor ----------

def test_cli_trains_and_predictor_serves_the_checkpoint(tmp_path):
    root = tmp_path / "data"
    make_synthetic_dataset(str(root), {"train": 3, "val": 1, "test": 2}, num_frames=10, h=40,
                           w=48, seed=4)
    out = cli.main(["--model", "timesformer", "--device", "cpu", "--data_dir", str(root),
                    "--log_dir", str(tmp_path / "logs"), "--num_frames", str(FRAMES),
                    "--crop_size", str(SIZE), "--hidden_size", "32", "--num_layers", "1",
                    "--num_heads", "2", "--intermediate_size", "64", "--batch_size", "4",
                    "--epochs", "1", "--decode_workers", "1", "--no-pretrained"])
    exp = tmp_path / "logs" / out["exp_dir"].split("/")[-1]
    assert exp.name.startswith("timesformer-classifier")
    for f in ("best_model", "latest", "training_history.json", "test_metrics_uniform.json"):
        assert (exp / f).exists(), f
    assert np.isfinite(out["history"]["train_loss"][0]) and out["cm"].shape == (2, 2)
    meta = ckpt.read_metadata(exp / "best_model")["config"]["model_kwargs"]
    assert meta == dict(num_classes=2, num_frames=FRAMES, image_size=SIZE, hidden_size=32,
                        num_layers=1, num_heads=2, intermediate_size=64)
    predictor = Predictor.from_checkpoint("timesformer", exp / "best_model", device="cpu")
    assert predictor.spec.preprocess_regime == "timesformer"
    assert predictor.model.config.num_frames == FRAMES
    clip = np.random.default_rng(1).integers(0, 256, (2, FRAMES, 40, 48, 3), dtype=np.uint8)
    probs = predictor.predict_clip(clip)
    assert probs.shape == (2, 2) and np.allclose(probs.sum(-1), 1.0, atol=1e-6)


def test_cli_still_refuses_remat_for_timesformer(tmp_path):
    with pytest.raises(SystemExit, match="not yet ported"):
        cli.main(["--model", "timesformer", "--device", "cpu", "--data_dir", str(tmp_path),
                  "--log_dir", str(tmp_path / "logs"), "--remat"])
    assert not (tmp_path / "logs").exists()
