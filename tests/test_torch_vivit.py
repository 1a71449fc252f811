"""Port ViViT against the JAX ViViT: same Flax weights carried across by
``compat.flax_weights``, same inputs, logits within 1e-4.

The tiny config has N = 8*8*8 + 1 = 513 tokens: at N >= 512 the JAX pallas
route takes the flash kernel (run here in interpret mode) rather than its
short-sequence kernel, and the ragged tail exercises the padding.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import laryngeal_tpu.ops.attention as jax_attention
from laryngeal_tpu.compat.torch_port import port_vivit
from laryngeal_tpu.models.vivit import create_vivit as jax_create_vivit
from laryngeal_tpu_torch.compat.flax_weights import vivit_state_dict_from_flax
from laryngeal_tpu_torch.models import layers as torch_layers
from laryngeal_tpu_torch.models.registry import create_model, get_model_spec
from laryngeal_tpu_torch.models.vivit import VivitConfig, create_vivit
from laryngeal_tpu_torch.ops import flash_attention as fa

TINY = dict(hidden_size=64, num_layers=2, num_heads=4, intermediate_size=128)
FRAMES, SIZE = 16, 128


def _to_np(tree):
    return jax.tree_util.tree_map(lambda x: np.asarray(x), tree)


@pytest.fixture(scope="module")
def flax_params():
    model = jax_create_vivit(num_frames=FRAMES, image_size=SIZE, **TINY)
    x = jnp.zeros((1, FRAMES, SIZE, SIZE, 3), jnp.float32)
    params = model.init(jax.random.PRNGKey(0), x)["params"]
    # Non-trivial CLS / LayerNorm / bias values, so every weight matters.
    rng = np.random.default_rng(1)
    params = jax.tree_util.tree_map(
        lambda p: np.asarray(p) + 0.02 * rng.standard_normal(p.shape).astype(np.float32),
        params)
    return model, params


@pytest.fixture(scope="module")
def pixels():
    rng = np.random.default_rng(2)
    return rng.standard_normal((2, FRAMES, SIZE, SIZE, 3)).astype(np.float32)


@pytest.fixture(scope="module")
def port_model(flax_params):
    _, params = flax_params
    model = create_vivit(num_frames=FRAMES, image_size=SIZE, seed=None, **TINY)
    model.load_state_dict(vivit_state_dict_from_flax(params))
    return model


def _jax_logits(flax_params, pixels, impl, monkeypatch):
    model, params = flax_params
    monkeypatch.setattr(jax_attention, "_IMPL", impl)
    return np.asarray(model.apply({"params": params}, jnp.asarray(pixels)))


def test_token_count_reaches_flash_route():
    assert VivitConfig(num_frames=FRAMES, image_size=SIZE, **TINY).num_patches + 1 == 513


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_logits_match_jax(flax_params, port_model, pixels, impl, monkeypatch):
    ref = _jax_logits(flax_params, pixels, impl, monkeypatch)
    fa.launches = 0
    with torch.inference_mode():
        out = port_model(torch.from_numpy(pixels))
    assert out.dtype == torch.float32 and out.shape == (2, 2)
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-4, rtol=0)
    assert fa.launches == 0  # CPU tensors take the plain path


def test_state_dict_round_trips_to_flax(flax_params, port_model):
    """port_vivit(state_dict) gives back arrays identical to the Flax params."""
    _, params = flax_params
    back = port_vivit({k: v for k, v in port_model.state_dict().items()},
                      num_layers=TINY["num_layers"])
    flat_a = jax.tree_util.tree_flatten_with_path(params)[0]
    flat_b = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert len(flat_a) == len(flat_b)
    for path, a in flat_a:
        np.testing.assert_array_equal(np.asarray(flat_b[path]), np.asarray(a))


def test_flax_weights_are_copied(flax_params):
    _, params = flax_params
    sd = vivit_state_dict_from_flax(params)
    before = np.asarray(params["classifier"]["bias"]).copy()
    sd["classifier.bias"].add_(1.0)
    np.testing.assert_array_equal(np.asarray(params["classifier"]["bias"]), before)


def test_state_dict_names_are_hf():
    model = create_vivit(num_frames=4, image_size=32, num_layers=1, hidden_size=32,
                         num_heads=2, intermediate_size=64)
    names = set(model.state_dict())
    for name in ("vivit.embeddings.cls_token",
                 "vivit.embeddings.position_embeddings",
                 "vivit.embeddings.patch_embeddings.projection.weight",
                 "vivit.encoder.layer.0.attention.attention.query.weight",
                 "vivit.encoder.layer.0.attention.output.dense.bias",
                 "vivit.encoder.layer.0.intermediate.dense.weight",
                 "vivit.encoder.layer.0.output.dense.weight",
                 "vivit.encoder.layer.0.layernorm_before.weight",
                 "vivit.encoder.layer.0.layernorm_after.bias",
                 "vivit.layernorm.weight", "classifier.weight"):
        assert name in names
    assert len(names) == 4 + 16 + 2 + 2


def test_bf16_compute_keeps_f32_params_and_logits(port_model, pixels):
    model = create_vivit(num_frames=FRAMES, image_size=SIZE, seed=None,
                         dtype=torch.bfloat16, **TINY)
    model.load_state_dict(port_model.state_dict())
    assert all(p.dtype == torch.float32 for p in model.parameters())
    with torch.inference_mode():
        out = model(torch.from_numpy(pixels))
        ref = port_model(torch.from_numpy(pixels))
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), ref.numpy(), atol=0.1)


def test_init_weights_is_seeded():
    a = create_vivit(num_frames=4, image_size=32, num_layers=1, hidden_size=32,
                     num_heads=2, intermediate_size=64, seed=5)
    b = create_vivit(num_frames=4, image_size=32, num_layers=1, hidden_size=32,
                     num_heads=2, intermediate_size=64, seed=5)
    for (n, p), q in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(p, q), n
    pos = a.vivit.embeddings.position_embeddings
    assert 0.01 < pos.std().item() < 0.03


def test_layers_gelu_fast_matches_jax():
    x = np.linspace(-6, 6, 101, dtype=np.float32)
    ref = np.asarray(jax.nn.gelu(jnp.asarray(x), approximate=True))
    np.testing.assert_allclose(torch_layers.gelu_fast(torch.from_numpy(x)).numpy(),
                               ref, atol=1e-6)


def test_registry_only_vivit():
    """ViViT and TimeSformer are registered, and the CNN families build
    through ``create_model`` with the registry's arguments."""
    assert get_model_spec("vivit").preprocess_regime == "vivit"
    assert get_model_spec("timesformer").preprocess_regime == "timesformer"
    for name in ("vivit", "timesformer"):
        assert isinstance(create_model(name, num_frames=4, image_size=32, num_layers=1,
                                       hidden_size=32, num_heads=2, intermediate_size=64),
                          torch.nn.Module)
    for name in ("resnet3d", "resnet50_lstm"):
        assert get_model_spec(name).preprocess_regime == "pytorchvideo"
        assert isinstance(create_model(name, num_classes=2, num_frames=4, image_size=32,
                                       seed=None), torch.nn.Module)
    with pytest.raises(ValueError):
        get_model_spec("nope")
