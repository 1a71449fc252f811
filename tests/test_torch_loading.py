"""``--torch_weights`` in the port (``compat/loading.py``) against the JAX
loader (``laryngeal_tpu/compat/loading.py load_torch_weights_into_state``):
the same ``.pth`` or ``.npz`` file, loaded by each into the same fresh
model, gives the same logits (1e-4 x max(1, max |logit|), the f32 logit
limit of the port's model-parity tests). The files carry a 400-class head (kept at the
fresh init by both), DataParallel ``module.`` prefixes and the reference's
``model_state_dict`` wrapper (``.pth``), an 8-frame ``time_embeddings``
table against a 4-frame model (interpolated as the JAX package does) and,
for slow_r50, BatchNorm running statistics. Also: tensors the file lacks
keep the fresh init with a warning, and the port's Swin3D (tiny / small /
base) and slow_r50 state dicts match the upstream manifests, which are the
JAX package's.
"""

import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from laryngeal_tpu.compat import manifests as jax_manifests
from laryngeal_tpu.compat.loading import load_torch_weights_into_state
from laryngeal_tpu.compat.torch_port import port_resnet3d, port_timesformer, port_vivit
from laryngeal_tpu.compat.torch_port import resize_time_embeddings as jax_resize
from laryngeal_tpu.models.resnet3d import create_resnet3d as jax_create_resnet3d
from laryngeal_tpu.models.timesformer import create_timesformer as jax_create_timesformer
from laryngeal_tpu.models.vivit import create_vivit as jax_create_vivit
from laryngeal_tpu.train.state import TrainState as JaxTrainState
from laryngeal_tpu_torch.compat import loading, manifests
from laryngeal_tpu_torch.models.registry import create_model

TINY = dict(hidden_size=32, num_layers=2, num_heads=2, intermediate_size=64)
FRAMES, SIZE = 4, 32


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _perturbed(model, seed):
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for k, t in model.state_dict().items():
            if k.endswith("running_var"):
                t.mul_(1.0 + 0.5 * torch.rand(t.shape, generator=g, dtype=t.dtype))
            elif t.is_floating_point():
                t.add_(0.05 * torch.randn(t.shape, generator=g, dtype=t.dtype))
    return model


FAMILIES = {
    # name: (port kwargs of the model, of the checkpoint; the JAX model, converter)
    "vivit": (dict(num_frames=FRAMES, image_size=SIZE, **TINY),
              dict(num_frames=FRAMES, image_size=SIZE, num_classes=400, **TINY),
              lambda: jax_create_vivit(num_frames=FRAMES, image_size=SIZE, **TINY),
              lambda sd: {"params": port_vivit(sd, num_layers=2)}),
    "timesformer": (dict(num_frames=FRAMES, image_size=SIZE, **TINY),
                    dict(num_frames=8, image_size=SIZE, num_classes=400, **TINY),
                    lambda: jax_create_timesformer(num_frames=FRAMES, image_size=SIZE, **TINY),
                    lambda sd: {"params": port_timesformer(sd, num_layers=2)}),
    "resnet3d": (dict(dropout=0.0), dict(dropout=0.0, num_classes=400),
                 lambda: jax_create_resnet3d(dropout=0.0),
                 lambda sd: port_resnet3d(sd)),
}


def _write(tmp_path, name, kind):
    _, ckpt_kw, _, _ = FAMILIES[name]
    sd = _perturbed(create_model(name, seed=3, **ckpt_kw), 4).state_dict()
    path = tmp_path / f"{name}.{kind}"
    if kind == "pth":
        torch.save({"model_state_dict": {f"module.{k}": v for k, v in sd.items()},
                    "epoch": 3}, path)
    else:
        np.savez(path, **{k: v.numpy() for k, v in sd.items()})
    return path, sd


def _jax_logits(name, fresh_sd, path, x):
    _, _, make_jax, convert = FAMILIES[name]
    fresh = convert(dict(fresh_sd))
    state = JaxTrainState(step=jnp.zeros((), jnp.int32),
                          params=jax.tree_util.tree_map(jnp.asarray, fresh["params"]),
                          opt_state=None, batch_stats=fresh.get("batch_stats", {}), tx=None)
    state = load_torch_weights_into_state(state, name, path)
    variables = {"params": state.params}
    if state.batch_stats:
        variables["batch_stats"] = state.batch_stats
    return np.asarray(make_jax().apply(variables, jnp.asarray(x)))


@pytest.mark.parametrize("kind", ["pth", "npz"])
@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_port_and_jax_loaders_give_the_same_logits(name, kind, tmp_path, caplog):
    model_kw = FAMILIES[name][0]
    path, sd = _write(tmp_path, name, kind)
    model = create_model(name, seed=0, **model_kw)
    fresh = {k: v.clone() for k, v in model.state_dict().items()}
    with caplog.at_level(logging.INFO):
        loading.load_torch_weights(model, name, path, logging.getLogger("loading-test"))
    x = np.random.default_rng(5).standard_normal((2, FRAMES, SIZE, SIZE, 3)).astype(np.float32)
    with torch.no_grad():
        got = model.eval()(torch.from_numpy(x)).numpy()
    want = _jax_logits(name, fresh, path, x)
    np.testing.assert_allclose(got, want, atol=1e-4 * max(1.0, np.abs(want).max()), rtol=0)

    loaded = model.state_dict()
    head = [k for k in sd if sd[k].shape and sd[k].shape[0] == 400]
    assert head and "Kept fresh init" in caplog.text
    for k in loaded:
        if k in head:
            assert torch.equal(loaded[k], fresh[k]), k  # the 2-class head keeps its init
        elif k.endswith("time_embeddings"):
            want = jax_resize(sd[k].numpy(), FRAMES)
            np.testing.assert_allclose(loaded[k].numpy(), want, atol=1e-7)
            assert "Interpolated temporal embeddings" in caplog.text
        else:
            assert torch.equal(loaded[k], sd[k].to(loaded[k].dtype)), k
    if name == "resnet3d":
        stats = [k for k in loaded if k.endswith(("running_mean", "running_var"))]
        assert len(stats) == 2 * 53 and not any(torch.equal(loaded[k], fresh[k]) for k in stats)


def test_resize_time_embeddings_is_the_jax_one():
    emb = np.random.default_rng(0).standard_normal((1, 8, 6)).astype(np.float32)
    for t in (8, 4, 16, 32, 3):
        np.testing.assert_array_equal(loading.resize_time_embeddings(emb, t), jax_resize(emb, t))


def test_missing_tensors_keep_fresh_init_and_warn(tmp_path, caplog):
    """A 1-layer checkpoint into a 2-layer ViViT: layer 1 keeps its init."""
    ckpt = _perturbed(create_model("vivit", seed=3, num_frames=FRAMES, image_size=SIZE,
                                   **dict(TINY, num_layers=1)), 4)
    path = tmp_path / "one_layer.pth"
    torch.save(ckpt.state_dict(), path)
    model = create_model("vivit", seed=0, num_frames=FRAMES, image_size=SIZE, **TINY)
    fresh = {k: v.clone() for k, v in model.state_dict().items()}
    with caplog.at_level(logging.WARNING):
        loading.load_torch_weights(model, "vivit", path, logging.getLogger("loading-test"))
    assert "absent from the checkpoint keep RANDOM init" in caplog.text
    loaded = model.state_dict()
    for k in loaded:
        if ".layer.1." in k:
            assert torch.equal(loaded[k], fresh[k]), k
        else:
            assert torch.equal(loaded[k], ckpt.state_dict()[k]), k


def test_state_dict_file_forms_are_unwrapped(tmp_path):
    sd = {"a.weight": torch.ones(2), "b": torch.zeros(3)}
    torch.save({"state_dict": {f"module.{k}": v for k, v in sd.items()}}, tmp_path / "s.pt")
    got = loading.load_torch_state_dict(tmp_path / "s.pt")
    assert set(got) == set(sd) and all(torch.equal(got[k], sd[k]) for k in sd)
    np.savez(tmp_path / "s.npz", **{k: v.numpy() for k, v in sd.items()})
    got = loading.load_torch_state_dict(tmp_path / "s.npz")
    assert set(got) == set(sd) and all(torch.equal(got[k], sd[k]) for k in sd)


@pytest.mark.parametrize("size", ["tiny", "small", "base"])
def test_swin3d_state_dict_matches_the_manifest(size):
    manifest = manifests.swin3d_manifest(size, num_classes=400)
    assert manifest == jax_manifests.swin3d_manifest(size, num_classes=400)
    missing, extra, mismatched = manifests.validate_state_dict(
        create_model("swin3d", model_size=size, num_classes=400, seed=None).state_dict(),
        manifest)
    assert not extra and not mismatched
    assert missing and all(manifests.is_ignorable(k) for k in missing)


def test_resnet3d_state_dict_matches_the_manifest():
    manifest = manifests.resnet3d_manifest(num_classes=2)
    assert manifest == jax_manifests.resnet3d_manifest(num_classes=2)
    assert manifests.validate_state_dict(create_model("resnet3d", seed=None).state_dict(),
                                         manifest) == ([], [], [])


def test_manifest_drift_is_reported():
    sd = create_model("swin3d", model_size="tiny", num_classes=400, seed=None).state_dict()
    sd["features.0.0.attn.qkv_proj.weight"] = sd.pop("features.0.0.attn.qkv.weight")
    sd["head.weight"] = sd["head.weight"].T
    missing, extra, mismatched = manifests.validate_state_dict(
        sd, manifests.swin3d_manifest("tiny", num_classes=400))
    assert "features.0.0.attn.qkv.weight" in missing
    assert extra == ["features.0.0.attn.qkv_proj.weight"]
    assert [m[0] for m in mismatched] == ["head.weight"]
