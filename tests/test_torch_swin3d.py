"""Port Swin3D against the JAX Swin3D: same Flax weights carried across by
``compat.flax_weights``, same inputs, both JAX attention routes. Also the
model's numpy helpers against the JAX copies at every size's config, the
torchvision parameter names, the training CLI and
``Predictor.from_checkpoint``.

Tiny config: embed 8, four stages of two blocks (depths 2-2-2-2, heads
2-2-4-4), window (2, 2, 2), patch (2, 4, 4), on 8 frames of 40x36: the
patch grid is 4x10x9, so stage 1 pads W to 10, every stage's second block
is shifted, and stage 4 (4x2x2) clamps its H and W windows to 2 and zeroes
their shift while T keeps its shift, as Swin3D-T's stage 4 does at 224^2.
Every window is N = 8, so the JAX pallas route really reaches its Pallas
kernel (interpret mode here). Weights are the port's seeded init carried to
Flax by the JAX package's ``port_swin3d``, perturbed so every weight
matters (no eager Flax init, which is slow on this CPU).

Tolerances: logits 1e-4 x max(1, max |logit|) (f32, another summation
order); the numpy helpers exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import laryngeal_tpu.models.swin3d as jax_swin
import laryngeal_tpu.ops.attention as jax_attention
from laryngeal_tpu.compat.torch_port import port_swin3d
from laryngeal_tpu.models.registry import get_model_spec as jax_get_model_spec
from laryngeal_tpu_torch.cli import main as cli
from laryngeal_tpu_torch.compat.flax_weights import swin3d_state_dict_from_flax
from laryngeal_tpu_torch.data.synthetic import make_synthetic_dataset
from laryngeal_tpu_torch.infer.predictor import Predictor
from laryngeal_tpu_torch.models import swin3d
from laryngeal_tpu_torch.models.registry import create_model, get_model_spec
from laryngeal_tpu_torch.ops import attention as att
from laryngeal_tpu_torch.train import checkpoint as ckpt

TINY = dict(embed_dim=8, depths=(2, 2, 2, 2), num_heads=(2, 2, 4, 4), window=(2, 2, 2),
            patch_size=(2, 4, 4))
FRAMES, HEIGHT, WIDTH = 8, 40, 36


def _jax_model(**kw):
    cfg = jax_swin.Swin3DConfig(num_classes=2, stochastic_depth=0.0, **{**TINY, **kw})
    return jax_swin.SwinTransformer3D(cfg)


@pytest.fixture(scope="module")
def flax_params():
    weights = swin3d.create_swin3d(seed=0, **TINY).state_dict()
    rng = np.random.default_rng(1)
    params = jax.tree_util.tree_map(
        lambda p: p + 0.02 * rng.standard_normal(p.shape).astype(np.float32),
        port_swin3d(weights, depths=TINY["depths"]))
    return _jax_model(), params


@pytest.fixture(scope="module")
def port_model(flax_params):
    _, params = flax_params
    model = swin3d.create_swin3d(seed=None, stochastic_depth=0.0, **TINY)
    model.load_state_dict(swin3d_state_dict_from_flax(params, TINY["depths"]))
    return model


@pytest.fixture(scope="module")
def pixels():
    return np.random.default_rng(2).standard_normal(
        (2, FRAMES, HEIGHT, WIDTH, 3)).astype(np.float32)


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_logits_match_jax(flax_params, port_model, pixels, impl, monkeypatch):
    model, params = flax_params
    monkeypatch.setattr(jax_attention, "_IMPL", impl)
    ref = np.asarray(model.apply({"params": params}, jnp.asarray(pixels)))
    with torch.inference_mode():
        out = port_model(torch.from_numpy(pixels))
    assert out.dtype == torch.float32 and out.shape == (2, 2)
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-4 * max(1.0, np.abs(ref).max()),
                               rtol=0)


def test_every_block_reaches_window_attention(port_model, pixels, monkeypatch):
    """Eight blocks, eight calls at N = 8; the shifted blocks (the second of
    each stage) carry region ids, stage 4's clamped shift (1, 0, 0) too."""
    calls = []
    real = att.window_attention

    def spy(q, k, v, bias, region_id=None, impl=None):
        calls.append((tuple(q.shape), region_id is not None))
        return real(q, k, v, bias, region_id, impl)

    monkeypatch.setattr(swin3d, "window_attention", spy)
    with torch.inference_mode():
        port_model(torch.from_numpy(pixels))
    # (B·nW, N, H, D): stage grids 4x10x9 (padded 4x10x10), 4x5x5 (4x6x6),
    # 4x3x3 (4x4x4) and 4x2x2 (windows clamped to 2x2x2 anyway).
    assert calls == [((100, 8, 2, 4), False), ((100, 8, 2, 4), True),
                     ((36, 8, 2, 8), False), ((36, 8, 2, 8), True),
                     ((16, 8, 4, 8), False), ((16, 8, 4, 8), True),
                     ((4, 8, 4, 16), False), ((4, 8, 4, 16), True)]


def test_clamped_window_zeroes_its_shift():
    assert swin3d.adjust_window((4, 2, 2), (2, 2, 2), (1, 1, 1)) == ((2, 2, 2), (1, 0, 0))
    assert swin3d.adjust_window((16, 7, 7), (8, 7, 7), (4, 3, 3)) == ((8, 7, 7), (4, 0, 0))
    assert swin3d.adjust_window((3, 5, 1), (8, 7, 7), (4, 3, 3)) == ((3, 5, 1), (0, 0, 0))
    for args in (((4, 2, 2), (2, 2, 2), (1, 1, 1)), ((3, 5, 1), (8, 7, 7), (4, 3, 3))):
        assert swin3d.adjust_window(*args) == jax_swin.adjust_window(*args)


# (padded dims, runtime window, shift, configured window): every size shares
# the (8, 7, 7) window; Swin3D-T's four stage grids at 32f 224^2 and
# clamped / padded windows.
HELPER_CASES = [
    ((16, 56, 56), (8, 7, 7), (4, 3, 3), (8, 7, 7)),
    ((16, 28, 28), (8, 7, 7), (4, 3, 3), (8, 7, 7)),
    ((16, 14, 14), (8, 7, 7), (4, 3, 3), (8, 7, 7)),
    ((16, 7, 7), (8, 7, 7), (4, 0, 0), (8, 7, 7)),
    ((4, 6, 6), (4, 3, 3), (2, 1, 1), (8, 7, 7)),
    ((2, 5, 3), (2, 5, 3), (0, 0, 0), (8, 7, 7)),
]


@pytest.mark.parametrize("size", sorted(swin3d.SWIN3D_VARIANTS))
@pytest.mark.parametrize("case", HELPER_CASES, ids=str)
def test_relative_position_index_and_region_ids_match_jax(size, case):
    padded, window, shift, full = case
    assert swin3d.SWIN3D_VARIANTS[size] == {
        k: tuple(v) if isinstance(v, (list, tuple)) else v
        for k, v in jax_swin.SWIN3D_VARIANTS[size].items()}
    np.testing.assert_array_equal(swin3d.relative_position_index(window, full),
                                  jax_swin.relative_position_index(window, full))
    np.testing.assert_array_equal(swin3d.shift_region_ids(padded, window, shift),
                                  jax_swin.shift_region_ids(padded, window, shift))


def test_window_partition_and_merge_match_jax():
    x = np.random.default_rng(3).standard_normal((2, 4, 6, 6, 5)).astype(np.float32)
    got = swin3d.window_partition(torch.from_numpy(x), (2, 3, 3))
    want = jax_swin.window_partition(jnp.asarray(x), (2, 3, 3))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    back = swin3d.window_merge(got, (2, 3, 3), (4, 6, 6), 2)
    np.testing.assert_array_equal(back.numpy(), x)


def test_state_dict_round_trips_to_flax(flax_params, port_model):
    """port_swin3d(state_dict) gives back arrays identical to the Flax params."""
    _, params = flax_params
    back = port_swin3d(dict(port_model.state_dict()), depths=TINY["depths"])
    flat_a = jax.tree_util.tree_flatten_with_path(params)[0]
    flat_b = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert len(flat_a) == len(flat_b)
    for path, a in flat_a:
        np.testing.assert_array_equal(np.asarray(flat_b[path]), np.asarray(a))


def test_full_tiny_names_round_trip():
    """Swin3D-T at full width: every torchvision name the JAX converter reads
    exists, and the two converters are inverses."""
    model = swin3d.create_swin3d("tiny", seed=3)
    sd = model.state_dict()
    assert len(sd) == 4 + 12 * 13 + 3 * 3 + 4  # embed, blocks, merges, norm + head
    back = swin3d_state_dict_from_flax(port_swin3d(dict(sd)), (2, 2, 6, 2))
    assert set(back) == set(sd)
    for name, w in sd.items():
        assert torch.equal(back[name], w), name
    assert sd["features.0.0.attn.relative_position_bias_table"].shape == (15 * 13 * 13, 3)
    assert sd["features.5.reduction.weight"].shape == (768, 1536)
    assert sd["head.weight"].shape == (2, 768)


def test_flax_weights_are_copied(flax_params):
    _, params = flax_params
    sd = swin3d_state_dict_from_flax(params, TINY["depths"])
    table = params["stage1_block0"]["attn"]["relative_position_bias_table"]
    before = np.asarray(table).copy()
    sd["features.0.0.attn.relative_position_bias_table"].add_(1.0)
    np.testing.assert_array_equal(np.asarray(table), before)


def test_bf16_compute_keeps_f32_params_and_logits(port_model, pixels):
    model = swin3d.create_swin3d(seed=None, stochastic_depth=0.0, dtype=torch.bfloat16, **TINY)
    model.load_state_dict(port_model.state_dict())
    assert all(p.dtype == torch.float32 for p in model.parameters())
    with torch.inference_mode():
        out = model(torch.from_numpy(pixels))
        ref = port_model(torch.from_numpy(pixels))
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), ref.numpy(), atol=0.1)


def test_init_weights_is_seeded():
    a, b = (swin3d.create_swin3d(seed=5, **TINY) for _ in range(2))
    for (n, p), q in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(p, q), n
    t = a.features[0][0].attn.relative_position_bias_table
    assert t.abs().max() <= 0.04 and 0.01 < t.std() < 0.03
    w = a.patch_embed.proj.weight
    assert abs(w.std().item() - 1 / np.sqrt(3 * 2 * 4 * 4)) < 0.02


def test_unported_remat_and_unknown_size_raise():
    with pytest.raises(NotImplementedError, match="not yet ported"):
        swin3d.Swin3DConfig(remat=True)
    with pytest.raises(ValueError):
        swin3d.create_swin3d("huge")


def test_stochastic_depth_draws_only_with_a_generator(port_model, pixels):
    """Train mode with a generator drops paths (reproducibly from the seed);
    without one, and in eval, the forward is the deterministic one."""
    model = swin3d.create_swin3d(seed=None, stochastic_depth=0.5, **TINY)
    model.load_state_dict(port_model.state_dict())
    x = torch.from_numpy(pixels)
    with torch.no_grad():
        plain = port_model(x)
        model.train()
        assert torch.equal(model(x), plain)
        a = model(x, generator=torch.Generator().manual_seed(1))
        b = model(x, generator=torch.Generator().manual_seed(1))
        c = model(x, generator=torch.Generator().manual_seed(2))
    assert torch.equal(a, b) and not torch.equal(a, plain) and not torch.equal(a, c)


def test_registry_spec_matches_jax():
    a, b = get_model_spec("swin3d"), jax_get_model_spec("swin3d")
    for field in ("preprocess_regime", "loss", "optimizer", "default_num_frames", "default_lr",
                  "default_weight_decay", "label_policy", "selection", "per_video_seed"):
        assert getattr(a, field) == getattr(b, field), field
    model = create_model("swin3d", num_frames=4, image_size=32, model_size="tiny",
                         embed_dim=8, depths=(1, 1), num_heads=(1, 1), seed=None)
    assert model.config.depths == (1, 1) and model.config.dtype == torch.float32


# ---------- the training CLI and the predictor ----------

def test_cli_trains_without_early_stopping_and_predictor_serves(tmp_path, monkeypatch):
    """``cli.main --model swin3d --model_size tiny`` on the CPU, with the
    tiny preset standing in for Swin3D-T's widths: one epoch, no early
    stopping (the JAX CLI's rule for Swin3D), the architecture pinned in the
    checkpoint, and ``Predictor.from_checkpoint('swin3d')`` serving it."""
    tiny = {k: v for k, v in TINY.items() if k not in ("window", "patch_size")}
    monkeypatch.setitem(swin3d.SWIN3D_VARIANTS, "tiny", tiny)
    root = tmp_path / "data"
    make_synthetic_dataset(str(root), {"train": 3, "val": 1, "test": 2}, num_frames=10, h=40,
                           w=48, seed=4)
    out = cli.main(["--model", "swin3d", "--model_size", "tiny", "--device", "cpu",
                    "--data_dir", str(root), "--log_dir", str(tmp_path / "logs"),
                    "--num_frames", "4", "--crop_size", "32", "--batch_size", "4",
                    "--stochastic_depth", "0.2", "--epochs", "1", "--decode_workers", "1",
                    "--no-pretrained"])
    exp = tmp_path / "logs" / out["exp_dir"].split("/")[-1]
    assert exp.name.startswith("swin3d-classifier")
    for f in ("best_model", "latest", "training_history.json", "test_metrics_uniform.json"):
        assert (exp / f).exists(), f
    assert np.isfinite(out["history"]["train_loss"][0]) and out["cm"].shape == (2, 2)
    meta = ckpt.read_metadata(exp / "best_model")["config"]
    assert meta["model_kwargs"] == dict(num_classes=2, num_frames=4, image_size=32,
                                        model_size="tiny", stochastic_depth=0.2)
    assert meta["use_early_stopping"] is False and meta["learning_rate"] == 1e-4
    predictor = Predictor.from_checkpoint("swin3d", exp / "best_model", device="cpu")
    assert predictor.spec.preprocess_regime == "pytorchvideo"
    assert predictor.model.config.stochastic_depth == 0.2
    clip = np.random.default_rng(1).integers(0, 256, (2, 4, 40, 48, 3), dtype=np.uint8)
    probs = predictor.predict_clip(clip)
    assert probs.shape == (2, 2) and np.allclose(probs.sum(-1), 1.0, atol=1e-6)


def test_cli_refuses_remat_for_swin3d(tmp_path):
    with pytest.raises(SystemExit, match="not yet ported"):
        cli.main(["--model", "swin3d", "--device", "cpu", "--data_dir", str(tmp_path),
                  "--log_dir", str(tmp_path / "logs"), "--remat"])
    assert not (tmp_path / "logs").exists()
