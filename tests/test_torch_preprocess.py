"""Port preprocessing (the ViViT regime, and the pytorchvideo regime of
Swin3D: eval, and train at the JAX draws) against the JAX functions on the
same uint8 clips (normalised scale, atol 1e-4), and the resample weight
matrices against ``jax.image``'s own."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from laryngeal_tpu.preprocess import transforms as jt
from laryngeal_tpu_torch.preprocess import transforms as tt


def _clip(shape, seed=0):
    return np.random.default_rng(seed).integers(0, 256, shape, dtype=np.uint8)


@pytest.mark.parametrize("h,w,size,crop", [(224, 224, 256, 224), (64, 64, 146, 128),
                                           (64, 64, 37, 32), (40, 56, 256, 224),
                                           (300, 200, 128, 112)])
@pytest.mark.parametrize("antialias", [True, False])
def test_weight_mat_matches_jax(h, w, size, crop, antialias):
    f = np.float32(size) / np.float32(min(h, w))
    off = (np.float32(h) * f - crop) / np.float32(2.0)
    # jax.image's (h, crop) weight matrix: resample the identity along axis 0.
    ref = jax.image.scale_and_translate(
        jnp.eye(h, dtype=jnp.float32), (crop, h), (0,), jnp.float32([f]),
        jnp.float32([-off]), method="linear", antialias=antialias).T
    out = tt.compute_weight_mat(h, crop, torch.tensor(f), torch.tensor(-off), antialias)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-7)


@pytest.mark.parametrize("shape,crop", [((2, 224, 224, 3), 224), ((3, 64, 64, 3), 128),
                                        ((3, 64, 64, 3), 32), ((2, 40, 56, 3), 224),
                                        ((2, 40, 56, 3), 32)])
def test_vivit_pixels_matches_jax(shape, crop):
    clip = _clip(shape, seed=crop)
    size = max(1, int(round(256 * crop / 224)))
    ref = jt.vivit_pixels(jnp.asarray(clip), crop=crop, size=size)
    out = tt.vivit_pixels(torch.from_numpy(clip), crop=crop, size=size)
    assert out.shape == (shape[0], crop, crop, 3) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-4, rtol=0)


@pytest.mark.parametrize("crop", [224, 128, 32])
def test_batch_preprocess_matches_jax(crop):
    clips = _clip((2, 3, 224, 224, 3), seed=1)
    ref = jt.batch_preprocess(jnp.asarray(clips), "vivit", train=False, crop=crop)
    out = tt.batch_preprocess(torch.from_numpy(clips), "vivit", train=False, crop=crop)
    assert out.shape == (2, 3, crop, crop, 3)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-4, rtol=0)


def test_batch_preprocess_non_square_matches_jax():
    clips = _clip((2, 2, 40, 56, 3), seed=2)
    ref = jt.batch_preprocess(jnp.asarray(clips), "vivit", train=False, crop=32)
    out = tt.batch_preprocess(torch.from_numpy(clips), "vivit", train=False, crop=32)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-4, rtol=0)


@pytest.mark.parametrize("scale,offset,antialias", [(1.3, (10.0, 4.5), True),
                                                    (0.6, (2.0, 3.0), True),
                                                    (1.1, (7.0, 0.0), False)])
def test_scale_crop_matches_jax(scale, offset, antialias):
    clip = _clip((2, 48, 64, 3), seed=3).astype(np.float32)
    ref = jt.scale_crop(jnp.asarray(clip), jnp.float32(scale),
                        jnp.asarray(offset, jnp.float32), (32, 40), antialias=antialias)
    out = tt.scale_crop(torch.from_numpy(clip), scale, offset, (32, 40), antialias=antialias)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-3, rtol=1e-6)


def test_center_crop_scale_matches_jax():
    clip = _clip((2, 50, 70, 3), seed=4).astype(np.float32)
    ref = jt.center_crop_scale(jnp.asarray(clip), 64, 48)
    out = tt.center_crop_scale(torch.from_numpy(clip), 64, 48)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-3, rtol=1e-6)


@pytest.mark.parametrize("regime", ["vivit", "timesformer"])
def test_hf_regimes_train_mode_matches_jax(regime):
    """The HF-processor regimes have no augmentation: train mode gives JAX's
    train-mode pixels, which are their eval pixels."""
    clips = _clip((2, 3, 40, 56, 3), seed=5)
    ref = jt.batch_preprocess(jnp.asarray(clips), regime, train=True, crop=32)
    out = tt.batch_preprocess(torch.from_numpy(clips), regime, train=True, crop=32)
    assert out.shape == (2, 3, 32, 32, 3)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-4, rtol=0)
    torch.testing.assert_close(
        out, tt.batch_preprocess(torch.from_numpy(clips), regime, train=False, crop=32),
        rtol=0, atol=0)


def test_rgb_wire_passthrough_and_unported_paths(monkeypatch):
    """rgb passes through; the other wires and LARYNGEAL_PIL_EXACT are
    ported (tests/test_torch_wire.py, test_torch_pil_resize.py), so what is
    refused is what the JAX function refuses: an unknown wire, dct / dctp
    without wire_hw or at a geometry that is not a multiple of 16."""
    x = torch.zeros((1, 2, 8, 8, 3), dtype=torch.uint8)
    assert tt.decode_wire_batch(x, "rgb") is x
    pair = (torch.zeros((1, 2, 30), dtype=torch.int16),
            torch.zeros((1, 3, 2, 30), dtype=torch.int8))
    for wire, hw, match in (("nope", None, "Unknown wire format"), ("dct", None, "wire_hw"),
                            ("dctp", None, "wire_hw"), ("dct", (40, 48), "multiples of 16")):
        with pytest.raises(ValueError, match=match):
            tt.decode_wire_batch(pair, wire, hw)
        with pytest.raises(ValueError, match=match):
            jt.decode_wire_batch(tuple(jnp.asarray(a.numpy()) for a in pair), wire, hw)
    with pytest.raises(ValueError, match="Unknown preprocessing regime"):
        tt.batch_preprocess(x, "nope")
    with pytest.raises(ValueError, match="Generator"):
        tt.batch_preprocess(x, "pytorchvideo", train=True)
    monkeypatch.setenv("LARYNGEAL_PIL_EXACT", "1")
    clips = _clip((1, 2, 40, 56, 3), seed=9)
    for regime in ("vivit", "timesformer"):
        out = tt.batch_preprocess(torch.from_numpy(clips), regime, crop=32)
        ref = jt.batch_preprocess(jnp.asarray(clips), regime, False, crop=32)
        assert out.shape == (1, 2, 32, 32, 3)
        np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


# ---------- the pytorchvideo regime (Swin3D) ----------

@pytest.mark.parametrize("shape,crop", [((2, 224, 224, 3), 224), ((3, 64, 80, 3), 32),
                                        ((2, 40, 56, 3), 224), ((2, 300, 200, 3), 112)])
def test_pytorchvideo_eval_matches_jax(shape, crop):
    clip = _clip(shape, seed=crop + 7)
    size = max(1, int(round(256 * crop / 224)))
    ref = jt.pytorchvideo_eval(jnp.asarray(clip), crop=crop, size=size)
    out = tt.pytorchvideo_eval(torch.from_numpy(clip), crop=crop, size=size)
    assert out.shape == (shape[0], crop, crop, 3) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-4, rtol=0)


@pytest.mark.parametrize("crop", [224, 32])
def test_batch_preprocess_pytorchvideo_eval_matches_jax(crop):
    clips = _clip((2, 3, 72, 80, 3), seed=11)
    ref = jt.batch_preprocess(jnp.asarray(clips), "pytorchvideo", False, crop=crop)
    out = tt.batch_preprocess(torch.from_numpy(clips), "pytorchvideo", train=False, crop=crop)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-4, rtol=0)


def _jax_draws(key, h, w, min_size, max_size):
    """What ``jt.pytorchvideo_train`` draws from ``key``: (size, u_y, u_x,
    flip), replayed with the JAX function's own splits."""
    kf, kc = jax.random.split(key)
    k1, k2, k3 = jax.random.split(kc, 3)
    size = int(jax.random.randint(k1, (), min_size, max_size + 1))
    return (size, float(jax.random.uniform(k2, ())), float(jax.random.uniform(k3, ())),
            bool(jax.random.bernoulli(kf, 0.5)))


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("shape,crop", [((2, 64, 80, 3), 32), ((2, 40, 36, 3), 32),
                                        ((1, 256, 300, 3), 224)])
def test_scale_crop_and_flip_at_jax_draws_match_jax(shape, crop, seed):
    """The train transform at the draws JAX made: scale to the integer short
    side, integer crop offsets, whole-clip flip, normalise. The JAX side is
    ``pytorchvideo_train``'s steps run eagerly: under ``jit`` XLA computes
    the resample weights with another rounding (0.006 levels of 255 apart
    from JAX's own eager result on these clips), which is not the port's to
    match."""
    clip = _clip(shape, seed=seed)
    lo, hi = max(1, int(round(256 * crop / 224))), max(1, int(round(320 * crop / 224)))
    key = jax.random.PRNGKey(seed)
    kf, kc = jax.random.split(key)
    v = jt.random_scale_crop(jnp.asarray(clip, jnp.float32), kc, lo, hi, crop)
    ref = (jt.random_hflip(v, kf) / 255.0 - jt.PTV_MEAN) / jt.PTV_STD
    draw = _jax_draws(key, shape[1], shape[2], lo, hi)
    out = tt.pytorchvideo_train(torch.from_numpy(clip)[None], [draw], crop=crop)[0]
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-4, rtol=0)
    # The flip (folded into the x weights) mirrors the same sums exactly.
    other = tt.pytorchvideo_train(torch.from_numpy(clip)[None], [draw[:3] + (not draw[3],)],
                                  crop)[0]
    np.testing.assert_array_equal(other.numpy(), out.numpy()[:, :, ::-1])


def test_draws_stay_inside_their_integer_ranges():
    gen = torch.Generator().manual_seed(0)
    draws = tt.draw_pytorchvideo(gen, 400, 256, 320)
    sizes = [d[0] for d in draws]
    assert all(isinstance(s, int) and 256 <= s <= 320 for s in sizes)
    assert min(sizes) == 256 and max(sizes) == 320
    assert all(0.0 <= d[1] < 1.0 and 0.0 <= d[2] < 1.0 for d in draws)
    assert 150 < sum(d[3] for d in draws) < 250
    # Integer offsets inside [0, floor(scaled side) - crop].
    for size, u_y, u_x, _ in draws[:20]:
        f = np.float32(size) / np.float32(64)
        max_y = max(np.floor(np.float32(64) * f) - 224, 0.0)
        oy = np.floor(np.float32(u_y) * (max_y + 1))
        assert oy == int(oy) and 0 <= oy <= max_y
    again = tt.draw_pytorchvideo(torch.Generator().manual_seed(0), 400, 256, 320)
    assert again == draws


def test_batch_preprocess_train_is_one_draw_per_sample():
    """Each sample takes its own draw from the generator, in batch order
    (the batched resample against each clip alone: f32 sums of the same
    terms, 1e-5 on the normalised scale); the same generator seed gives the
    same batch."""
    clips = _clip((3, 2, 48, 64, 3), seed=5)
    out = tt.batch_preprocess(torch.from_numpy(clips), "pytorchvideo", train=True, crop=32,
                              generator=torch.Generator().manual_seed(3))
    draws = tt.draw_pytorchvideo(torch.Generator().manual_seed(3), 3, 37, 46)
    for clip, d, got in zip(clips, draws, out):
        alone = tt.pytorchvideo_train(torch.from_numpy(clip)[None], [d], 32)[0]
        np.testing.assert_allclose(got.numpy(), alone.numpy(), atol=1e-5, rtol=0)
    again = tt.batch_preprocess(torch.from_numpy(clips), "pytorchvideo", train=True, crop=32,
                                generator=torch.Generator().manual_seed(3))
    assert torch.equal(out, again) and out.shape == (3, 2, 32, 32, 3)
