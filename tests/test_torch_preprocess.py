"""Port ViViT preprocessing against the JAX functions on the same uint8
clips (normalised scale, atol 1e-4), and the resample weight matrices
against ``jax.image``'s own."""

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


def test_rgb_wire_passthrough_and_unported_paths(monkeypatch):
    x = torch.zeros((1, 2, 8, 8, 3), dtype=torch.uint8)
    assert tt.decode_wire_batch(x, "rgb") is x
    for wire in ("i420", "delta", "dct", "dctp"):
        with pytest.raises(NotImplementedError, match="not yet ported"):
            tt.decode_wire_batch(x, wire)
    with pytest.raises(NotImplementedError, match="not yet ported"):
        tt.batch_preprocess(x, "pytorchvideo")
    for regime in ("vivit", "timesformer"):
        with pytest.raises(NotImplementedError):
            tt.batch_preprocess(x, regime, train=True)
    monkeypatch.setenv("LARYNGEAL_PIL_EXACT", "1")
    for regime in ("vivit", "timesformer"):
        with pytest.raises(NotImplementedError, match="PIL"):
            tt.batch_preprocess(x, regime)
