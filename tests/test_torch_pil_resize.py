"""The port's bit-exact Pillow 8-bit bilinear resize
(``laryngeal_tpu_torch/preprocess/pil_resize.py``) against the JAX
package's and against Pillow itself, bit for bit, and the
``LARYNGEAL_PIL_EXACT=1`` route of ``batch_preprocess`` against the JAX
one (equal: the same uint8 crop through the same affine in float32).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from laryngeal_tpu.preprocess import pil_resize as jax_pil
from laryngeal_tpu.preprocess import transforms as jax_transforms
from laryngeal_tpu_torch.preprocess import pil_resize, transforms

PIL = pytest.importorskip("PIL.Image")

# (in h, in w, out h, out w): an upscale, a downscale, another aspect.
SIZES = [(24, 32, 48, 40), (64, 48, 20, 30), (30, 30, 37, 29)]


def _img(shape, seed):
    return np.random.default_rng(seed).integers(0, 256, shape, dtype=np.uint8)


@pytest.mark.parametrize("in_size,out_size", [(224, 256), (256, 224), (7, 3), (3, 7), (40, 40)])
def test_coefficients_match_jax(in_size, out_size):
    np.testing.assert_array_equal(pil_resize._pil_coeffs(in_size, out_size),
                                  jax_pil._pil_coeffs(in_size, out_size))


@pytest.mark.parametrize("h,w,oh,ow", SIZES)
def test_resize_matches_jax_and_pillow_bitwise(h, w, oh, ow):
    clip = _img((2, h, w, 3), seed=h + w)
    got = pil_resize.pil_resize_bilinear_u8(torch.from_numpy(clip), oh, ow)
    assert got.dtype == torch.uint8 and got.shape == (2, oh, ow, 3)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jax_pil.pil_resize_bilinear_u8(jnp.asarray(clip), oh, ow)))
    pillow = np.stack([np.asarray(PIL.fromarray(f).resize((ow, oh), PIL.Resampling.BILINEAR))
                       for f in clip])
    np.testing.assert_array_equal(got.numpy(), pillow)


@pytest.mark.parametrize("h,w,size,crop", [(40, 56, 37, 32), (48, 36, 64, 48), (32, 32, 32, 32)])
def test_hf_resize_center_crop_matches_jax(h, w, size, crop):
    video = _img((3, h, w, 3), seed=size)
    got = pil_resize.hf_resize_center_crop_u8(torch.from_numpy(video), size, crop)
    want = jax_pil.hf_resize_center_crop_u8(jnp.asarray(video), size, crop)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert pil_resize.hf_shortest_edge_size(h, w, size) == jax_pil.hf_shortest_edge_size(
        h, w, size)
    with pytest.raises(ValueError, match="smaller than crop"):
        pil_resize.hf_resize_center_crop_u8(torch.from_numpy(video), crop // 2, crop)


@pytest.mark.parametrize("regime", ["vivit", "timesformer"])
@pytest.mark.parametrize("shape,crop", [((2, 3, 40, 56, 3), 32), ((1, 2, 64, 48, 3), 48)])
def test_pil_exact_route_matches_jax(monkeypatch, regime, shape, crop):
    """``LARYNGEAL_PIL_EXACT=1`` routes the HF regimes through the Pillow
    resize, uint8 and float 0-255 input alike (the decoded wires' output)."""
    clips = _img(shape, seed=crop)
    monkeypatch.setenv("LARYNGEAL_PIL_EXACT", "1")
    want = np.asarray(jax_transforms.batch_preprocess(jnp.asarray(clips), regime, False,
                                                      crop=crop))
    for x in (torch.from_numpy(clips), torch.from_numpy(clips).float()):
        got = transforms.batch_preprocess(x, regime, crop=crop)
        assert got.dtype == torch.float32 and got.shape == (*shape[:2], crop, crop, 3)
        np.testing.assert_array_equal(got.numpy(), want)
