"""Bit-exact Pillow 8-bit bilinear resampling (counterpart of
``laryngeal_tpu/preprocess/pil_resize.py``).

The HF image processors of the reference resize each frame with
``PIL.Image.resize(..., BILINEAR)``, whose 8-bit path is not a float
separable bilinear:

- its coefficients are fixed point, ``int(0.5 + w * 2^22)`` (PRECISION_BITS =
  32 - 8 - 2), normalised in double before they are quantised;
- it resamples horizontally, clips the intermediate back to uint8
  (``clip8((ss + 2^21) >> 22)``), then vertically;
- its support widens with the downscale factor (antialias always on).

This module reproduces Pillow's ``ImagingResampleHorizontal_8bpc`` /
``..Vertical_8bpc`` (the coefficients as ``precompute_coeffs`` /
``normalize_coeffs_8bpc`` in ``src/libImaging/Resample.c`` make them) with
dense coefficient matrices. The products run in float64 on the input's
device: every term and partial sum is an integer below 2^31, so the sums are
exact in any order, and the result is Pillow's integer one. Opt in with
``LARYNGEAL_PIL_EXACT=1`` (``preprocess.transforms.batch_preprocess``).
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

PRECISION_BITS = 32 - 8 - 2  # Pillow Resample.c


@lru_cache(maxsize=128)
def _pil_coeffs(in_size: int, out_size: int) -> np.ndarray:
    """Dense (out_size, in_size) int32 fixed-point bilinear coefficients,
    Pillow's precompute_coeffs + normalize_coeffs_8bpc for the triangle
    filter."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = 1.0 * filterscale  # bilinear support = 1.0
    ss = 1.0 / filterscale
    k = np.zeros((out_size, in_size), np.int32)
    for xx in range(out_size):
        center = (xx + 0.5) * scale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), in_size)
        n = xmax - xmin
        w = np.empty(n, np.float64)
        for x in range(n):
            arg = (x + xmin - center + 0.5) * ss
            w[x] = (1.0 - abs(arg)) if abs(arg) < 1.0 else 0.0
        tot = w.sum()
        if tot != 0.0:
            w /= tot
        for x in range(n):
            v = w[x] * (1 << PRECISION_BITS)
            k[xx, xmin + x] = np.int32(int(v - 0.5) if v < 0 else int(v + 0.5))
    return k


def _clip8(ss: torch.Tensor) -> torch.Tensor:
    """Pillow clip8: (ss >> 22) clamped to [0, 255] (ss carries +2^21)."""
    return torch.clamp(ss >> PRECISION_BITS, 0, 255).to(torch.uint8)


def pil_resize_bilinear_u8(img_u8: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """(..., H, W, C) uint8 -> (..., out_h, out_w, C) uint8, bit-exact
    Pillow BILINEAR: the horizontal pass first, a uint8 intermediate, then
    the vertical one."""
    h, w = img_u8.shape[-3], img_u8.shape[-2]
    dev = img_u8.device
    kx = torch.from_numpy(_pil_coeffs(w, out_w)).to(dev, torch.float64)  # (out_w, w)
    ky = torch.from_numpy(_pil_coeffs(h, out_h)).to(dev, torch.float64)  # (out_h, h)
    half = 1 << (PRECISION_BITS - 1)
    ss = torch.einsum("...hwc,ow->...hoc", img_u8.to(torch.float64), kx)
    tmp = _clip8(ss.to(torch.int64) + half)
    ss = torch.einsum("...hwc,oh->...owc", tmp.to(torch.float64), ky)
    return _clip8(ss.to(torch.int64) + half)


def hf_shortest_edge_size(h: int, w: int, size: int) -> tuple:
    """transformers.get_resize_output_image_size(default_to_square=False):
    the shortest edge -> ``size``, the long edge floor-scaled."""
    short, long = (h, w) if h <= w else (w, h)
    new_short, new_long = size, int(size * long / short)
    return (new_short, new_long) if h <= w else (new_long, new_short)


def hf_resize_center_crop_u8(video_u8: torch.Tensor, size: int, crop: int) -> torch.Tensor:
    """(..., T, H, W, C) uint8 -> (..., T, crop, crop, C) uint8 with the HF
    processor's geometry: the Pillow bilinear shortest-edge resize to
    ``size``, then the integer centre crop (top = (new_h - crop) // 2)."""
    h, w = video_u8.shape[-3], video_u8.shape[-2]
    new_h, new_w = hf_shortest_edge_size(h, w, size)
    if new_h < crop or new_w < crop:
        raise ValueError(
            f"resized {new_h}x{new_w} smaller than crop {crop} — the HF pad-then-crop "
            f"branch is not implemented (not reachable at the reference geometries)")
    resized = pil_resize_bilinear_u8(video_u8, new_h, new_w)
    top = (new_h - crop) // 2
    left = (new_w - crop) // 2
    return resized[..., top:top + crop, left:left + crop, :]
