"""Clip preprocessing on the device (counterpart of
``laryngeal_tpu/preprocess/transforms.py``).

Ported: the ViViT regime (VivitImageProcessor semantics: resize shortest
edge 256 -> center crop 224 -> rescale 2/255 with offset -1 -> normalize
(.5, .5), net affine 4x/255 - 3), the TimeSformer regime
(VideoMAEImageProcessor semantics: shortest edge 224 -> center crop 224 ->
x/255 -> normalize (.5, .5), net affine 2x/255 - 1), the pytorchvideo
regime of the CNN and Swin3D pipelines (eval: ShortSideScale(256) ->
CenterCrop(224) -> Normalize(.45, .225), antialias off; train:
RandomShortSideScale(256, 320) -> RandomCrop(224) -> RandomHorizontalFlip(.5)
-> Normalize, one draw per sample from an explicit ``torch.Generator``) and
the rgb wire. Train-mode augmentation of the HF regimes (which have none in
the reference either), the bit-exact Pillow resize (``LARYNGEAL_PIL_EXACT``)
and the i420/delta/dct/dctp wires are not yet ported (ROADMAP.md).

The geometric chain *scale by f, then crop at an offset* is one linear
resample per axis, as ``jax.image.scale_and_translate(method="linear")``
computes it: for each spatial axis an (in, out) weight matrix built with
JAX's sample-centre and renormalisation rules (``compute_weight_mat`` in
``jax/_src/image/scale.py``), applied as a matmul. Those rules differ from
``F.interpolate``'s, hence the explicit matrices.
"""

from __future__ import annotations

import functools
import os
from typing import Sequence, Tuple

import numpy as np
import torch

_F32_EPS = float(np.finfo(np.float32).eps)


def _f32(x) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32)


def compute_weight_mat(input_size: int, output_size: int, scale: torch.Tensor,
                       translation: torch.Tensor, antialias: bool) -> torch.Tensor:
    """(input_size, output_size) float32 triangle-kernel weights, exactly as
    JAX's ``compute_weight_mat`` with ``method="linear"``: sample centres at
    (i + 0.5) / scale - translation / scale - 0.5, the kernel widened by
    1/scale when downsampling with antialias, columns renormalised to sum to
    1, and samples outside the input zeroed."""
    inv_scale = 1.0 / scale
    kernel_scale = torch.clamp(inv_scale, min=1.0) if antialias else _f32(1.0)
    sample_f = ((torch.arange(output_size, dtype=torch.float32) + 0.5) * inv_scale
                - translation * inv_scale - 0.5)
    x = (torch.abs(sample_f[None, :] - torch.arange(input_size, dtype=torch.float32)[:, None])
         / kernel_scale)
    weights = torch.clamp(1.0 - torch.abs(x), min=0.0)
    total = weights.sum(dim=0, keepdim=True)
    weights = torch.where(total.abs() > 1000.0 * _F32_EPS,
                          weights / torch.where(total != 0, total, _f32(1.0)),
                          _f32(0.0))
    inside = (sample_f >= -0.5) & (sample_f <= input_size - 0.5)
    return torch.where(inside[None, :], weights, _f32(0.0))


@functools.lru_cache(maxsize=64)
def _crop_weights(h: int, w: int, size: int, crop: int, antialias: bool):
    """Weights of ShortSideScale(size) + CenterCrop(crop), on the CPU."""
    f = _f32(size) / _f32(min(h, w))
    new_h, new_w = h * f, w * f
    off_y, off_x = (new_h - crop) / 2.0, (new_w - crop) / 2.0
    return (compute_weight_mat(h, crop, f, -off_y, antialias),
            compute_weight_mat(w, crop, f, -off_x, antialias))


def _resample(video: torch.Tensor, wy: torch.Tensor, wx: torch.Tensor) -> torch.Tensor:
    """(..., H, W, C) float32 -> (..., out_h, out_w, C) with per-axis weights."""
    wy = wy.to(video.device)
    wx = wx.to(video.device)
    x = torch.einsum("...hwc,hy->...ywc", video, wy)
    return torch.einsum("...ywc,wx->...yxc", x, wx)


def scale_crop(video: torch.Tensor, scale: float, offset_yx: Sequence[float],
               out_hw: Tuple[int, int] = (224, 224), antialias: bool = False) -> torch.Tensor:
    """Resize by ``scale`` then crop at ``offset_yx`` (scaled coordinates):
    (T, H, W, C) -> (T, out_h, out_w, C) float32."""
    video = video.float()
    h, w = video.shape[-3], video.shape[-2]
    s = _f32(scale)
    wy = compute_weight_mat(h, out_hw[0], s, -_f32(offset_yx[0]), antialias)
    wx = compute_weight_mat(w, out_hw[1], s, -_f32(offset_yx[1]), antialias)
    return _resample(video, wy, wx)


def center_crop_scale(video: torch.Tensor, size: int = 256, crop: int = 224,
                      antialias: bool = False) -> torch.Tensor:
    """ShortSideScale(size) + CenterCrop(crop) as one resample; works on a
    clip (T, H, W, C) or a batch (B, T, H, W, C)."""
    video = video.float()
    h, w = video.shape[-3], video.shape[-2]
    wy, wx = _crop_weights(int(h), int(w), int(size), int(crop), bool(antialias))
    return _resample(video, wy, wx)


def vivit_pixels(video_u8: torch.Tensor, crop: int = 224, size: int = 256) -> torch.Tensor:
    """VivitImageProcessor semantics: shortest-edge 256 -> center crop 224 ->
    rescale 2/255 with offset -> normalize(.5, .5). Net affine: 4x/255 - 3."""
    v = center_crop_scale(video_u8, size, crop, antialias=True)
    return v * (4.0 / 255.0) - 3.0


def timesformer_pixels(video_u8: torch.Tensor, crop: int = 224, size: int = 224) -> torch.Tensor:
    """VideoMAEImageProcessor semantics (the TimeSformer trainer's): shortest
    edge 224 -> center crop 224 -> x/255 -> normalize(.5, .5). Net affine:
    2x/255 - 1."""
    v = center_crop_scale(video_u8, size, crop, antialias=True)
    return v * (2.0 / 255.0) - 1.0


PTV_MEAN = 0.45  # pytorchvideo Normalize (resnet50-2d-lstm/inference.py:37-38)
PTV_STD = 0.225


def ptv_normalize(v: torch.Tensor) -> torch.Tensor:
    """(x / 255 - mean) / std, float32."""
    return (v.float() / 255.0 - PTV_MEAN) / PTV_STD


def pytorchvideo_eval(video_u8: torch.Tensor, crop: int = 224, size: int = 256) -> torch.Tensor:
    """Eval transform of the pytorchvideo regime: ShortSideScale(size) +
    CenterCrop(crop), antialias off (F.interpolate bilinear), Normalize;
    a clip (T, H, W, C) or a batch."""
    return ptv_normalize(center_crop_scale(video_u8, size, crop, antialias=False))


def _scale_crop_weights(h: int, w: int, draw, crop: int):
    """(wy (h, crop), wx (w, crop)) of RandomShortSideScale + RandomCrop +
    RandomHorizontalFlip at one draw (size, u_y, u_x, flip), on the CPU:
    the short side scaled to the integer ``size``, integer crop offsets
    floor(u * (max + 1)) with max = max(floor(scaled side) - crop, 0), the
    JAX ``random_scale_crop``'s f32 arithmetic (``transforms.py:96-120``).
    A flip reverses wx's columns: each output pixel is the same weighted sum,
    stored mirrored, as flipping the resampled clip would store it."""
    size, u_y, u_x, flip = draw
    f = _f32(size) / _f32(min(h, w))
    max_y = torch.clamp(torch.floor(h * f) - crop, min=0.0)
    max_x = torch.clamp(torch.floor(w * f) - crop, min=0.0)
    oy = torch.floor(_f32(u_y) * (max_y + 1.0))
    ox = torch.floor(_f32(u_x) * (max_x + 1.0))
    wy = compute_weight_mat(h, crop, f, -oy, False)
    wx = compute_weight_mat(w, crop, f, -ox, False)
    return wy, (wx.flip(-1) if flip else wx)


def draw_pytorchvideo(generator: torch.Generator, batch: int, min_size: int = 256,
                      max_size: int = 320):
    """One draw per sample: (short side, u_y, u_x, flip), the side an integer
    uniform in [min_size, max_size], u uniform in [0, 1), flip with
    probability 0.5."""
    sizes = torch.randint(min_size, max_size + 1, (batch,), generator=generator)
    u = torch.rand((batch, 3), generator=generator)
    return [(int(sizes[i]), float(u[i, 0]), float(u[i, 1]), bool(u[i, 2] < 0.5))
            for i in range(batch)]


def pytorchvideo_train(clips_u8: torch.Tensor, draws, crop: int = 224) -> torch.Tensor:
    """Train transform of the pytorchvideo regime for a batch (B, T, H, W, C)
    at one ``draw_pytorchvideo`` draw per clip: scale and crop, flip,
    Normalize. The per-clip weights are built on the CPU and go to the
    clips' device in one copy per axis; the resample is two batched
    matmuls."""
    h, w = clips_u8.shape[-3], clips_u8.shape[-2]
    pairs = [_scale_crop_weights(h, w, d, crop) for d in draws]
    wy = torch.stack([p[0] for p in pairs]).to(clips_u8.device)
    wx = torch.stack([p[1] for p in pairs]).to(clips_u8.device)
    x = torch.einsum("bthwc,bhy->btywc", clips_u8.float(), wy)
    return ptv_normalize(torch.einsum("btywc,bwx->btyxc", x, wx))


def batch_preprocess(clips_u8: torch.Tensor, regime: str, train: bool = False,
                     crop: int = 224, generator: torch.Generator = None) -> torch.Tensor:
    """(B, T, H, W, C) uint8 (or float 0-255) -> (B, T, crop, crop, C) float32.

    ``crop`` scales the whole geometry proportionally (224 in every reference
    config; smaller values keep tests cheap). Train mode augments the
    pytorchvideo regime only and needs ``generator`` (CPU), from which each
    sample takes its own draw. The vivit and timesformer regimes (the HF
    processors) have no augmentation: train mode returns their eval pixels,
    as the JAX function does."""
    scale = lambda v: max(1, int(round(v * crop / 224)))
    if regime == "pytorchvideo":
        if not train:
            return pytorchvideo_eval(clips_u8, crop=crop, size=scale(256))
        if generator is None:
            raise ValueError("train-mode preprocessing needs a torch.Generator")
        draws = draw_pytorchvideo(generator, clips_u8.shape[0], scale(256), scale(320))
        return pytorchvideo_train(clips_u8, draws, crop)
    if regime not in ("vivit", "timesformer"):
        raise ValueError(f"Unknown preprocessing regime {regime!r}")
    if os.environ.get("LARYNGEAL_PIL_EXACT") == "1":
        raise NotImplementedError(
            "LARYNGEAL_PIL_EXACT (the bit-exact Pillow resize) is not yet "
            "ported, see ROADMAP.md")
    if regime == "timesformer":
        return timesformer_pixels(clips_u8, crop=crop, size=crop)
    return vivit_pixels(clips_u8, crop=crop, size=scale(256))


def decode_wire_batch(pixel, wire: str = "rgb"):
    """Wire payload -> RGB clip batch. Only the rgb wire (a (B,T,H,W,3) uint8
    passthrough) is ported."""
    if wire == "rgb":
        return pixel
    raise NotImplementedError(
        f"wire format {wire!r} is not yet ported to laryngeal_tpu_torch, see ROADMAP.md")
