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
-> Normalize, one draw per sample from an explicit ``torch.Generator``), the
bit-exact Pillow resize of the HF regimes (``LARYNGEAL_PIL_EXACT=1``,
``preprocess/pil_resize.py``) and the five host->device wire formats
(``decode_wire_batch``: rgb passes through; i420, delta, dct and dctp decode
to RGB on the payload's device, the BT.601 constants in
``yuv_planes_to_rgb`` alone). The HF regimes have no train-mode
augmentation, in the reference either.

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

from . import dct_wire
from .pil_resize import hf_resize_center_crop_u8

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
        # The bit-exact Pillow 8-bit resample of the HF processors (read at
        # each call, as the JAX package reads it at trace time): integer
        # coefficients, a uint8 round trip between the passes; a parity
        # tool, not the fast path.
        size = scale(256) if regime == "vivit" else crop
        u8 = torch.clamp(torch.round(clips_u8.float()), 0, 255).to(torch.uint8)
        v = hf_resize_center_crop_u8(u8, size, crop).float()
        if regime == "vivit":
            return v * (4.0 / 255.0) - 3.0
        return v * (2.0 / 255.0) - 1.0
    if regime == "timesformer":
        return timesformer_pixels(clips_u8, crop=crop, size=crop)
    return vivit_pixels(clips_u8, crop=crop, size=scale(256))


WIRES = ("rgb", "i420", "delta", "dct", "dctp")


def temporal_delta_encode(clip_u8: np.ndarray) -> np.ndarray:
    """Host side (numpy): uint8 clip (T, ...) -> mod-256 temporal deltas,
    frame 0 unchanged, delta[t] = frame[t] - frame[t-1] (uint8 wraps)."""
    out = clip_u8.copy()
    out[1:] = clip_u8[1:] - clip_u8[:-1]
    return out


def encode_wire(i420: np.ndarray, wire: str, quality: int = 75, keep_ac: int = 31,
                pack_from: int = 14):
    """Host side: one I420 clip (T, H*3/2, W) -> its payload on ``wire``
    (i420: the clip itself; delta: its temporal deltas; dct: (dc, ac);
    dctp: (dc, ac_hi, ac_pk))."""
    if wire == "i420":
        return i420
    if wire == "delta":
        return temporal_delta_encode(i420)
    if wire == "dct":
        return dct_wire.encode_clip(i420, quality, keep_ac)
    if wire == "dctp":
        return dct_wire.encode_clip_packed(i420, quality, keep_ac, pack_from)
    raise ValueError(f"unknown wire {wire!r}")


def temporal_delta_decode(delta_u8: torch.Tensor, axis: int = 0) -> torch.Tensor:
    """Device side: the exact inverse of ``temporal_delta_encode``, a
    running sum along ``axis`` taken modulo 256."""
    total = torch.cumsum(delta_u8, dim=axis, dtype=torch.int32)
    return torch.bitwise_and(total, 255).to(torch.uint8)


def yuv420_to_rgb(yuv: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """I420 planar uint8 (..., T, H*3/2, W) -> RGB float32 (..., T, H, W, 3),
    0-255. U and V are each (H/4, W) rows reshaped to (H/2, W/2), the
    layout cv2's ``COLOR_RGB2YUV_I420`` writes."""
    h, w = height, width
    lead = yuv.shape[:-2]
    y = yuv[..., :h, :].float()
    u = yuv[..., h:h + h // 4, :].reshape(*lead, h // 2, w // 2).float()
    v = yuv[..., h + h // 4:, :].reshape(*lead, h // 2, w // 2).float()
    return yuv_planes_to_rgb(y, u, v)


def yuv_planes_to_rgb(y: torch.Tensor, u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """BT.601 video-range planes (Y (..., H, W), U and V (..., H/2, W/2),
    float32) -> RGB float32 (..., H, W, 3) clipped to 0-255, chroma
    upsampled by nearest neighbour. The one copy of the conversion: the
    i420 / delta wires and the dct / dctp wires (``dct_wire``) both decode
    through it."""
    u = u.repeat_interleave(2, dim=-2).repeat_interleave(2, dim=-1)
    v = v.repeat_interleave(2, dim=-2).repeat_interleave(2, dim=-1)
    yf = 1.164383 * (y - 16.0)
    uf = u - 128.0
    vf = v - 128.0
    r = yf + 1.596027 * vf
    g = yf - 0.391762 * uf - 0.812968 * vf
    b = yf + 2.017232 * uf
    return torch.clamp(torch.stack([r, g, b], dim=-1), 0.0, 255.0)


def check_wire(wire: str, wire_hw=None) -> None:
    """The refusals of the JAX ``decode_wire_batch``: an unknown wire, and
    dct / dctp without their static geometry ``wire_hw=(h, w)`` (multiples
    of 16)."""
    if wire not in WIRES:
        raise ValueError(f"Unknown wire format {wire!r}")
    if wire in ("dct", "dctp"):
        if wire_hw is None:
            raise ValueError(f"wire={wire!r} needs wire_hw=(h, w) (static geometry)")
        dct_wire.block_geometry(int(wire_hw[0]), int(wire_hw[1]))


def decode_wire_batch(pixel, wire: str = "rgb", wire_hw=None, wire_quality: int = 75,
                      wire_keep_ac: int = 31):
    """Wire payload -> RGB clip batch, on the payload's device:

    - rgb: (B, T, H, W, 3) uint8, passed through;
    - i420: (B, T, H*3/2, W) uint8 4:2:0 planes;
    - delta: i420 as mod-256 temporal deltas;
    - dct: (dc (B, T, NB) int16, ac (B, K, T, NB) int8) quantized DCT planes
      in zigzag order (``preprocess/dct_wire.py``), needs ``wire_hw=(h, w)``;
    - dctp: (dc, ac_hi (B, P, T, NB) int8, ac_pk (B, Q, T, NB) uint8), the
      planes from ``P + 1`` on nibble-packed in pairs; needs ``wire_hw`` and
      ``wire_keep_ac``, the total AC plane count.

    Returns the uint8 clip (rgb) or float32 0-255 (the decoded wires); every
    preprocessing regime takes either."""
    check_wire(wire, wire_hw)
    if wire == "rgb":
        return pixel
    if wire in ("i420", "delta"):
        x = temporal_delta_decode(pixel, axis=1) if wire == "delta" else pixel
        return yuv420_to_rgb(x, x.shape[2] * 2 // 3, x.shape[3])
    h, w = int(wire_hw[0]), int(wire_hw[1])
    if wire == "dct":
        dc, ac = pixel
        return dct_wire.decode_to_rgb(dc, ac, h, w, int(wire_quality))
    dc, ac_hi, ac_pk = pixel
    return dct_wire.decode_to_rgb_packed(dc, ac_hi, ac_pk, h, w, int(wire_quality),
                                         int(wire_keep_ac))
