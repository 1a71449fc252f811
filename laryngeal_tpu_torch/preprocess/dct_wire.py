"""DCT wire format: transform-coded host->device clip transport (counterpart
of ``laryngeal_tpu/preprocess/dct_wire.py``).

Format (per clip, I420 geometry h x w, h and w multiples of 16):
  dc : int16 (T, NB)        DC coefficients (beyond int8's range)
  ac : int8  (K, T, NB)     AC planes in zigzag frequency order, coefficient-
                            major, so the zeros of one frequency are
                            contiguous across blocks and frames; K <= 63,
                            the trailing (highest-frequency) planes may be
                            dropped
  NB = (h/8)*(w/8) + 2*(h/16)*(w/16)   (Y blocks, then U, then V)

The host encodes JPEG-style (8x8 DCT-II, Annex K tables scaled by
``quality``, round half to even) with the native C++ encoder
(``data/native.py`` over ``native/cliploader.cpp``'s ``clip_dct_encode``) or,
where that is not built, with this module's numpy encoder, its exact
reference. The packed variant (``dctp``) nibble-packs the planes from
``pack_from`` on in pairs (``ac_pack_nibble``, or numpy). The device inverse
(``decode_to_rgb``, ``decode_to_rgb_packed``): the zigzag scatter, the
nibble unpack, dequantisation, the IDCT as one (rows, 64) x (64, 64) product,
round and clip to the uint8 reconstruction, then the BT.601 expansion of
``transforms.yuv_planes_to_rgb``, all in float32 on the payload's device.
"""

from __future__ import annotations

import logging
from functools import lru_cache
from typing import Tuple

import numpy as np
import torch

DEFAULT_QUALITY = 87
DEFAULT_KEEP_AC = 63
# Packed-wire default: zigzag planes from 14 on fit the signed 4-bit range
# on real clips at quality 75 almost everywhere (the JAX package's study).
DEFAULT_PACK_FROM = 14

# JPEG zigzag scan: ZIGZAG[i] = row-major index of the i-th coefficient in
# frequency order (ZIGZAG[0] == 0 is the DC).
ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63],
    np.int32)

# JPEG Annex K base tables (quality 50).
JPEG_LUMA_Q50 = np.array([
    16, 11, 10, 16, 24, 40, 51, 61,
    12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56,
    14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77,
    24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101,
    72, 92, 95, 98, 112, 100, 103, 99], np.float32).reshape(8, 8)
JPEG_CHROMA_Q50 = np.array([
    17, 18, 24, 47, 99, 99, 99, 99,
    18, 21, 26, 66, 99, 99, 99, 99,
    24, 26, 56, 99, 99, 99, 99, 99,
    47, 66, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99], np.float32).reshape(8, 8)

logger = logging.getLogger(__name__)


def quant_table(base: np.ndarray, quality: int) -> np.ndarray:
    """IJG quality scaling: floor((base*scale+50)/100), clamped to [1, 255];
    the native encoder's ``quant_recip`` computes the same table."""
    q = int(quality)
    if not 1 <= q <= 100:
        raise ValueError(f"quality must be in [1,100], got {quality}")
    scale = 5000.0 / q if q < 50 else 200.0 - 2.0 * q
    t = np.floor((base * scale + 50.0) / 100.0)
    return np.clip(t, 1.0, 255.0).astype(np.float32)


@lru_cache(maxsize=None)
def _dct_matrix() -> np.ndarray:
    """Orthonormal DCT-II matrix C (8, 8): coeffs = C @ x @ C.T."""
    k = np.arange(8)
    c = np.cos((2 * k[None, :] + 1) * k[:, None] * np.pi / 16)
    c = (c * np.sqrt(2.0 / 8)).astype(np.float32)
    c[0] *= np.float32(1.0 / np.sqrt(2.0))
    return c


@lru_cache(maxsize=None)
def _idct_kron() -> np.ndarray:
    """(64, 64) M with pixels_flat = coeffs_flat @ M (row-major 8x8
    flatten): M[(a, b), (u, v)] = C[a, u] * C[b, v] = kron(C, C)."""
    c = _dct_matrix()
    return np.kron(c, c).astype(np.float32)


def block_geometry(h: int, w: int) -> Tuple[int, int, int]:
    """(nb_luma, nb_chroma, nb_total) 8x8 block counts for I420 h x w."""
    if h % 16 or w % 16:
        raise ValueError(f"DCT wire needs h, w multiples of 16, got {h}x{w}")
    nby = (h // 8) * (w // 8)
    nbc = (h // 16) * (w // 16)
    return nby, nbc, nby + 2 * nbc


@lru_cache(maxsize=None)
def _dequant_scales(h: int, w: int, quality: int) -> np.ndarray:
    """(64, NB) per-block dequantisation scales (luma, then chroma)."""
    nby, nbc, nb = block_geometry(h, w)
    qy = quant_table(JPEG_LUMA_Q50, quality).reshape(64)
    qc = quant_table(JPEG_CHROMA_Q50, quality).reshape(64)
    scales = np.empty((64, nb), np.float32)
    scales[:, :nby] = qy[:, None]
    scales[:, nby:] = qc[:, None]
    return scales


# ---------------------------------------------------------------------------
# Host encode (numpy reference; the native encoder in data/native.py).
# ---------------------------------------------------------------------------

def _blockify(plane: np.ndarray) -> np.ndarray:
    """(T, H, W) -> (T, (H/8)*(W/8), 64) row-major 8x8 blocks."""
    t, h, w = plane.shape
    return (plane.reshape(t, h // 8, 8, w // 8, 8)
            .transpose(0, 1, 3, 2, 4).reshape(t, -1, 64))


def encode_clip_np(i420: np.ndarray, quality: int = DEFAULT_QUALITY,
                   keep_ac: int = DEFAULT_KEEP_AC):
    """uint8 I420 clip (T, H*3/2, W) -> (dc int16 (T, NB), ac int8
    (keep_ac, T, NB) in zigzag order): the native encoder's tables and
    rounding, vectorised over frames and blocks through the (64, 64) matrix."""
    t, h15, w = i420.shape
    h = h15 * 2 // 3
    block_geometry(h, w)
    y = i420[:, :h, :]
    u = i420[:, h:h + h // 4, :].reshape(t, h // 2, w // 2)
    v = i420[:, h + h // 4:, :].reshape(t, h // 2, w // 2)
    blocks = np.concatenate(
        [_blockify(y), _blockify(u), _blockify(v)], axis=1
    ).astype(np.float32) - 128.0                      # (T, NB, 64)
    # kron(C, C) is orthogonal: pixels @ M.T gives the coefficients.
    coeffs = blocks @ _idct_kron().T
    # The f32 reciprocal times the coefficient, as the native encoder does.
    recip = np.float32(1.0) / _dequant_scales(h, w, quality)  # (64, NB)
    q = np.rint(coeffs * recip.T[None])               # round half to even
    dc = q[..., 0].astype(np.int16)                   # (T, NB)
    ac = np.clip(q[..., ZIGZAG[1:keep_ac + 1]], -128, 127).astype(np.int8)
    return dc, np.ascontiguousarray(ac.transpose(2, 0, 1))


def pack_ac_planes(ac: np.ndarray, pack_from: int = DEFAULT_PACK_FROM):
    """AC planes (K, T, NB) int8 -> (ac_hi (P, T, NB) int8, ac_pk
    (ceil((K-P)/2), T, NB) uint8): the planes from ``pack_from`` on clamped
    to [-8, 7] and nibble-packed in pairs (the even plane in the low nibble;
    an odd last plane pairs with an implicit zero plane)."""
    k = ac.shape[0]
    p = max(0, min(int(pack_from), k))
    hi8 = np.ascontiguousarray(ac[:p])
    rest = ac[p:]
    if rest.shape[0] == 0:
        return hi8, np.zeros((0,) + ac.shape[1:], np.uint8)
    from ..data import native

    if native.available():
        return hi8, native.ac_pack(rest)
    rest = np.clip(rest.astype(np.int16), -8, 7)
    if rest.shape[0] % 2:
        rest = np.concatenate([rest, np.zeros((1,) + rest.shape[1:], np.int16)])
    packed = (rest[0::2] & 15) | ((rest[1::2] & 15) << 4)
    return hi8, packed.astype(np.uint8)


def unpack_ac_planes(ac_hi: np.ndarray, ac_pk: np.ndarray, k_total: int) -> np.ndarray:
    """Host inverse of :func:`pack_ac_planes`."""
    x = ac_pk.astype(np.int16)
    lo = ((x & 15) ^ 8) - 8
    hi = (((x >> 4) & 15) ^ 8) - 8
    inter = np.stack([lo, hi], axis=1).reshape((2 * ac_pk.shape[0],) + ac_pk.shape[1:])
    n_packed = k_total - ac_hi.shape[0]
    return np.concatenate([ac_hi.astype(np.int16), inter[:n_packed]]).astype(np.int8)


def encode_clip_packed(i420: np.ndarray, quality: int = DEFAULT_QUALITY,
                       keep_ac: int = DEFAULT_KEEP_AC, pack_from: int = DEFAULT_PACK_FROM):
    """:func:`encode_clip`, then :func:`pack_ac_planes`: the dctp triple
    (dc int16 (T, NB), ac_hi int8 (P, T, NB), ac_pk uint8 (Q, T, NB))."""
    dc, ac = encode_clip(i420, quality, keep_ac)
    ac_hi, ac_pk = pack_ac_planes(ac, pack_from)
    return dc, ac_hi, ac_pk


_native_encode_warned = False


def encode_clip(i420: np.ndarray, quality: int = DEFAULT_QUALITY,
                keep_ac: int = DEFAULT_KEEP_AC):
    """The native encoder where it is built, else the numpy one (they agree
    to +-1 on a few coefficients: float accumulation order). A native
    encoder that fails is reported once and the numpy one takes over, as in
    the JAX package."""
    from ..data import native

    if native.available():
        try:
            return native.dct_encode(i420, quality, keep_ac)
        except (RuntimeError, ValueError) as e:
            global _native_encode_warned
            if not _native_encode_warned:
                _native_encode_warned = True
                logger.warning("native clip_dct_encode failed (%s): falling back to the "
                               "numpy encoder (~10x slower a clip)", e)
    return encode_clip_np(i420, quality, keep_ac)


def decode_clip_np(dc: np.ndarray, ac: np.ndarray, h: int, w: int,
                   quality: int = DEFAULT_QUALITY) -> np.ndarray:
    """Host inverse -> uint8 I420 (T, H*3/2, W) (tests, PSNR)."""
    nby, nbc, nb = block_geometry(h, w)
    t, k = dc.shape[0], ac.shape[0]
    coeffs = np.zeros((64, t, nb), np.float32)
    coeffs[0] = dc.astype(np.float32)
    coeffs[ZIGZAG[1:k + 1]] = ac.astype(np.float32)
    coeffs *= _dequant_scales(h, w, quality)[:, None, :]
    pixels = np.einsum("ctn,cd->tnd", coeffs, _idct_kron()) + 128.0
    pixels = np.clip(np.rint(pixels), 0, 255).astype(np.uint8)

    def unb(blocks, ph, pw):
        return (blocks.reshape(t, ph // 8, pw // 8, 8, 8)
                .transpose(0, 1, 3, 2, 4).reshape(t, ph, pw))

    out = np.empty((t, h * 3 // 2, w), np.uint8)
    out[:, :h] = unb(pixels[:, :nby], h, w)
    out[:, h:h + h // 4] = unb(pixels[:, nby:nby + nbc], h // 2, w // 2).reshape(t, h // 4, w)
    out[:, h + h // 4:] = unb(pixels[:, nby + nbc:], h // 2, w // 2).reshape(t, h // 4, w)
    return out


# ---------------------------------------------------------------------------
# Device decode. Each function takes one clip (dc (T, NB)) or a batch
# (dc (B, T, NB)), with the AC planes' axis before T.
# ---------------------------------------------------------------------------

def _unblockify(blocks: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """(B, T, nblocks, 64) -> (B, T, H, W)."""
    b, t = blocks.shape[:2]
    return (blocks.reshape(b, t, h // 8, w // 8, 8, 8)
            .permute(0, 1, 2, 4, 3, 5).reshape(b, t, h, w))


def _zigzag(lo: int, hi: int, device) -> torch.Tensor:
    """Row-major coefficient indices of zigzag positions [lo, hi)."""
    return torch.as_tensor(ZIGZAG[lo:hi], dtype=torch.long, device=device)


def _coeffs(dc: torch.Tensor, nb: int):
    """(B, T, NB, 64) float32 zeros with the DC set, and whether ``dc`` was
    one clip."""
    one = dc.dim() == 2
    dc = dc[None] if one else dc
    coeffs = torch.zeros((*dc.shape, 64), dtype=torch.float32, device=dc.device)
    coeffs[..., 0] = dc.float()
    return coeffs, one


def _set_planes(coeffs: torch.Tensor, planes: torch.Tensor, first: int) -> None:
    """Scatter (B, k, T, NB) AC planes into zigzag positions first..first+k-1."""
    k = planes.shape[1]
    if k:
        coeffs[..., _zigzag(first, first + k, coeffs.device)] = \
            planes.float().permute(0, 2, 3, 1)


def decode_to_rgb(dc: torch.Tensor, ac: torch.Tensor, h: int, w: int,
                  quality: int = DEFAULT_QUALITY) -> torch.Tensor:
    """(dc (T, NB) int16, ac (K, T, NB) int8 zigzag), or a batch of them ->
    RGB float32 (..., T, H, W, 3), 0-255. Planes past K decode as zeros."""
    nb = block_geometry(h, w)[2]
    coeffs, one = _coeffs(dc, nb)
    _set_planes(coeffs, ac[None] if one else ac, 1)
    rgb = _coeffs_to_rgb(coeffs, h, w, quality)
    return rgb[0] if one else rgb


def decode_to_rgb_packed(dc: torch.Tensor, ac_hi: torch.Tensor, ac_pk: torch.Tensor,
                         h: int, w: int, quality: int = DEFAULT_QUALITY,
                         k_total: int = DEFAULT_KEEP_AC) -> torch.Tensor:
    """Inverse of :func:`encode_clip_packed`: the first P = ``ac_hi``'s
    plane count zigzag AC planes arrive int8, the other ``k_total - P``
    nibble-packed in pairs in ``ac_pk`` (the even plane in the low nibble,
    two's complement 4-bit: ((x & 15) ^ 8) - 8)."""
    nb = block_geometry(h, w)[2]
    coeffs, one = _coeffs(dc, nb)
    if one:
        ac_hi, ac_pk = ac_hi[None], ac_pk[None]
    p = ac_hi.shape[1]
    _set_planes(coeffs, ac_hi, 1)
    n_packed = k_total - p
    if n_packed:
        x = ac_pk.to(torch.int32)
        lo = ((x & 15) ^ 8) - 8
        hi = (((x >> 4) & 15) ^ 8) - 8
        b, q = x.shape[:2]
        inter = torch.stack([lo, hi], dim=2).reshape(b, 2 * q, *x.shape[2:])[:, :n_packed]
        _set_planes(coeffs, inter, p + 1)
    rgb = _coeffs_to_rgb(coeffs, h, w, quality)
    return rgb[0] if one else rgb


@lru_cache(maxsize=16)
def _device_tables(h: int, w: int, quality: int, device: str):
    """(dequantisation scales (NB, 64), IDCT matrix (64, 64)) on ``device``."""
    scales = torch.from_numpy(np.ascontiguousarray(_dequant_scales(h, w, quality).T))
    return scales.to(device), torch.from_numpy(_idct_kron()).to(device)


def _coeffs_to_rgb(coeffs: torch.Tensor, h: int, w: int, quality: int) -> torch.Tensor:
    """(B, T, NB, 64) coefficients -> dequantise -> one (rows, 64) x (64, 64)
    IDCT product -> round and clip (the uint8 reconstruction) -> planes ->
    BT.601 RGB."""
    from .transforms import yuv_planes_to_rgb

    nby, nbc, _ = block_geometry(h, w)
    scales, idct = _device_tables(h, w, quality, str(coeffs.device))
    pixels = torch.matmul(coeffs * scales, idct) + 128.0
    pixels = torch.clamp(torch.round(pixels), 0.0, 255.0)
    y = _unblockify(pixels[:, :, :nby], h, w)
    u = _unblockify(pixels[:, :, nby:nby + nbc], h // 2, w // 2)
    v = _unblockify(pixels[:, :, nby + nbc:], h // 2, w // 2)
    return yuv_planes_to_rgb(y, u, v)
