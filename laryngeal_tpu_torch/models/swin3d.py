"""Video Swin Transformer 3D (tiny/small/base) — PyTorch.

Counterpart of ``laryngeal_tpu/models/swin3d.py``: architectural parity with
torchvision's ``swin3d_t/s/b`` (the reference's
``videoswintransformer/swin_video_classifier/models/swin3d.py:7-53``, the
head replaced by ``nn.Linear(in, num_classes)``):

- PatchEmbed3d: Conv3d kernel = stride = (2, 4, 4) + LayerNorm;
- 4 stages of Swin blocks, window (8, 7, 7), alternating shift (0, 0, 0) /
  (4, 3, 3); PatchMerging (2x2 spatial concat -> LN -> Linear 4C -> 2C, no
  bias) between stages;
- per-window MHA with a learned relative-position-bias table and
  shifted-window region masks; pre-LN blocks with MLP ratio 4 (exact gelu),
  stochastic depth linearly scaled across blocks (train only);
- head: LayerNorm -> mean over (T, H, W) -> Linear.

Window sizes clamp (and their shifts go to 0) where an input dim is not
larger than the window, as torchvision does. Every block's attention goes
through ``ops.attention.window_attention`` with the bias factored as the
(H, N, N) gather of the table and the (nW, N) region ids, so on the card it
takes kernel 8 (and kernel 9 under autograd) and the (B·nW, H, N, N)
broadcast never exists.

- Input is channels-last (B, T, H, W, C), as in the JAX package.
- Parameter names are torchvision's (``patch_embed.proj``,
  ``features.{2s}.{i}.attn.qkv``, ``...attn.relative_position_bias_table``,
  ``mlp.0`` / ``mlp.3``, ``features.{2s+1}.reduction``, ``norm``, ``head``),
  so ``laryngeal_tpu/compat/torch_port.py::port_swin3d`` reads a
  ``state_dict()`` directly and ``compat/flax_weights.py`` maps the JAX
  params across.
- Precision follows Flax's ``dtype``: parameters stay float32; the
  convolution and the projections compute in ``config.dtype``, attention in
  the projections' dtype; LayerNorms compute in float32 and the head returns
  float32.
- ``DropPath`` draws from an explicit ``torch.Generator`` handed to the
  forward; without one (eval, or rate 0) it is the identity.
- Not yet ported: ``remat`` (per-block rematerialisation) raises.
"""

from __future__ import annotations

import dataclasses
import itertools
import math
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import window_attention
from .layers import Dense, LayerNorm, gelu_exact


def adjust_window(size_dhw, window, shift):
    """Clamp the window to the input size and zero the shift on clamped
    dims (torchvision's get_window_size)."""
    win, sh = list(window), list(shift)
    for i in range(3):
        if size_dhw[i] <= window[i]:
            win[i] = size_dhw[i]
            sh[i] = 0
    return tuple(win), tuple(sh)


def relative_position_index(window, full_window=None) -> np.ndarray:
    """(N, N) linearised relative-coordinate index (torchvision layout).

    ``full_window`` sets the table's coordinate strides: a clamped runtime
    window still addresses the full-window table, so the parameters do not
    depend on the input size."""
    wt, wh, ww = window
    ft, fh, fw = full_window or window
    coords = np.stack(
        np.meshgrid(np.arange(wt), np.arange(wh), np.arange(ww), indexing="ij")
    ).reshape(3, -1)
    rel = (coords[:, :, None] - coords[:, None, :]).transpose(1, 2, 0).astype(np.int64)
    rel[:, :, 0] += ft - 1
    rel[:, :, 1] += fh - 1
    rel[:, :, 2] += fw - 1
    rel[:, :, 0] *= (2 * fh - 1) * (2 * fw - 1)
    rel[:, :, 1] *= 2 * fw - 1
    return rel.sum(-1)


def shift_region_ids(padded_dhw, window, shift) -> np.ndarray:
    """(num_windows, N) int32 region labels for shifted-window masking: two
    positions of a window attend to each other unmasked iff their labels
    match (the kernels add -100 otherwise)."""
    tp, hp, wp = padded_dhw
    img = np.zeros((tp, hp, wp), dtype=np.int32)
    segs = []
    for dim, w, s in zip((tp, hp, wp), window, shift):
        segs.append([slice(0, dim)] if s == 0 else
                    [slice(0, dim - w), slice(dim - w, dim - s), slice(dim - s, dim)])
    for cnt, (st, sh, sw) in enumerate(itertools.product(*segs)):
        img[st, sh, sw] = cnt
    wt, wh, ww = window
    wins = img.reshape(tp // wt, wt, hp // wh, wh, wp // ww, ww)
    return wins.transpose(0, 2, 4, 1, 3, 5).reshape(-1, wt * wh * ww)


def window_partition(x: torch.Tensor, window) -> torch.Tensor:
    """(B, T, H, W, C) -> (B·nW, N, C), windows batch-outer."""
    b, t, h, w, c = x.shape
    wt, wh, ww = window
    x = x.reshape(b, t // wt, wt, h // wh, wh, w // ww, ww, c)
    return x.permute(0, 1, 3, 5, 2, 4, 6, 7).reshape(-1, wt * wh * ww, c)


def window_merge(x: torch.Tensor, window, dims, batch: int) -> torch.Tensor:
    """The inverse of ``window_partition``."""
    t, h, w = dims
    wt, wh, ww = window
    x = x.reshape(batch, t // wt, h // wh, w // ww, wt, wh, ww, x.shape[-1])
    return x.permute(0, 1, 4, 2, 5, 3, 6, 7).reshape(batch, t, h, w, -1)


class WindowAttention3D(nn.Module):
    """torchvision's ``ShiftedWindowAttention3d`` parameters: ``qkv``,
    ``proj`` and ``relative_position_bias_table`` ((2wt-1)(2wh-1)(2ww-1), H),
    sized by the configured window."""

    def __init__(self, dim: int, num_heads: int, window, dtype: torch.dtype):
        super().__init__()
        self.dim, self.num_heads, self.window = dim, num_heads, tuple(window)
        wt, wh, ww = window
        self.qkv = Dense(dim, 3 * dim, True, dtype)
        self.proj = Dense(dim, dim, True, dtype)
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * wt - 1) * (2 * wh - 1) * (2 * ww - 1), num_heads))
        self._index = {}

    def _bias(self, window) -> torch.Tensor:
        """(H, N, N) f32 gather of the table for the runtime window; autograd
        scatters dbias back into the table. The index is made once per window
        and device."""
        table = self.relative_position_bias_table
        key = (window, str(table.device))
        if key not in self._index:
            idx = relative_position_index(window, self.window).reshape(-1)
            self._index[key] = torch.from_numpy(idx).to(table.device)
        idx = self._index[key]
        n = math.prod(window)
        return table[idx].reshape(n, n, self.num_heads).permute(2, 0, 1)

    def forward(self, x: torch.Tensor, window, region_id: Optional[torch.Tensor]) -> torch.Tensor:
        """x: (B·nW, N, C) -> (B·nW, N, C); q, k and v are strided views of
        the fused qkv projection, read in place by the kernels."""
        bnw, n, c = x.shape
        qkv = self.qkv(x).reshape(bnw, n, 3, self.num_heads, c // self.num_heads)
        q, k, v = qkv.unbind(2)
        out = window_attention(q, k, v, self._bias(window), region_id)
        return self.proj(out.reshape(bnw, n, c))


class DropPath(nn.Module):
    """Stochastic depth per sample: a row kept with probability 1 - rate is
    scaled by 1 / (1 - rate), else zeroed (the JAX ``DropPath``). Draws come
    from the generator passed in; with none, or rate 0, the identity."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = float(rate)

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        if generator is None or self.rate <= 0.0:
            return x
        keep = 1.0 - self.rate
        u = torch.rand((x.shape[0],) + (1,) * (x.ndim - 1), generator=generator,
                       device=generator.device)
        return torch.where(u.to(x.device) < keep, x / keep, torch.zeros((), dtype=x.dtype,
                                                                       device=x.device))


class _Mlp(nn.ModuleDict):
    """fc1 -> exact gelu -> fc2 under torchvision's MLP numbering, ``mlp.0``
    and ``mlp.3`` (its gelu and zero-rate dropouts hold no parameters)."""

    def __init__(self, dim: int, hidden: int, dtype):
        super().__init__({"0": Dense(dim, hidden, True, dtype), "3": Dense(hidden, dim, True, dtype)})

    def forward(self, x):
        return self["3"](gelu_exact(self["0"](x)))


class SwinBlock3D(nn.Module):
    def __init__(self, dim: int, num_heads: int, window, shift, mlp_ratio: float,
                 drop_path: float, dtype):
        super().__init__()
        self.window, self.shift = tuple(window), tuple(shift)
        self.norm1 = LayerNorm(dim, eps=1e-5)
        self.attn = WindowAttention3D(dim, num_heads, window, dtype)
        self.norm2 = LayerNorm(dim, eps=1e-5)
        self.mlp = _Mlp(dim, int(dim * mlp_ratio), dtype)
        self.drop_path = DropPath(drop_path)
        self._region_ids = {}

    def _region_id(self, padded, window, shift, device) -> Optional[torch.Tensor]:
        if not any(shift):
            return None
        key = (padded, window, shift, str(device))
        if key not in self._region_ids:
            self._region_ids[key] = torch.from_numpy(
                shift_region_ids(padded, window, shift)).to(device)
        return self._region_ids[key]

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        b, t, h, w, _ = x.shape
        window, shift = adjust_window((t, h, w), self.window, self.shift)
        wt, wh, ww = window
        hx = self.norm1(x)
        pt, ph, pw = (wt - t % wt) % wt, (wh - h % wh) % wh, (ww - w % ww) % ww
        hx = F.pad(hx, (0, 0, 0, pw, 0, ph, 0, pt))
        padded = (t + pt, h + ph, w + pw)
        if any(shift):
            hx = torch.roll(hx, shifts=(-shift[0], -shift[1], -shift[2]), dims=(1, 2, 3))
        wins = self.attn(window_partition(hx, window), window,
                         self._region_id(padded, window, shift, x.device))
        hx = window_merge(wins, window, padded, b)
        if any(shift):
            hx = torch.roll(hx, shifts=shift, dims=(1, 2, 3))
        x = x + self.drop_path(hx[:, :t, :h, :w], generator)
        return x + self.drop_path(self.mlp(self.norm2(x)), generator)


class PatchMerging(nn.Module):
    def __init__(self, dim: int, dtype):
        super().__init__()
        self.norm = LayerNorm(4 * dim, eps=1e-5)
        self.reduction = Dense(4 * dim, 2 * dim, False, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h, w = x.shape[2], x.shape[3]
        x = F.pad(x, (0, 0, 0, w % 2, 0, h % 2))
        x = torch.cat([x[:, :, 0::2, 0::2], x[:, :, 1::2, 0::2], x[:, :, 0::2, 1::2],
                       x[:, :, 1::2, 1::2]], dim=-1)
        return self.reduction(self.norm(x))


class _PatchEmbed(nn.Module):
    def __init__(self, embed_dim: int, patch_size, dtype):
        super().__init__()
        self.dtype = dtype
        self.proj = nn.Conv3d(3, embed_dim, kernel_size=patch_size, stride=patch_size)
        self.norm = LayerNorm(embed_dim, eps=1e-5)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt, p = self.dtype, self.proj
        x = F.conv3d(x.permute(0, 4, 1, 2, 3).to(dt), p.weight.to(dt), p.bias.to(dt),
                     stride=p.stride)
        return self.norm(x.permute(0, 2, 3, 4, 1))


@dataclasses.dataclass(frozen=True)
class Swin3DConfig:
    embed_dim: int = 96
    depths: Sequence[int] = (2, 2, 6, 2)
    num_heads: Sequence[int] = (3, 6, 12, 24)
    window: Tuple[int, int, int] = (8, 7, 7)
    patch_size: Tuple[int, int, int] = (2, 4, 4)
    mlp_ratio: float = 4.0
    num_classes: int = 2
    stochastic_depth: float = 0.1
    dtype: torch.dtype = torch.float32
    remat: bool = False

    def __post_init__(self):
        if self.remat:
            raise NotImplementedError(
                "remat is not yet ported to laryngeal_tpu_torch, see ROADMAP.md")


SWIN3D_VARIANTS = {
    "tiny": dict(embed_dim=96, depths=(2, 2, 6, 2), num_heads=(3, 6, 12, 24)),
    "small": dict(embed_dim=96, depths=(2, 2, 18, 2), num_heads=(3, 6, 12, 24)),
    "base": dict(embed_dim=128, depths=(2, 2, 18, 2), num_heads=(4, 8, 16, 32)),
    # torchvision's swin3d_b IN22K weights: the same architecture as base
    "base_in22k": dict(embed_dim=128, depths=(2, 2, 18, 2), num_heads=(4, 8, 16, 32)),
}


class SwinTransformer3D(nn.Module):
    """pixel_values (B, T, H, W, C) float -> logits (B, num_classes) float32."""

    def __init__(self, config: Swin3DConfig):
        super().__init__()
        cfg = self.config = config
        self.patch_embed = _PatchEmbed(cfg.embed_dim, cfg.patch_size, cfg.dtype)
        total = sum(cfg.depths)
        block_id, dim = 0, cfg.embed_dim
        features = []
        for stage, depth in enumerate(cfg.depths):
            blocks = []
            for i in range(depth):
                sd = cfg.stochastic_depth * block_id / max(total - 1, 1)
                shift = tuple(0 if i % 2 == 0 else wsz // 2 for wsz in cfg.window)
                blocks.append(SwinBlock3D(dim, cfg.num_heads[stage], cfg.window, shift,
                                          cfg.mlp_ratio, sd, cfg.dtype))
                block_id += 1
            features.append(nn.Sequential(*blocks))
            if stage < len(cfg.depths) - 1:
                features.append(PatchMerging(dim, cfg.dtype))
                dim *= 2
        self.features = nn.ModuleList(features)
        self.norm = LayerNorm(dim, eps=1e-5)
        self.head = Dense(dim, cfg.num_classes)

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        """``generator`` draws the stochastic depth (training); None (eval)
        applies none."""
        x = self.patch_embed(x)
        for layer in self.features:
            if isinstance(layer, PatchMerging):
                x = layer(x)
            else:
                for block in layer:
                    x = block(x, generator)
        x = self.norm(x).mean(dim=(1, 2, 3))
        return self.head(x).float()

    @torch.no_grad()
    def init_weights(self, generator: Optional[torch.Generator] = None) -> "SwinTransformer3D":
        """Flax's initialisers, drawn from ``generator`` (CPU): LeCun-normal
        kernels (std 1/sqrt(fan_in)), zero biases, unit LayerNorm scales, and
        the tables truncated normal with std 0.02 (the JAX module's)."""
        for m in self.modules():
            if isinstance(m, (nn.Linear, nn.Conv3d)):
                m.weight.copy_(torch.randn(m.weight.shape, generator=generator)
                               / math.sqrt(m.weight[0].numel()))
                if m.bias is not None:
                    nn.init.zeros_(m.bias)
            elif isinstance(m, nn.LayerNorm):
                nn.init.ones_(m.weight)
                nn.init.zeros_(m.bias)
            elif isinstance(m, WindowAttention3D):
                t = m.relative_position_bias_table
                t.copy_(torch.fmod(torch.randn(t.shape, generator=generator), 2.0) * 0.02)
        return self


def create_swin3d(model_size: str = "tiny", num_classes: int = 2,
                  dtype: torch.dtype = torch.float32, seed: Optional[int] = 0,
                  **kwargs) -> SwinTransformer3D:
    """Build a Swin3D on the CPU with weights drawn from ``seed`` (None
    leaves torch's own initialisation); move it with ``.to(device)``.
    Explicit kwargs (e.g. a checkpoint's pinned ``model_kwargs``) override
    the size's preset; the registry's frame count and image size are
    accepted and unused (Swin3D takes any input size)."""
    if model_size not in SWIN3D_VARIANTS:
        raise ValueError(f"Unknown swin3d size {model_size!r}; "
                         f"expected one of {sorted(SWIN3D_VARIANTS)}")
    kwargs.pop("num_frames", None)
    kwargs.pop("image_size", None)
    variant = dict(SWIN3D_VARIANTS[model_size])
    variant.update(kwargs)
    for key in ("depths", "num_heads", "window", "patch_size"):
        if key in variant:
            variant[key] = tuple(variant[key])
    model = SwinTransformer3D(Swin3DConfig(num_classes=num_classes, dtype=dtype, **variant))
    if seed is not None:
        model.init_weights(torch.Generator().manual_seed(int(seed)))
    return model.eval()
