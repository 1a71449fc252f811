"""TimeSformer-B — divided space-time attention (PyTorch).

Counterpart of ``laryngeal_tpu/models/timesformer.py`` (its flat layout,
``:42-149`` and ``:258-344``): architectural parity with HF
``TimesformerForVideoClassification``
(``facebook/timesformer-base-finetuned-k400``), the model the reference
trains (``timesformer/timesformer_classifier/models/timesformer_model.py:27-43``):

- per-frame Conv2d patch embedding (16x16), spatial position embeddings per
  frame, temporal embeddings per patch; patch tokens ordered
  spatial-major, time-innermost (``n*T + t``); cls token = cls + pos[0];
- each layer: temporal attention over the T axis per spatial location
  (projected by ``temporal_dense``, residual), then spatial attention per
  frame with the cls token tiled b-major over the frames and its residual
  the mean over frames, then the MLP (exact gelu);
- a fused qkv projection (one Dense of 3*hidden) per attention.

Both attention calls of a layer go through ``ops.attention`` with
Nq == Nk < 512 (temporal N = T, spatial N = 1 + 196), so on the card they
take the short-sequence kernels (kernel 6, and kernel 7 under autograd).

- Input is channels-last (B, T, H, W, C), as in the JAX package.
- Attribute names follow the HF state dict that
  ``laryngeal_tpu/compat/torch_port.py::port_timesformer`` reads
  (``timesformer.embeddings.*``, ``timesformer.encoder.layer.N.*``,
  ``timesformer.layernorm``, ``classifier``), so ``compat/flax_weights.py``
  maps the JAX package's params across.
- Precision follows Flax's ``dtype``: parameters stay float32; the
  convolution, the projections and attention compute in ``config.dtype``;
  LayerNorms and the classifier compute in float32, and logits are float32.
- Not yet ported: ``layout="nt"`` (the transpose-free einsum layout, whose
  attention reaches no kernel) and ``remat`` (per-layer rematerialisation);
  both raise. The JAX model's sequence-parallel hooks are no-ops on one
  device and are left out; stochastic depth is 0 in the reference and
  omitted there too.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import dot_product_attention
from .layers import Dense, LayerNorm, Mlp, _DenseOut, gelu_exact


@dataclasses.dataclass(frozen=True)
class TimesformerConfig:
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    image_size: int = 224
    num_frames: int = 8
    patch_size: int = 16
    num_classes: int = 2
    layer_norm_eps: float = 1e-6
    dtype: torch.dtype = torch.float32
    remat: bool = False
    layout: str = "flat"

    def __post_init__(self):
        if self.layout not in ("flat", "nt"):
            raise ValueError(f"layout must be 'flat' or 'nt', got {self.layout!r}")
        if self.layout == "nt":
            raise NotImplementedError(
                "TimeSformer layout='nt' is not yet ported to laryngeal_tpu_torch, "
                "see ROADMAP.md")
        if self.remat:
            raise NotImplementedError(
                "remat is not yet ported to laryngeal_tpu_torch, see ROADMAP.md")

    @property
    def num_spatial_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2


class _FusedQKV(nn.Module):
    """HF ``TimesformerSelfAttention``: the fused qkv projection."""

    def __init__(self, hidden_size: int, dtype):
        super().__init__()
        self.qkv = Dense(hidden_size, 3 * hidden_size, True, dtype)


class FusedQKVAttention(nn.Module):
    """MHA with a fused qkv Dense (HF ``TimesformerAttention`` layout:
    ``attention.qkv``, ``output.dense``). q, k and v are strided views of the
    qkv projection; the kernels read them in place."""

    def __init__(self, hidden_size: int, num_heads: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.hidden_size = hidden_size
        self.num_heads = num_heads
        self.attention = _FusedQKV(hidden_size, dtype)
        self.output = _DenseOut(hidden_size, hidden_size, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, n, _ = x.shape
        qkv = self.attention.qkv(x).reshape(b, n, 3, self.num_heads,
                                            self.hidden_size // self.num_heads)
        q, k, v = qkv.unbind(2)
        out = dot_product_attention(q, k, v)
        return self.output.dense(out.reshape(b, n, self.hidden_size))


class TimesformerLayer(Mlp):
    """One divided space-time layer (the JAX ``TimesformerLayer``, flat
    layout). It is its own ``Mlp`` so the MLP parameters sit directly under
    the layer, as HF names them (``intermediate.dense``, ``output.dense``)."""

    def __init__(self, cfg: TimesformerConfig):
        super().__init__(cfg.hidden_size, cfg.intermediate_size, gelu_exact, cfg.dtype)
        d, eps = cfg.hidden_size, cfg.layer_norm_eps
        self.num_frames = cfg.num_frames
        self.temporal_layernorm = LayerNorm(d, eps=eps)
        self.temporal_attention = FusedQKVAttention(d, cfg.num_heads, cfg.dtype)
        self.temporal_dense = Dense(d, d, True, cfg.dtype)
        self.layernorm_before = LayerNorm(d, eps=eps)
        self.attention = FusedQKVAttention(d, cfg.num_heads, cfg.dtype)
        self.layernorm_after = LayerNorm(d, eps=eps)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, total, d = x.shape
        t = self.num_frames
        n = (total - 1) // t  # spatial patches
        cls, patches = x[:, :1], x[:, 1:]

        # Temporal attention: (B, N*T, D) -> (B*N, T, D), a free reshape.
        h = self.temporal_attention(self.temporal_layernorm(patches.reshape(b * n, t, d)))
        patches = patches + self.temporal_dense(h.reshape(b, n * t, d))

        # Spatial attention: (B, N, T, D) -> (B*T, 1+N, D) with the cls token
        # tiled b-major over the frames.
        sp = patches.reshape(b, n, t, d).transpose(1, 2).reshape(b * t, n, d)
        sp = torch.cat([cls.repeat_interleave(t, dim=0), sp], dim=1)
        h = self.attention(self.layernorm_before(sp))
        cls_res = h[:, 0].reshape(b, t, d).mean(dim=1, keepdim=True)
        patch_res = h[:, 1:].reshape(b, t, n, d).transpose(1, 2).reshape(b, n * t, d)
        x = torch.cat([cls, patches], dim=1) + torch.cat([cls_res, patch_res], dim=1)

        return x + super().forward(self.layernorm_after(x))


class TimesformerPatchEmbeddings(nn.Module):
    def __init__(self, cfg: TimesformerConfig):
        super().__init__()
        self.dtype = cfg.dtype
        self.projection = nn.Conv2d(3, cfg.hidden_size, kernel_size=cfg.patch_size,
                                    stride=cfg.patch_size)

    def forward(self, frames: torch.Tensor) -> torch.Tensor:
        """(B*T, H, W, C) -> (B*T, N, D), row-major patch order."""
        dt = self.dtype
        w = self.projection
        x = F.conv2d(frames.permute(0, 3, 1, 2).to(dt), w.weight.to(dt), w.bias.to(dt),
                     stride=w.stride)
        return x.flatten(2).transpose(1, 2)


class TimesformerEmbeddings(nn.Module):
    def __init__(self, cfg: TimesformerConfig):
        super().__init__()
        d = cfg.hidden_size
        self.cls_token = nn.Parameter(torch.zeros(1, 1, d))
        self.position_embeddings = nn.Parameter(torch.zeros(1, cfg.num_spatial_patches + 1, d))
        self.time_embeddings = nn.Parameter(torch.zeros(1, cfg.num_frames, d))
        self.patch_embeddings = TimesformerPatchEmbeddings(cfg)

    def forward(self, pixel_values: torch.Tensor) -> torch.Tensor:
        """(B, T, H, W, C) -> (B, 1 + N*T, D), spatial-major, time-innermost."""
        b, t, hh, ww, c = pixel_values.shape
        x = self.patch_embeddings(pixel_values.reshape(b * t, hh, ww, c))
        n, d = x.shape[1], x.shape[2]
        pos = self.position_embeddings.to(x.dtype)
        x = x + pos[:, 1:]
        x = x.reshape(b, t, n, d).transpose(1, 2) + self.time_embeddings.to(x.dtype)[:, None]
        cls = (self.cls_token.to(x.dtype) + pos[:, :1]).expand(b, -1, -1)
        return torch.cat([cls, x.reshape(b, n * t, d)], dim=1)


class TimesformerEncoder(nn.Module):
    def __init__(self, cfg: TimesformerConfig):
        super().__init__()
        self.layer = nn.ModuleList(TimesformerLayer(cfg) for _ in range(cfg.num_layers))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for layer in self.layer:
            x = layer(x)
        return x


class TimesformerModel(nn.Module):
    def __init__(self, cfg: TimesformerConfig):
        super().__init__()
        self.embeddings = TimesformerEmbeddings(cfg)
        self.encoder = TimesformerEncoder(cfg)
        self.layernorm = LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)

    def forward(self, pixel_values: torch.Tensor) -> torch.Tensor:
        return self.layernorm(self.encoder(self.embeddings(pixel_values)))


class TimesformerForVideoClassification(nn.Module):
    """pixel_values (B, T, H, W, C) float -> logits (B, num_classes) float32."""

    def __init__(self, config: TimesformerConfig):
        super().__init__()
        self.config = config
        self.timesformer = TimesformerModel(config)
        self.classifier = Dense(config.hidden_size, config.num_classes)

    def forward(self, pixel_values: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """``generator`` is the train step's stochastic-depth generator;
        this model has no stochastic depth and ignores it."""
        x = self.timesformer(pixel_values)
        return self.classifier(x[:, 0]).float()

    @torch.no_grad()
    def init_weights(self, generator: Optional[torch.Generator] = None
                     ) -> "TimesformerForVideoClassification":
        """Flax's initialisers, drawn from ``generator`` (CPU): LeCun-normal
        kernels (std 1/sqrt(fan_in)), zero biases, unit LayerNorm scales and
        zero cls / position / time embeddings (the JAX module's
        ``nn.initializers.zeros``)."""
        for m in self.modules():
            if isinstance(m, (nn.Linear, nn.Conv2d)):
                m.weight.copy_(torch.randn(m.weight.shape, generator=generator)
                               / math.sqrt(m.weight[0].numel()))
                nn.init.zeros_(m.bias)
            elif isinstance(m, nn.LayerNorm):
                nn.init.ones_(m.weight)
                nn.init.zeros_(m.bias)
        emb = self.timesformer.embeddings
        for p in (emb.cls_token, emb.position_embeddings, emb.time_embeddings):
            nn.init.zeros_(p)
        return self


def create_timesformer(num_classes: int = 2, num_frames: int = 8, image_size: int = 224,
                       dtype: torch.dtype = torch.float32, seed: Optional[int] = 0,
                       **kwargs) -> TimesformerForVideoClassification:
    """Build a TimeSformer on the CPU with weights drawn from ``seed`` (None
    leaves torch's own initialisation); move it with ``.to(device)``."""
    cfg = TimesformerConfig(num_classes=num_classes, num_frames=num_frames,
                            image_size=image_size, dtype=dtype, **kwargs)
    model = TimesformerForVideoClassification(cfg)
    if seed is not None:
        model.init_weights(torch.Generator().manual_seed(int(seed)))
    return model.eval()
