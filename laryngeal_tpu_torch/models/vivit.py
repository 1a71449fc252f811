"""ViViT-B — joint space-time attention video transformer (PyTorch).

Counterpart of ``laryngeal_tpu/models/vivit.py``: architectural parity with
HF ``VivitForVideoClassification`` (``google/vivit-b-16x2-kinetics400``):
tubelet Conv3d embedding (2x16x16), CLS token + learned position
embeddings, pre-LN ViT layers (gelu_fast MLP), final LayerNorm, classifier
on the CLS token.

- Input is channels-last (B, T, H, W, C), as in the JAX package; tokens are
  ordered t-major (HF ``flatten(2)``).
- Attribute names follow the HF state dict (``vivit.embeddings.*``,
  ``vivit.encoder.layer.N.*``, ``vivit.layernorm``, ``classifier``), so
  ``compat/flax_weights.py`` maps the JAX package's params across.
- Precision follows Flax's ``dtype``: parameters stay float32 and the
  convolution, projections and attention compute in ``config.dtype``;
  LayerNorms and the classifier compute in float32, and logits are float32.
- Attention runs through ``ops.attention.dot_product_attention`` (the CUDA
  flash kernel on the card). The JAX model's sequence-parallel hooks are
  no-ops on one device and are left out.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .layers import Dense, LayerNorm, TransformerBlock, gelu_fast


@dataclasses.dataclass(frozen=True)
class VivitConfig:
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    image_size: int = 224
    num_frames: int = 32
    tubelet_size: Tuple[int, int, int] = (2, 16, 16)
    num_classes: int = 2
    layer_norm_eps: float = 1e-6
    dtype: torch.dtype = torch.float32

    @property
    def num_patches(self) -> int:
        t, ph, pw = self.tubelet_size
        return (self.num_frames // t) * (self.image_size // ph) * (self.image_size // pw)


class VivitTubeletEmbeddings(nn.Module):
    def __init__(self, cfg: VivitConfig):
        super().__init__()
        self.dtype = cfg.dtype
        self.projection = nn.Conv3d(3, cfg.hidden_size, kernel_size=cfg.tubelet_size,
                                    stride=cfg.tubelet_size)

    def forward(self, pixel_values: torch.Tensor) -> torch.Tensor:
        """(B, T, H, W, C) -> (B, N, D), t-major token order."""
        dt = self.dtype
        x = pixel_values.permute(0, 4, 1, 2, 3).to(dt)
        w = self.projection
        x = F.conv3d(x, w.weight.to(dt), w.bias.to(dt), stride=w.stride)
        return x.flatten(2).transpose(1, 2)


class VivitEmbeddings(nn.Module):
    def __init__(self, cfg: VivitConfig):
        super().__init__()
        self.cls_token = nn.Parameter(torch.zeros(1, 1, cfg.hidden_size))
        self.position_embeddings = nn.Parameter(
            torch.zeros(1, cfg.num_patches + 1, cfg.hidden_size))
        self.patch_embeddings = VivitTubeletEmbeddings(cfg)

    def forward(self, pixel_values: torch.Tensor) -> torch.Tensor:
        x = self.patch_embeddings(pixel_values)
        cls = self.cls_token.to(x.dtype).expand(x.shape[0], -1, -1)
        return torch.cat([cls, x], dim=1) + self.position_embeddings.to(x.dtype)


class VivitEncoder(nn.Module):
    def __init__(self, cfg: VivitConfig):
        super().__init__()
        self.layer = nn.ModuleList(
            TransformerBlock(cfg.hidden_size, cfg.num_heads, cfg.intermediate_size,
                             act=gelu_fast, layer_norm_eps=cfg.layer_norm_eps,
                             dtype=cfg.dtype)
            for _ in range(cfg.num_layers))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for block in self.layer:
            x = block(x)
        return x


class VivitModel(nn.Module):
    def __init__(self, cfg: VivitConfig):
        super().__init__()
        self.embeddings = VivitEmbeddings(cfg)
        self.encoder = VivitEncoder(cfg)
        self.layernorm = LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)

    def forward(self, pixel_values: torch.Tensor) -> torch.Tensor:
        return self.layernorm(self.encoder(self.embeddings(pixel_values)))


class VivitForVideoClassification(nn.Module):
    """pixel_values (B, T, H, W, C) float -> logits (B, num_classes) float32."""

    def __init__(self, config: VivitConfig):
        super().__init__()
        self.config = config
        self.vivit = VivitModel(config)
        self.classifier = Dense(config.hidden_size, config.num_classes)

    def forward(self, pixel_values: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """``generator`` is the train step's stochastic-depth generator;
        this model has no stochastic depth and ignores it."""
        x = self.vivit(pixel_values)
        return self.classifier(x[:, 0]).float()

    @torch.no_grad()
    def init_weights(self, generator: Optional[torch.Generator] = None) -> "VivitForVideoClassification":
        """Flax's initialisers, drawn from ``generator`` (CPU): LeCun-normal
        kernels (std 1/sqrt(fan_in)), zero biases, unit LayerNorm scales, a
        zero CLS token and N(0, 0.02) position embeddings."""
        def normal_(p, std):
            p.copy_(torch.randn(p.shape, generator=generator) * std)

        for m in self.modules():
            if isinstance(m, (nn.Linear, nn.Conv3d)):
                normal_(m.weight, 1.0 / math.sqrt(m.weight[0].numel()))
                nn.init.zeros_(m.bias)
            elif isinstance(m, nn.LayerNorm):
                nn.init.ones_(m.weight)
                nn.init.zeros_(m.bias)
        emb = self.vivit.embeddings
        nn.init.zeros_(emb.cls_token)
        normal_(emb.position_embeddings, 0.02)
        return self


def create_vivit(num_classes: int = 2, num_frames: int = 32, image_size: int = 224,
                 dtype: torch.dtype = torch.float32, seed: Optional[int] = 0,
                 **kwargs) -> VivitForVideoClassification:
    """Build a ViViT on the CPU with weights drawn from ``seed`` (None leaves
    torch's own initialisation); move it with ``.to(device)``."""
    cfg = VivitConfig(num_classes=num_classes, num_frames=num_frames,
                      image_size=image_size, dtype=dtype, **kwargs)
    model = VivitForVideoClassification(cfg)
    if seed is not None:
        model.init_weights(torch.Generator().manual_seed(int(seed)))
    return model.eval()
