"""3D-ResNet50 (slow pathway, pytorchvideo ``slow_r50``) video classifier —
PyTorch.

Counterpart of ``laryngeal_tpu/models/resnet3d.py``: the network
pytorchvideo's ``create_resnet(model_depth=50)`` builds, the reference's
``resnet50-3d-video/video_classifier/models/resnet3d.py:4-49``:

- stem: Conv3d 64x(3,7,7) stride (1,2,2) pad (1,3,3) + BN + ReLU +
  MaxPool3d (1,3,3) stride (1,2,2) pad (0,1,1);
- 4 bottleneck stages, depths (3,4,6,3), inner widths (64,128,256,512),
  expansion 4; conv_a kernel (1,1,1), (1,1,1), (3,1,1), (3,1,1) by stage,
  conv_b (1,3,3) with spatial stride (1,2,2,2), temporal stride 1;
- head: AvgPool3d (4,7,7) stride 1, clamped to the feature size as the JAX
  model clamps it, dropout 0.5 in training, a position-wise Linear(2048, 2),
  then the mean over (T, H, W).

- Input is channels-last (B, T, H, W, C), as in the JAX package; the
  network runs on its (B, C, T, H, W) view, which is channels-last in
  memory, so cuDNN takes it without a copy.
- The stem is the direct convolution. The JAX model's ``stem_s2d`` (on by
  default) computes the same convolution in a TPU layout; the flag is
  accepted and ignored.
- Parameter names are pytorchvideo's (``blocks.0.conv``, ``blocks.0.norm``,
  ``blocks.{1-4}.res_blocks.{i}.branch1_{conv,norm}`` /
  ``branch2.{conv,norm}_{a,b,c}``, ``blocks.5.proj``), so
  ``laryngeal_tpu/compat/torch_port.py::port_resnet3d`` reads a
  ``state_dict()`` and ``compat/flax_weights.py`` maps the JAX variables
  across.
- BatchNorm is ``layers.BatchNorm``: Flax's running-variance rule.
- Precision follows Flax's ``dtype``: parameters and BN statistics stay
  float32, the convolutions run in ``config.dtype``, the head's pool and
  projection in float32, and the logits are float32.
- The head's dropout draws from the ``generator`` handed to the forward (the
  train step's); without one, or in eval mode, none.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .layers import BatchNorm, Conv3d, Dense, dropout, init_lecun_normal

WIDTHS = (64, 128, 256, 512)
STAGE_SIZES = (3, 4, 6, 3)
STAGE_TEMPORAL_KERNEL_A = (1, 1, 3, 3)
STAGE_SPATIAL_STRIDE = (1, 2, 2, 2)
HEAD_POOL = (4, 7, 7)


class _Branch2(nn.Module):
    def __init__(self, cin: int, width: int, ka: int, stride: int, dtype):
        super().__init__()
        self.conv_a = Conv3d(cin, width, (ka, 1, 1), padding=(ka // 2, 0, 0), bias=False,
                             dtype=dtype)
        self.norm_a = BatchNorm(width, dtype)
        self.conv_b = Conv3d(width, width, (1, 3, 3), stride=(1, stride, stride),
                             padding=(0, 1, 1), bias=False, dtype=dtype)
        self.norm_b = BatchNorm(width, dtype)
        self.conv_c = Conv3d(width, width * 4, 1, bias=False, dtype=dtype)
        self.norm_c = BatchNorm(width * 4, dtype)

    def forward(self, x):
        x = F.relu(self.norm_a(self.conv_a(x)))
        x = F.relu(self.norm_b(self.conv_b(x)))
        return self.norm_c(self.conv_c(x))


class Bottleneck3D(nn.Module):
    """pytorchvideo ``ResBlock``: branch2 plus the identity, or on a stage's
    first block the ``branch1`` projection shortcut."""

    def __init__(self, cin: int, width: int, ka: int, stride: int, shortcut: bool, dtype):
        super().__init__()
        if shortcut:
            self.branch1_conv = Conv3d(cin, width * 4, 1, stride=(1, stride, stride),
                                       bias=False, dtype=dtype)
            self.branch1_norm = BatchNorm(width * 4, dtype)
        self.branch2 = _Branch2(cin, width, ka, stride, dtype)

    def forward(self, x):
        identity = x
        if hasattr(self, "branch1_conv"):
            identity = self.branch1_norm(self.branch1_conv(x))
        return F.relu(self.branch2(x) + identity)


class _Stem(nn.Module):
    def __init__(self, dtype):
        super().__init__()
        self.conv = Conv3d(3, 64, (3, 7, 7), stride=(1, 2, 2), padding=(1, 3, 3), bias=False,
                           dtype=dtype)
        self.norm = BatchNorm(64, dtype)

    def forward(self, x):
        x = F.relu(self.norm(self.conv(x)))
        return F.max_pool3d(x, (1, 3, 3), stride=(1, 2, 2), padding=(0, 1, 1))


class _Stage(nn.Module):
    def __init__(self, cin: int, width: int, depth: int, ka: int, stride: int, dtype):
        super().__init__()
        self.res_blocks = nn.ModuleList(
            Bottleneck3D(cin if i == 0 else width * 4, width, ka, stride if i == 0 else 1,
                         i == 0, dtype) for i in range(depth))

    def forward(self, x):
        for block in self.res_blocks:
            x = block(x)
        return x


class _Head(nn.Module):
    """pytorchvideo ``ResNetBasicHead`` with the global average."""

    def __init__(self, num_classes: int, pool: Tuple[int, int, int], rate: float):
        super().__init__()
        self.pool = tuple(pool)
        self.rate = float(rate)
        self.proj = Dense(WIDTHS[-1] * 4, num_classes)

    def forward(self, x, generator: Optional[torch.Generator] = None):
        kernel = tuple(min(k, s) for k, s in zip(self.pool, x.shape[2:]))
        # Pooled in at least float32 (the projection promotes to it anyway).
        x = F.avg_pool3d(x.to(torch.promote_types(x.dtype, torch.float32)), kernel, stride=1)
        if self.training:
            x = dropout(x, self.rate, generator)
        x = self.proj(x.permute(0, 2, 3, 4, 1))  # position-wise, (B, T, H, W, classes)
        return x.mean(dim=(1, 2, 3)).float()


@dataclasses.dataclass(frozen=True)
class ResNet3DConfig:
    num_classes: int = 2
    dropout: float = 0.5
    dtype: torch.dtype = torch.float32


class ResNet3D(nn.Module):
    """pixel_values (B, T, H, W, C) -> logits (B, num_classes) float32."""

    def __init__(self, config: ResNet3DConfig = ResNet3DConfig()):
        super().__init__()
        self.config = cfg = config
        blocks = [_Stem(cfg.dtype)]
        cin = 64
        for depth, width, ka, stride in zip(STAGE_SIZES, WIDTHS, STAGE_TEMPORAL_KERNEL_A,
                                            STAGE_SPATIAL_STRIDE):
            blocks.append(_Stage(cin, width, depth, ka, stride, cfg.dtype))
            cin = width * 4
        blocks.append(_Head(cfg.num_classes, HEAD_POOL, cfg.dropout))
        self.blocks = nn.ModuleList(blocks)

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        """``generator`` draws the head's dropout (training); None applies none."""
        x = x.permute(0, 4, 1, 2, 3)
        for block in self.blocks[:-1]:
            x = block(x)
        return self.blocks[-1](x, generator)

def create_resnet3d(num_classes: int = 2, dropout: float = 0.5,
                    dtype: torch.dtype = torch.float32, seed: Optional[int] = 0,
                    **_) -> ResNet3D:
    """Build a slow_r50 on the CPU with weights drawn from ``seed`` by Flax's
    initialisers (``layers.init_lecun_normal``; None leaves torch's own);
    move it with ``.to(device)``. The registry's ``num_frames`` /
    ``image_size`` and the JAX model's ``stem_s2d`` / ``stem_pair`` TPU
    layouts are accepted and unused."""
    model = ResNet3D(ResNet3DConfig(num_classes=num_classes, dropout=dropout, dtype=dtype))
    if seed is not None:
        init_lecun_normal(model, torch.Generator().manual_seed(int(seed)))
    return model.eval()
