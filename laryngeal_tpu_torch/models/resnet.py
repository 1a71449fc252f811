"""ResNet50 (2D) trunk + LSTM video classifier — PyTorch.

Counterpart of ``laryngeal_tpu/models/resnet.py``, the reference's
``resnet50-2d-lstm/src/models/model.py:10-59``: a torchvision ResNet50
without its fc (frozen in training) -> per-frame 2048-d features -> a
2-layer LSTM (hidden 256, dropout 0.5 between layers) -> classifier
Linear(256, 64) -> ReLU -> Dropout(0.5) -> Linear(64, 1), one logit for
BCE-with-logits.

- Input is channels-last (B, T, H, W, C). The frames fold into the batch,
  (B·T, C, H, W) (channels-last in memory), so every BatchNorm's statistics
  span all B·T frames, as in the JAX model.
- The stem is the direct convolution (the JAX model's ``stem_s2d``, off by
  default, computes the same convolution in a TPU layout; accepted and
  ignored).
- Parameter names are the reference's sequential layout: ``resnet50.0``
  conv1, ``resnet50.1`` bn1, ``resnet50.{4-7}`` layer1-4 of torchvision
  Bottlenecks (``conv{1,2,3}``, ``bn{1,2,3}``, ``downsample.{0,1}``),
  ``lstm.{weight,bias}_{ih,hh}_l{k}``, ``classifier.0`` / ``classifier.3``,
  so ``laryngeal_tpu/compat/torch_port.py::port_resnet50_lstm`` reads a
  ``state_dict()``.
- The LSTM is written out (torch's (i, f, g, o) gate order, U(±1/sqrt(H))
  init) rather than ``nn.LSTM``, whose inter-layer dropout draws from the
  global generator: here, as the classifier's, it draws from the
  ``generator`` handed to the forward (the train step's).
- Precision follows Flax's ``dtype``: the trunk's convolutions, the LSTM's
  gate products and its carry run in ``config.dtype``; BN statistics stay
  float32; the classifier runs in the promoted dtype (float32) and the logit
  is float32.
- ``backbone_param_mask`` marks the trunk frozen, as the reference freezes
  it; its BN running statistics still move in train mode.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from .layers import BatchNorm, Conv2d, Dense, dropout, init_lecun_normal

TRUNK = "resnet50"


class Bottleneck(nn.Module):
    """torchvision Bottleneck: 1x1 -> 3x3 (stride) -> 1x1 (x4), BN + ReLU."""

    def __init__(self, cin: int, width: int, stride: int, downsample: bool, dtype):
        super().__init__()
        self.conv1 = Conv2d(cin, width, 1, bias=False, dtype=dtype)
        self.bn1 = BatchNorm(width, dtype)
        self.conv2 = Conv2d(width, width, 3, stride=stride, padding=1, bias=False, dtype=dtype)
        self.bn2 = BatchNorm(width, dtype)
        self.conv3 = Conv2d(width, width * 4, 1, bias=False, dtype=dtype)
        self.bn3 = BatchNorm(width * 4, dtype)
        if downsample:
            self.downsample = nn.Sequential(
                Conv2d(cin, width * 4, 1, stride=stride, bias=False, dtype=dtype),
                BatchNorm(width * 4, dtype))

    def forward(self, x):
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        identity = self.downsample(x) if hasattr(self, "downsample") else x
        return F.relu(out + identity)


class ResNet50(nn.Sequential):
    """torchvision ResNet50 without fc, as ``nn.Sequential(*children[:-1])``:
    (N, C, H, W) -> pooled (N, 2048) features."""

    def __init__(self, dtype=torch.float32):
        layers = [Conv2d(3, 64, 7, stride=2, padding=3, bias=False, dtype=dtype),
                  BatchNorm(64, dtype), nn.ReLU(), nn.MaxPool2d(3, stride=2, padding=1)]
        cin = 64
        for stage, (blocks, width) in enumerate(zip((3, 4, 6, 3), (64, 128, 256, 512))):
            layers.append(nn.Sequential(*(
                Bottleneck(cin if i == 0 else width * 4, width,
                           2 if (stage > 0 and i == 0) else 1, i == 0, dtype)
                for i in range(blocks))))
            cin = width * 4
        super().__init__(*layers)

    def forward(self, x):
        return super().forward(x).mean(dim=(2, 3))


class LSTM(nn.Module):
    """Multi-layer LSTM with ``nn.LSTM``'s semantics (batch_first) and
    parameter names; one fused (4H) input product per layer, then a step
    over T: gates = x W_ih^T + (b_ih + b_hh) + h W_hh^T in ``dtype``."""

    def __init__(self, input_size: int, hidden_size: int, num_layers: int = 2,
                 dropout: float = 0.5, dtype=torch.float32):
        super().__init__()
        self.hidden_size, self.num_layers = hidden_size, num_layers
        self.dropout, self.dtype = float(dropout), dtype
        for k in range(num_layers):
            fan = input_size if k == 0 else hidden_size
            self.register_parameter(f"weight_ih_l{k}",
                                    nn.Parameter(torch.empty(4 * hidden_size, fan)))
            self.register_parameter(f"weight_hh_l{k}",
                                    nn.Parameter(torch.empty(4 * hidden_size, hidden_size)))
            self.register_parameter(f"bias_ih_l{k}", nn.Parameter(torch.empty(4 * hidden_size)))
            self.register_parameter(f"bias_hh_l{k}", nn.Parameter(torch.empty(4 * hidden_size)))
        self.init_weights()

    @torch.no_grad()
    def init_weights(self, generator: Optional[torch.Generator] = None) -> "LSTM":
        """torch's U(-1/sqrt(H), 1/sqrt(H)) for every weight and bias."""
        bound = 1.0 / math.sqrt(self.hidden_size)
        for p in self.parameters():
            p.copy_(torch.rand(p.shape, generator=generator) * (2 * bound) - bound)
        return self

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        """(B, T, F) -> (B, T, H) in ``dtype``; dropout between layers only in
        training with a generator."""
        dt = self.dtype
        b = x.shape[0]
        for k in range(self.num_layers):
            bias = (getattr(self, f"bias_ih_l{k}") + getattr(self, f"bias_hh_l{k}")).to(dt)
            x_gates = F.linear(x.to(dt), getattr(self, f"weight_ih_l{k}").to(dt), bias)
            w_hh = getattr(self, f"weight_hh_l{k}").to(dt)
            h = x_gates.new_zeros(b, self.hidden_size)
            c = x_gates.new_zeros(b, self.hidden_size)
            hs = []
            for t in range(x_gates.shape[1]):
                gates = x_gates[:, t] + h @ w_hh.t()
                i, f, g, o = gates.chunk(4, dim=-1)
                c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
                h = torch.sigmoid(o) * torch.tanh(c)
                hs.append(h)
            x = torch.stack(hs, dim=1)
            if self.training and k < self.num_layers - 1:
                x = dropout(x, self.dropout, generator)
        return x


@dataclasses.dataclass(frozen=True)
class ResNetLSTMConfig:
    hidden_size: int = 256
    num_layers: int = 2
    dropout: float = 0.5
    dtype: torch.dtype = torch.float32


class VideoResNet50LSTM(nn.Module):
    """pixel_values (B, T, H, W, C) -> logit (B, 1) float32."""

    def __init__(self, config: ResNetLSTMConfig = ResNetLSTMConfig()):
        super().__init__()
        self.config = cfg = config
        self.resnet50 = ResNet50(cfg.dtype)
        self.lstm = LSTM(2048, cfg.hidden_size, cfg.num_layers, cfg.dropout, cfg.dtype)
        # The reference's Linear, ReLU, Dropout, Linear; the forward draws the
        # dropout from its generator instead of slot 2.
        self.classifier = nn.Sequential(Dense(cfg.hidden_size, 64), nn.ReLU(), nn.Identity(),
                                        Dense(64, 1))

    def forward(self, pixel_values: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """``generator`` draws the LSTM's and the classifier's dropout
        (training); None applies none."""
        b, t, h, w, c = pixel_values.shape
        frames = pixel_values.reshape(b * t, h, w, c).permute(0, 3, 1, 2)
        feats = self.resnet50(frames).reshape(b, t, -1)
        x = self.lstm(feats, generator)[:, -1]
        x = F.relu(self.classifier[0](x))
        if self.training:
            x = dropout(x, self.config.dropout, generator)
        return self.classifier[3](x).float()

def backbone_param_mask(model: nn.Module) -> Dict[str, bool]:
    """Parameter name -> trainable: False on the ResNet trunk (the reference
    freezes it, resnet50-2d-lstm/src/models/model.py:15-17)."""
    return {name: not name.startswith(TRUNK + ".") for name, _ in model.named_parameters()}


def create_resnet50_lstm(hidden_size: int = 256, num_layers: int = 2, dropout: float = 0.5,
                         dtype: torch.dtype = torch.float32, seed: Optional[int] = 0,
                         **_) -> VideoResNet50LSTM:
    """Build the model on the CPU with weights drawn from ``seed`` by Flax's
    initialisers (``layers.init_lecun_normal``, then the LSTM's
    U(-1/sqrt(H), 1/sqrt(H)); None leaves torch's own); move it with
    ``.to(device)``. The registry's ``num_classes`` (the head is one logit),
    ``num_frames`` and ``image_size`` and the JAX model's ``stem_s2d`` /
    ``stage_sizes`` are accepted and unused."""
    model = VideoResNet50LSTM(ResNetLSTMConfig(hidden_size, num_layers, dropout, dtype))
    if seed is not None:
        generator = torch.Generator().manual_seed(int(seed))
        init_lecun_normal(model, generator)
        model.lstm.init_weights(generator)
    return model.eval()
