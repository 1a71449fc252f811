"""Shared building blocks (counterpart of ``laryngeal_tpu/models/layers.py``,
plus the convolution, BatchNorm and dropout pieces the CNN families share).

Module attribute names follow the HF torch module tree, so a model's
``state_dict`` carries HF names (``attention.attention.query``,
``attention.output.dense``, ``intermediate.dense``, ``output.dense``,
``layernorm_before/after``) and ``compat/flax_weights.py`` is a mechanical
relayout.

Precision follows Flax's ``dtype`` semantics: parameters stay float32 and
each ``Dense`` / ``Conv2d`` / ``Conv3d`` casts its input and parameters to
the compute dtype; ``LayerNorm`` computes and returns float32, as Flax's does
when its input is bf16 and its parameters f32; ``BatchNorm`` keeps its
statistics in float32 and returns the compute dtype, as Flax's does.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import remat as _remat
from ..ops.attention import dot_product_attention


class Dense(nn.Linear):
    """``flax.linen.Dense``: (in, out) projection run in ``dtype`` (None:
    the promoted dtype of input and parameters)."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 dtype: Optional[torch.dtype] = None):
        super().__init__(in_features, out_features, bias=bias)
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype or torch.promote_types(x.dtype, self.weight.dtype)
        bias = None if self.bias is None else self.bias.to(dt)
        return F.linear(x.to(dt), self.weight.to(dt), bias)


class _ComputeDtype:
    """A convolution run in ``dtype`` (``flax.linen.Conv``'s): its input and
    parameters are cast to it."""

    def __init__(self, *args, dtype: torch.dtype = torch.float32, **kwargs):
        super().__init__(*args, **kwargs)
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bias = None if self.bias is None else self.bias.to(self.dtype)
        return self._conv_forward(x.to(self.dtype), self.weight.to(self.dtype), bias)


class Conv2d(_ComputeDtype, nn.Conv2d):
    """Over (N, C, H, W)."""


class Conv3d(_ComputeDtype, nn.Conv3d):
    """Over (N, C, T, H, W)."""


class BatchNorm(nn.BatchNorm3d):
    """``flax.linen.BatchNorm(momentum=0.9, epsilon=1e-5)`` over dim 1 of an
    (N, C, ...) input, under torch's state-dict names (``weight``, ``bias``,
    ``running_mean``, ``running_var``, ``num_batches_tracked``).

    Train mode normalises with the batch mean and the biased batch variance,
    as torch does, and then moves the running statistics the Flax way:
    ``r = 0.9 r + 0.1 s`` with the *biased* variance, where torch's
    ``BatchNorm`` takes the unbiased one (n / (n - 1) larger). Eval mode
    normalises with the running statistics. Statistics are float32 (the
    parameters' dtype); the output is cast to ``dtype``."""

    MOMENTUM = 0.9  # Flax's: the share of the running statistic kept

    def __init__(self, num_features: int, dtype: torch.dtype = torch.float32):
        super().__init__(num_features, eps=1e-5, momentum=1.0 - self.MOMENTUM)
        self.dtype = dtype

    def _check_input_dim(self, x: torch.Tensor) -> None:
        if x.dim() < 2:
            raise ValueError(f"expected an (N, C, ...) input, got shape {tuple(x.shape)}")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        self._check_input_dim(x)
        if not self.training:
            y = F.batch_norm(x, self.running_mean, self.running_var, self.weight, self.bias,
                             False, 0.0, self.eps)
            return y.to(self.dtype)
        # The batch's mean and unbiased variance land in these with momentum 1.
        mean = torch.zeros_like(self.running_mean)
        var = torch.ones_like(self.running_var)
        y = F.batch_norm(x, mean, var, self.weight, self.bias, True, 1.0, self.eps)
        n = x.numel() // x.shape[1]
        with torch.no_grad():
            keep = self.MOMENTUM
            self.running_mean.mul_(keep).add_(mean, alpha=1.0 - keep)
            self.running_var.mul_(keep).add_(var * ((n - 1) / n), alpha=1.0 - keep)
            self.num_batches_tracked.add_(1)
        return y.to(self.dtype)


def call_block(block: Callable, *args, remat: bool = False,
               generator: Optional[torch.Generator] = None):
    """``block(*args)``; with ``remat`` and grad enabled, rematerialised in
    the backward with its attention outputs kept (``ops/remat.py``, the JAX
    package's ``nn.remat`` with ``save_only_these_names("attn_out")``).
    ``generator``, the one the block draws from, is rewound for the
    recompute."""
    if remat and torch.is_grad_enabled():
        return _remat.checkpoint(block, *args, generator=generator)
    return block(*args)


@torch.no_grad()
def init_lecun_normal(model: nn.Module, generator: Optional[torch.Generator] = None) -> None:
    """Flax's default initialisers for the CNN families, drawn from
    ``generator`` (CPU): LeCun-normal kernels (std 1/sqrt(fan_in)) for every
    linear and convolution, zero biases, unit BN scales, BN statistics at
    (0, 1)."""
    for m in model.modules():
        if isinstance(m, (nn.Linear, nn.Conv2d, nn.Conv3d)):
            m.weight.copy_(torch.randn(m.weight.shape, generator=generator)
                           / math.sqrt(m.weight[0].numel()))
            if m.bias is not None:
                nn.init.zeros_(m.bias)
        elif isinstance(m, BatchNorm):
            m.reset_parameters()


def dropout(x: torch.Tensor, rate: float, generator: Optional[torch.Generator]) -> torch.Tensor:
    """``flax.linen.Dropout``: each element kept with probability 1 - rate
    and scaled by 1 / (1 - rate), else zeroed, the draws from ``generator``
    (the train step's, on the model's device); with none, or rate 0, the
    identity."""
    if generator is None or rate <= 0.0:
        return x
    keep = 1.0 - rate
    u = torch.rand(x.shape, generator=generator, device=generator.device)
    return torch.where(u.to(x.device) < keep, x / keep, torch.zeros((), dtype=x.dtype,
                                                                   device=x.device))


class LayerNorm(nn.LayerNorm):
    """``flax.linen.LayerNorm`` with f32 parameters: normalises in float32
    and returns float32 whatever the input dtype."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x.float(), self.normalized_shape, self.weight,
                            self.bias, self.eps)


def gelu_fast(x: torch.Tensor) -> torch.Tensor:
    """HF 'gelu_fast'/'gelu_new' == tanh-approximate gelu."""
    return F.gelu(x, approximate="tanh")


def gelu_exact(x: torch.Tensor) -> torch.Tensor:
    """Exact (erf) gelu, HF 'gelu' (TimeSformer's MLP)."""
    return F.gelu(x)


class _QKV(nn.Module):
    """HF ``VivitSelfAttention``: the three projections."""

    def __init__(self, hidden_size: int, qkv_bias: bool, dtype):
        super().__init__()
        self.query = Dense(hidden_size, hidden_size, qkv_bias, dtype)
        self.key = Dense(hidden_size, hidden_size, qkv_bias, dtype)
        self.value = Dense(hidden_size, hidden_size, qkv_bias, dtype)


class _DenseOut(nn.Module):
    """A single ``dense`` child (HF ``VivitSelfOutput`` / ``VivitOutput`` /
    ``VivitIntermediate`` naming)."""

    def __init__(self, in_features: int, out_features: int, dtype):
        super().__init__()
        self.dense = Dense(in_features, out_features, True, dtype)


class SelfAttention(nn.Module):
    """HF-style MHA: separate q/k/v projections + output projection."""

    def __init__(self, hidden_size: int, num_heads: int, qkv_bias: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.hidden_size = hidden_size
        self.num_heads = num_heads
        self.attention = _QKV(hidden_size, qkv_bias, dtype)
        self.output = _DenseOut(hidden_size, hidden_size, dtype)

    def forward(self, x: torch.Tensor, bias: Optional[torch.Tensor] = None,
                kv_valid: Optional[int] = None) -> torch.Tensor:
        b, n, _ = x.shape
        shape = (b, n, self.num_heads, self.hidden_size // self.num_heads)
        q = self.attention.query(x).reshape(shape)
        k = self.attention.key(x).reshape(shape)
        v = self.attention.value(x).reshape(shape)
        out = dot_product_attention(q, k, v, bias=bias, kv_valid=kv_valid)
        return self.output.dense(out.reshape(b, n, self.hidden_size))


class Mlp(nn.Module):
    """fc1 -> act -> fc2, under HF's names: ``intermediate.dense`` and
    ``output.dense``."""

    def __init__(self, hidden_size: int, intermediate_size: int,
                 act: Callable = gelu_fast, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.act = act
        self.intermediate = _DenseOut(hidden_size, intermediate_size, dtype)
        self.output = _DenseOut(intermediate_size, hidden_size, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.output.dense(self.act(self.intermediate.dense(x)))


class TransformerBlock(Mlp):
    """Pre-LN ViT block (HF ``VivitLayer``). It is its own ``Mlp`` so the MLP
    parameters sit directly under the layer, as HF names them
    (``layer.N.intermediate.dense``, ``layer.N.output.dense``)."""

    def __init__(self, hidden_size: int, num_heads: int, intermediate_size: int,
                 act: Callable = gelu_fast, layer_norm_eps: float = 1e-6,
                 dtype: torch.dtype = torch.float32):
        super().__init__(hidden_size, intermediate_size, act, dtype)
        self.layernorm_before = LayerNorm(hidden_size, eps=layer_norm_eps)
        self.attention = SelfAttention(hidden_size, num_heads, dtype=dtype)
        self.layernorm_after = LayerNorm(hidden_size, eps=layer_norm_eps)

    def forward(self, x: torch.Tensor, bias: Optional[torch.Tensor] = None,
                kv_valid: Optional[int] = None) -> torch.Tensor:
        x = x + self.attention(self.layernorm_before(x), bias, kv_valid)
        return x + super().forward(self.layernorm_after(x))
