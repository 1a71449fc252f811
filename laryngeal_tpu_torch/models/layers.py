"""Shared transformer building blocks (counterpart of
``laryngeal_tpu/models/layers.py``).

Module attribute names follow the HF torch module tree, so a model's
``state_dict`` carries HF names (``attention.attention.query``,
``attention.output.dense``, ``intermediate.dense``, ``output.dense``,
``layernorm_before/after``) and ``compat/flax_weights.py`` is a mechanical
relayout.

Precision follows Flax's ``dtype`` semantics: parameters stay float32 and
each ``Dense`` casts its input and parameters to the compute dtype;
``LayerNorm`` computes and returns float32, as Flax's does when its input is
bf16 and its parameters f32.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch import nn

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
