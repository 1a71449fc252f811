"""Attention dispatch — the one entry point the transformer models call.

Counterpart of ``laryngeal_tpu/ops/attention.py:28-121`` and ``:169``.
Layout: (batch, seq, heads, head_dim) everywhere.

Implementations, chosen per call or globally with ``set_attention_impl``:

- ``kernel``: the hand-written CUDA kernels, routed as the JAX package
  routes its ``pallas`` impl (``laryngeal_tpu/ops/attention.py:94-121``):
  a bias-free, unmasked self-attention call (Nq == Nk) with head_dim <= 128
  and N < 512 (TimeSformer's divided attention) goes to ``short_attention``
  (ops/short_attention.py: kernel 6, under autograd ``ShortAttentionFn``
  with kernel 7); every other bias-free call with head_dim <= 128 goes to
  ``flash_attention`` (ops/flash_attention.py: kernel 1, under autograd
  ``FlashAttentionFn`` with kernels 2-4) at any N. A call with a logits
  bias, head_dim <= 128 and max(Nq, Nk) >= 512 goes to ``flash_attention``
  with the bias (kernel 5, under autograd ``FlashAttentionBiasFn`` with the
  f32 recompute backward); a biased call below 512 takes ``attention_plain``
  with the f32 bias, the counterpart of the JAX package's XLA route there.
  A bias never goes to ``short_attention``. The 512 threshold is the JAX
  package's, so both sides run the same function on the same shapes. The
  default for CUDA tensors. On CPU tensors each kernel's plain twin runs.
- ``plain``: ``attention_plain`` (f32 logits, optional bias, differentiable
  by autograd), the port's counterpart of the JAX ``attention_reference``.
  The default on the CPU, and the comparison for the kernels on the card.

``window_attention`` is Swin3D's entry (the JAX ``window_attention``,
``laryngeal_tpu/ops/attention.py:124-166``): ``kernel`` takes kernels 8-9
(ops/window_attention.py, ``WindowAttentionFn`` under autograd) where they
take the shape (every shape of JAX's Pallas kernel, N % 8 == 0 and
D <= 256, and N <= 448 at D <= 128 besides), and JAX's XLA route in plain
PyTorch elsewhere; ``plain`` the same function in plain PyTorch,
differentiable by autograd.

A head_dim above 128 has no kernel: the ``kernel`` impl routes such a call
to ``attention_plain`` on any device, with or without a bias, the
counterpart of the JAX router's XLA route for it
(``laryngeal_tpu/ops/attention.py:121``), where no Pallas kernel exists
either. ``kv_valid`` masks keys at index >= kv_valid
(the trailing-padding mask of the JAX package's ``TrailingKeyMask``).
"""

from __future__ import annotations

from typing import Optional

import torch

from .flash_attention import MAX_HEAD_DIM, attention_plain, flash_attention
from .short_attention import short_attention
from .window_attention import jax_takes_pallas, kernel_takes, window_attention_kernel, \
    window_attention_plain, window_attention_xla

# Sequences shorter than this go to the short-sequence kernel (the JAX
# router's threshold, ``laryngeal_tpu/ops/attention.py:96``).
SHORT_SEQ_LIMIT = 512

IMPLS = ("kernel", "plain")
_IMPL = None  # None => by device


def set_attention_impl(impl: Optional[str]) -> None:
    """Globally select 'kernel' or 'plain'; None restores the device default."""
    global _IMPL
    if impl is not None and impl not in IMPLS:
        raise ValueError(f"Unknown attention impl {impl!r}; expected one of {IMPLS}")
    _IMPL = impl


def get_attention_impl(device: Optional[torch.device] = None) -> str:
    """Resolved impl: explicit override, else 'kernel' on CUDA, 'plain' elsewhere."""
    if _IMPL is not None:
        return _IMPL
    return "kernel" if device is not None and torch.device(device).type == "cuda" else "plain"


def dot_product_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          bias: Optional[torch.Tensor] = None,
                          impl: Optional[str] = None,
                          kv_valid: Optional[int] = None) -> torch.Tensor:
    """Scaled dot-product attention over (B, N, H, D) tensors.

    bias: optional additive logits bias broadcastable to (B, H, Nq, Nk)
    (kernel 5 at max(Nq, Nk) >= 512). kv_valid: keys at index >= kv_valid
    are padding and get no probability mass.
    """
    impl = impl or get_attention_impl(q.device)
    if impl not in IMPLS:
        raise ValueError(f"Unknown attention impl {impl!r}; expected one of {IMPLS}")
    if impl == "kernel" and q.shape[-1] <= MAX_HEAD_DIM:
        if bias is not None:
            if max(q.shape[1], k.shape[1]) >= SHORT_SEQ_LIMIT:
                return flash_attention(q, k, v, kv_valid, bias)
        elif kv_valid is None and 0 < q.shape[1] == k.shape[1] < SHORT_SEQ_LIMIT:
            return short_attention(q, k, v)
        else:
            return flash_attention(q, k, v, kv_valid)
    return attention_plain(q, k, v, kv_valid, bias)


def window_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, bias: torch.Tensor,
                     region_id: Optional[torch.Tensor] = None,
                     impl: Optional[str] = None) -> torch.Tensor:
    """Swin3D windowed attention over (B·nW, N, H, D).

    bias: (H, N, N) relative-position bias (the model's table gather).
    region_id: (nW, N) integer shifted-window region labels (window ``w``
    uses row ``w % nW``), or None for an unshifted block.

    ``kernel`` (the default on CUDA) runs kernel 8, and kernel 9 under
    autograd (``WindowAttentionFn``), at every shape they take
    (``window_attention.kernel_takes``): every N % 8 == 0 at D <= 256, where
    the JAX package runs its Pallas kernel, and every N <= 448 at D <= 128
    (Swin3D's windows, clamped or not, are at most 392). The -100 region mask
    is rebuilt in the kernel from ``region_id`` and the bias stays (H, N, N)
    f32, so the (B·nW, H, N, N) broadcast never exists. Elsewhere (N % 8 != 0
    beyond 448, or D > 256) JAX takes XLA, and so does this route on CUDA and
    CPU tensors alike: ``window_attention_xla``, which rounds the bias to the
    compute dtype (``laryngeal_tpu/ops/attention.py:155-166``), no kernel
    launched. With ``plain``, and on CPU tensors with ``kernel``, the plain
    twin ``window_attention_plain`` runs (autograd differentiates it).
    """
    impl = impl or get_attention_impl(q.device)
    if impl not in IMPLS:
        raise ValueError(f"Unknown attention impl {impl!r}; expected one of {IMPLS}")
    if impl == "kernel":
        n, d = q.shape[1], q.shape[-1]
        if kernel_takes(n, d):
            return window_attention_kernel(q, k, v, bias, region_id)
        if not jax_takes_pallas(n, d):
            return window_attention_xla(q, k, v, bias, region_id)
    return window_attention_plain(q, k, v, bias, region_id)
