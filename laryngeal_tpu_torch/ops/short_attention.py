"""Short-sequence self-attention: the hand-written CUDA kernels, their plain
twins and the autograd wiring.

Counterpart of ``laryngeal_tpu/ops/short_attention.py``. Two Pallas TPU
kernels there have CUDA counterparts here (``csrc/short_attention.cu``):

====  ==============================  =====================================
 #    TPU kernel (launch)             CUDA entry
====  ==============================  =====================================
 6    ``_fwd_kernel`` :101 (:228)     ``short_attention_fwd``
 7    ``_bwd_kernel`` :118 (:249)     ``short_attention_bwd``
====  ==============================  =====================================

Kernel 6 has two bf16 designs behind its one entry: ``wgmma`` (a whole
(sequence, head) pair in shared memory through TMA, S and P·V on wgmma) at
64 < N <= 256, and ``mma.sync`` (two passes over streamed key tiles) at
every other N. Kernel 7 likewise: ``wgmma`` (a pair's Q, K, V and dO
resident through TMA; the query tiles as rows for the row statistics and dQ,
then the key tiles as rows for dK and dV) at 64 < N <= 256 and D <= 64 with
every stride positive (``bwd_wgmma_takes``), ``mma.sync`` elsewhere.
``short_attention_fwd_mma_cuda`` and ``short_attention_bwd_mma_cuda`` run the
``mma.sync`` designs at any shape; only ``chip_smoke.py`` and the card tests
call them, to time and hold the designs against each other, and they count
no launch. ``last_designs`` reports the design the C side ran last, and
``bwd_design_launches`` counts kernel 7's launches by design.

``short_attention`` takes (B, N, H, D) self-attention (Nq == Nk), no bias
and no mask, N < 512, D <= 128, float32 or bfloat16: the calls the router
in ``ops/attention.py`` sends here, which are TimeSformer's divided
attention (temporal N = T, spatial N = 197). The arithmetic is the JAX
kernels': f32 logits scaled after the product, a full softmax normalised
before P·V, P rounded to v's dtype; the backward recomputes P, takes
delta = sum_k dP·P from the f32 P and dP, and rounds dS = P(dP - delta)·scale
to q's dtype. When a gradient is needed it goes through ``ShortAttentionFn``,
the counterpart of the JAX ``custom_vjp`` (``:211-265``): kernel 6 forward
saving (q, k, v), as JAX does, and kernel 7 backward (dq, dk, dv in one
launch). Outside autograd it is kernel 6 too; there is no separate inference
kernel. On a CPU tensor each kernel is replaced by its plain twin
(``short_attention_plain``, ``short_attention_plain_bwd``); on a CUDA tensor
each wrapper launches its kernel or raises.
"""

from __future__ import annotations

import ctypes
import math
from typing import Dict, Optional, Tuple

import torch

from . import _build
from .flash_attention import (F32_REL, _DTYPE_CODE, _check_cuda, _head_dims, _last_designs,
                              _on_cpu, _prepare, _stream)

SOURCE = "short_attention.cu"
MAX_HEAD_DIM = 128
MAX_SEQ = 511  # the JAX router's N < 512
# Kernel launches since the counts were last set to 0 (plain CPU calls do not
# count); ``chip_smoke.py`` reads them to prove the main path used the kernels.
fwd_launches = 0   # kernel 6, short_attention_fwd
bwd_launches = 0   # kernel 7, short_attention_bwd
# Designs of kernels 6-7, by the code ``short_attention_last_design`` returns.
DESIGNS = ("fma", "mma.sync", "wgmma")
# Kernel 7's launches by the design the C side ran (they add up to
# ``bwd_launches``).
bwd_design_launches: Dict[str, int] = {d: 0 for d in DESIGNS}

_fns: Dict[str, object] = {}


def reset_launches() -> None:
    global fwd_launches, bwd_launches
    fwd_launches = bwd_launches = 0
    for d in DESIGNS:
        bwd_design_launches[d] = 0


def last_designs() -> Tuple[Optional[str], Optional[str]]:
    """The designs (``DESIGNS``) of the last launches of kernel 6 and of
    kernel 7 in this process, through any of their entries (the ``_mma``
    ones included), as the C side chose them; None before the first."""
    return _last_designs(SOURCE, "short_attention_last_design", DESIGNS)


def bwd_wgmma_takes(shape, strides, dtype) -> bool:
    """Whether kernel 7's C entry runs its wgmma design: bf16, 64 < N <= 256,
    D (padded to a multiple of 8) <= 64, and every batch, sequence and head
    stride of the launch positive (TMA cannot describe a broadcast stride of
    0). ``shape`` is q's (B, N, H, D); ``strides`` the launch's strides as
    ``_launch`` passes them (3 a tensor; only their signs matter)."""
    n, d_pad = shape[1], -(-shape[3] // 8) * 8
    return (dtype == torch.bfloat16 and 64 < n <= 256 and d_pad <= 64
            and all(s > 0 for s in strides))


def launch_counts() -> Dict[str, int]:
    """Launches of each kernel, by its CUDA entry name."""
    return {"short_attention_fwd": fwd_launches, "short_attention_bwd": bwd_launches}


def _kernel(name: str):
    if name not in _fns:
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        n_ptrs = 7 if name.startswith("short_attention_bwd") else 4
        fn = getattr(_build.load(SOURCE), name)
        fn.restype = ctypes.c_int
        fn.argtypes = ([ptr] * n_ptrs + [i32] * 5
                       + [ctypes.POINTER(ctypes.c_longlong), ctypes.c_float, ptr])
        _fns[name] = fn
    return _fns[name]


def _check(q, k, v):
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4:
        raise ValueError("short_attention expects (B, N, H, D) tensors")
    if not (q.shape == k.shape == v.shape):
        raise ValueError(f"short_attention is self-attention: q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)} must match")
    if not (q.dtype == k.dtype == v.dtype):
        raise ValueError("q, k and v must share a dtype")


def _check_kernel(q, k, v):
    """The kernels' contract: ``_check`` plus 1 <= N <= MAX_SEQ and
    head_dim <= MAX_HEAD_DIM."""
    _check(q, k, v)
    if not 1 <= q.shape[1] <= MAX_SEQ:
        raise ValueError(f"sequence length {q.shape[1]} is outside 1..{MAX_SEQ}")
    if q.shape[-1] > MAX_HEAD_DIM:
        raise ValueError(f"head dim {q.shape[-1]} > {MAX_HEAD_DIM} is not supported")


def _probs(q, k) -> torch.Tensor:
    """(B, H, N, N) f32 P: logits accumulated in f32 then scaled by
    1/sqrt(D), row max subtracted, exp, divided by the row sum."""
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * (1.0 / math.sqrt(q.shape[-1]))
    p = torch.exp(s - s.amax(-1, keepdim=True))
    return p / p.sum(-1, keepdim=True)


def short_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Kernel 6's function in plain PyTorch, the JAX ``_fwd_kernel``'s
    arithmetic: f32 P (``_probs``) rounded to v's dtype, P·V accumulated in
    f32, cast to q's dtype."""
    _check(q, k, v)
    p = _probs(q, k).to(v.dtype).float()
    return torch.einsum("bhqk,bkhd->bqhd", p, v.float()).to(q.dtype)


def short_attention_plain_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                              do: torch.Tensor
                              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Kernel 7's function, the JAX ``_bwd_kernel``'s arithmetic: g = dO in
    q's dtype, P recomputed as in ``short_attention_plain``, dV = P(rounded
    to v's dtype)ᵀ·g, dP = g·Vᵀ in f32, delta = sum_k dP·P per row,
    dS = P·(dP - delta)·scale rounded to q's dtype, dQ = dS·K, dK = dSᵀ·Q;
    products accumulate in f32, each output is cast to its input's dtype."""
    _check(q, k, v)
    scale = 1.0 / math.sqrt(q.shape[-1])
    g = do.to(q.dtype).float()
    p = _probs(q, k)
    dv = torch.einsum("bhqk,bqhd->bkhd", p.to(v.dtype).float(), g)
    dp = torch.einsum("bqhd,bkhd->bhqk", g, v.float())
    delta = (dp * p).sum(-1, keepdim=True)
    ds = (p * (dp - delta) * scale).to(q.dtype).float()
    del p, dp
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, k.float())
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q.float())
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def error_limit(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, ref: torch.Tensor,
                f32_tol: float = 1e-4) -> torch.Tensor:
    """Elementwise limit on |kernel - short_attention_plain| for kernel 6.

    float32: ``f32_tol`` (TF32 off). bfloat16: both sides round the f32 P to
    bf16 at the same place, from values that differ in the last bits
    (summation order, exp, the kernel's multiply by 1/l where the twin
    divides), so a rounding can land one bf16 ulp apart: at most 2^-7 of each
    term, 2^-7·sum_k P|v|. Both round their f32 output: 2^-7·|ref|. 1e-5 for
    f32 arithmetic. ``ref`` is ``short_attention_plain(q, k, v)``."""
    if q.dtype == torch.float32:
        return torch.full(ref.shape, f32_tol, device=ref.device)
    a = torch.einsum("bhqk,bkhd->bqhd", _probs(q, k), v.float().abs())
    return 2.0 ** -7 * a + 2.0 ** -7 * ref.float().abs() + 1e-5


def backward_error_limit(q, k, v, do, refs):
    """Elementwise limits on |kernel - short_attention_plain_bwd| for
    (dq, dk, dv).

    A is each gradient's sum over absolute values (|dS| bounded by
    P·(|g|·|V|ᵀ + |delta|) times scale, which also covers dP's and delta's
    f32 error). Both sides round dS (and P for dV) to the input dtype at the
    same place from f32 values that differ in the last bits: one bf16 ulp,
    2^-7·A. Both round their output: 2^-7·|ref|. f32 arithmetic:
    ``F32_REL``·A. 1e-6 absolute. float32 keeps the f32 terms only.
    ``refs`` = short_attention_plain_bwd(q, k, v, do)."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    qa, ka, va = (x.float().abs() for x in (q, k, v))
    ga = do.to(q.dtype).float()
    p = _probs(q, k)
    delta = (torch.einsum("bqhd,bkhd->bhqk", ga, v.float()) * p).sum(-1, keepdim=True)
    ga = ga.abs()
    ds_abs = torch.einsum("bqhd,bkhd->bhqk", ga, va).add_(delta.abs()).mul_(p).mul_(scale)
    a_dq = torch.einsum("bhqk,bkhd->bqhd", ds_abs, ka)
    a_dk = torch.einsum("bhqk,bqhd->bkhd", ds_abs, qa)
    del ds_abs
    a_dv = torch.einsum("bhqk,bqhd->bkhd", p, ga)
    rel = F32_REL if q.dtype == torch.float32 else 2.0 ** -7 + F32_REL
    out_rel = 0.0 if q.dtype == torch.float32 else 2.0 ** -7
    return tuple(rel * a + out_rel * r.float().abs() + 1e-6
                 for a, r in zip((a_dq, a_dk, a_dv), refs))


def _launch(name, inputs, outputs, d):
    """Launch ``name`` on (B, N, H, D_pad) inputs and outputs laid out by
    ``_prepare``, scale 1/sqrt(d); raises on a launch error."""
    q = inputs[0]
    b, n, h, d_pad = q.shape
    strides = [s for x in (*inputs, *outputs) for s in x.stride()[:3]]
    st = (ctypes.c_longlong * len(strides))(*strides)
    with torch.cuda.device(q.device):
        err = _kernel(name)(*(x.data_ptr() for x in (*inputs, *outputs)), _DTYPE_CODE[q.dtype],
                            b, n, h, d_pad, st, 1.0 / math.sqrt(d), _stream(q))
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {err}")


def _fwd_cuda(name: str, q, k, v) -> Tuple[torch.Tensor, bool]:
    """(output, launched) of kernel 6's C entry ``name`` on CUDA tensors;
    raises if it cannot launch."""
    _check_kernel(q, k, v)
    _check_cuda(name, q, k, v)
    d, d_pad = _head_dims(q)
    out = torch.empty((*q.shape[:3], d_pad), dtype=q.dtype, device=q.device)
    launched = q.shape[0] * q.shape[2] > 0
    if launched:
        _launch(name, [_prepare(x, d_pad) for x in (q, k, v)], [out], d)
    return (out if d_pad == d else out[..., :d]), launched


def short_attention_fwd_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Kernel 6 on CUDA tensors; raises if it cannot launch."""
    global fwd_launches
    out, launched = _fwd_cuda("short_attention_fwd", q, k, v)
    fwd_launches += launched
    return out


def short_attention_fwd_mma_cuda(q: torch.Tensor, k: torch.Tensor,
                                 v: torch.Tensor) -> torch.Tensor:
    """Kernel 6's earlier ``mma.sync`` design at any N, on CUDA tensors (the
    yardstick of the ``wgmma`` one); counts no launch, raises if it cannot
    launch."""
    return _fwd_cuda("short_attention_fwd_mma", q, k, v)[0]


def _bwd_cuda(name: str, q, k, v, do) -> Tuple[Tuple[torch.Tensor, ...], bool]:
    """((dq, dk, dv), launched) of kernel 7's C entry ``name`` on CUDA
    tensors; raises if it cannot launch."""
    _check_kernel(q, k, v)
    if do.shape != q.shape:
        raise ValueError(f"the output gradient {tuple(do.shape)} must be shaped like q "
                         f"{tuple(q.shape)}")
    _check_cuda(name, q, k, v, do)
    d, d_pad = _head_dims(q)
    grads = [torch.empty((*q.shape[:3], d_pad), dtype=q.dtype, device=q.device)
             for _ in range(3)]
    launched = q.shape[0] * q.shape[2] > 0
    if launched:
        _launch(name, [_prepare(x, d_pad) for x in (q, k, v, do.to(q.dtype))], grads, d)
    return tuple(x if d_pad == d else x[..., :d] for x in grads), launched


def short_attention_bwd_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                             do: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Kernel 7 on CUDA tensors: (dq, dk, dv) shaped like q; ``do`` is cast
    to q's dtype first, as the JAX backward casts it. Raises if it cannot
    launch (the wgmma design's failures included: there is no fallback)."""
    global bwd_launches
    grads, launched = _bwd_cuda("short_attention_bwd", q, k, v, do)
    if launched:
        bwd_launches += 1
        bwd_design_launches[last_designs()[1]] += 1
    return grads


def short_attention_bwd_mma_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                 do: torch.Tensor
                                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Kernel 7's earlier ``mma.sync`` design at any shape, on CUDA tensors
    (the yardstick of the ``wgmma`` one); counts no launch, raises if it
    cannot launch."""
    return _bwd_cuda("short_attention_bwd_mma", q, k, v, do)[0]


def short_attention_forward(q, k, v) -> torch.Tensor:
    """Kernel 6 on CUDA, ``short_attention_plain`` on the CPU."""
    _check_kernel(q, k, v)
    if _on_cpu(q):
        return short_attention_plain(q, k, v)
    return short_attention_fwd_cuda(q, k, v)


def short_attention_backward(q, k, v, do):
    """(dq, dk, dv): kernel 7 on CUDA, ``short_attention_plain_bwd`` on the
    CPU."""
    _check_kernel(q, k, v)
    if _on_cpu(q):
        return short_attention_plain_bwd(q, k, v, do)
    return short_attention_bwd_cuda(q, k, v, do)


class ShortAttentionFn(torch.autograd.Function):
    """Short attention with its own backward: the port's counterpart of the
    JAX ``custom_vjp``. Forward: kernel 6, saving (q, k, v); backward:
    kernel 7. Plain twins on the CPU."""

    @staticmethod
    def forward(ctx, q, k, v):
        ctx.save_for_backward(q, k, v)
        return short_attention_forward(q, k, v)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, do):
        return short_attention_backward(*ctx.saved_tensors, do)


def short_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Full-softmax self-attention over (B, N, H, D), N < 512, D <= 128.

    Under autograd (grad enabled and q, k or v requiring grad) it runs
    ``ShortAttentionFn`` (kernels 6 and 7); otherwise kernel 6. CPU tensors
    take the plain twins; CUDA tensors take the kernels (no fallback: a
    failed build or launch raises)."""
    _check_kernel(q, k, v)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return ShortAttentionFn.apply(q, k, v)
    return short_attention_forward(q, k, v)
