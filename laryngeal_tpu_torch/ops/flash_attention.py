"""Flash attention: the hand-written CUDA kernels, their plain twins and the
autograd wiring.

Counterpart of ``laryngeal_tpu/ops/flash_attention.py``. Its five Pallas
TPU kernels have CUDA counterparts here:

====  =========================================  ==============================
 #    TPU kernel (launch)                         CUDA entry, source
====  =========================================  ==============================
 1    ``_attention_kernel`` :51 (:343)            ``flash_attention_fwd``
 2    ``_attention_kernel_lse`` :93 (:330)        ``flash_attention_fwd_lse``
                                                  (both ``csrc/flash_attention_fwd.cu``)
 3    ``_dq_kernel`` :131 (:437)                  ``flash_attention_bwd_dq``
 4    ``_dkv_kernel`` :168 (:451)                 ``flash_attention_bwd_dkv``
                                                  (both ``csrc/flash_attention_bwd.cu``)
 5    ``_attention_kernel_bias`` :213 (:359)      ``flash_attention_fwd_bias``
                                                  (``csrc/flash_attention_bias.cu``)
====  =========================================  ==============================

Kernels 1-4 have two bf16 designs behind their entries, ``wgmma`` (a
block's query rows, or key rows, resident in shared memory through TMA,
the other side streamed past them through an mbarrier ring) and
``mma.sync``. In f32 they run ``wgmma.tf32x3`` at D <= 64 (wgmma on TF32
operands split into two parts, three products per product, which keeps
the f32 limits; kernels 3-4 in ``csrc/flash_attention_bwd_tf32.cu``,
kernel 4 after a pre-pass that splits q and dO into scratch this wrapper
allocates) and the FMA kernels elsewhere. The C side picks one per call
(``launch_fwd`` in ``csrc/flash_attention_fwd.cu``, ``launch_dq`` and
``launch_dkv`` in ``csrc/flash_attention_bwd.cu`` say where each runs) and
``last_forward_designs`` / ``last_backward_designs`` report which ran.
``flash_attention_mma_cuda``, ``flash_attention_lse_mma_cuda`` (C entries
``flash_attention_fwd_mma``, ``flash_attention_fwd_lse_mma``),
``flash_attention_dq_mma_cuda`` and ``flash_attention_dkv_mma_cuda`` run
the ``mma.sync`` design (f32: the FMA kernel) at every shape, so that
``chip_smoke.py`` and the card tests can hold the designs against each
other; they count no launch.
Kernel 5 keeps the ``mma.sync`` design (``csrc/flash_attention_fwd.cuh``).

``flash_attention`` takes (B, Nq, H, D) x (B, Nk, H, D), non-causal,
D <= 128, Nq != Nk allowed, float32 or bfloat16; ``kv_valid`` masks keys at
index >= kv_valid. When a gradient is needed (``torch.is_grad_enabled()``
and q, k or v requires grad) it goes through ``FlashAttentionFn``, the
counterpart of the JAX ``custom_vjp`` (``:261-284``, ``:478-513``): kernel 2
forward saving (q, k, v, o, lse), then delta = rowsum(dO * O) in PyTorch and
kernels 3 and 4. Otherwise it takes kernel 1. On a CPU tensor every kernel
is replaced by its plain twin (``attention_plain``, ``attention_plain_lse``,
``attention_plain_bwd``), so the CPU runs the same wiring; on a CUDA tensor
each wrapper launches its kernel or raises. ``attention_plain`` is the port's
one plain attention: it also takes the logits bias, and ``ops/attention.py``
routes its ``plain`` impl to it.

With a logits ``bias`` (broadcastable to (B, H, Nq, Nk), float32 or
bfloat16) ``flash_attention`` takes kernel 5, which rounds the bias to q's
dtype and adds it in f32 after the scale, as the TPU kernel does
(``:351``, ``:234``); its plain twin is ``attention_plain_bias``. The
kernel reads the bias through a strided view of its broadcast, so the
(B·H, Nq, Nk) copy is never made. Under autograd it goes through
``FlashAttentionBiasFn``: kernel 5 forward saving (q, k, v, bias), and the
JAX package's backward for a biased call (``:488-513``), a recompute of
``attention_plain`` in f32 with the unrounded bias and the ``kv_valid`` mask
applied inside the recomputed function, so dbias comes back in the bias's
own broadcastable shape. The JAX package has no Pallas backward for a
biased call, so this backward is plain PyTorch on both devices.
"""

from __future__ import annotations

import ctypes
import math
from typing import Dict, Optional, Tuple

import torch

from . import _build

SOURCE = "flash_attention_fwd.cu"
BWD_SOURCE = "flash_attention_bwd.cu"
BIAS_SOURCE = "flash_attention_bias.cu"
MAX_HEAD_DIM = 128
# Kernel launches since the counts were last set to 0 (plain CPU calls do not
# count); ``chip_smoke.py`` reads them to prove the main path used the kernels.
launches = 0          # kernel 1, flash_attention_fwd
lse_launches = 0      # kernel 2, flash_attention_fwd_lse
dq_launches = 0       # kernel 3, flash_attention_bwd_dq
dkv_launches = 0      # kernel 4, flash_attention_bwd_dkv
bias_launches = 0     # kernel 5, flash_attention_fwd_bias

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_fns: Dict[str, object] = {}


def reset_launches() -> None:
    global launches, lse_launches, dq_launches, dkv_launches, bias_launches
    launches = lse_launches = dq_launches = dkv_launches = bias_launches = 0


def launch_counts() -> Dict[str, int]:
    """Launches of each kernel, by its CUDA entry name."""
    return {"flash_attention_fwd": launches, "flash_attention_fwd_lse": lse_launches,
            "flash_attention_bwd_dq": dq_launches, "flash_attention_bwd_dkv": dkv_launches,
            "flash_attention_fwd_bias": bias_launches}


def _kernel(name: str):
    if name not in _fns:
        ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        strides = ctypes.POINTER(i64)
        if name in ("flash_attention_fwd", "flash_attention_fwd_mma"):
            source, args = SOURCE, [ptr] * 4 + [i32] * 7 + [i64] * 12
        elif name in ("flash_attention_fwd_lse", "flash_attention_fwd_lse_mma"):
            source, args = SOURCE, [ptr] * 5 + [i32] * 7 + [i64] * 12
        elif name == "flash_attention_fwd_bias":
            source, args = BIAS_SOURCE, [ptr] * 5 + [i32] * 8 + [i64] * 15 + [i32]
        elif name in ("flash_attention_bwd_dq", "flash_attention_bwd_dq_mma"):
            source, args = BWD_SOURCE, [ptr] * 7 + [i32] * 7 + [strides]
        elif name == "flash_attention_bwd_dkv_scratch_floats":
            fn = getattr(_build.load(BWD_SOURCE), name)
            fn.restype, fn.argtypes = ctypes.c_longlong, [i32] * 5 + [strides, i32]
            _fns[name] = fn
            return fn
        else:  # the dK/dV entries: q, k, v, dO, lse, delta, dk, dv, scratch
            source, args = BWD_SOURCE, [ptr] * 9 + [i32] * 7 + [strides]
        fn = getattr(_build.load(source), name)
        fn.restype = ctypes.c_int
        fn.argtypes = args + [ctypes.c_float, ptr]
        _fns[name] = fn
    return _fns[name]


def _check(q, k, v, kv_valid):
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4:
        raise ValueError("attention expects (B, N, H, D) tensors")
    b, _, h, d = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[2] != h or k.shape[3] != d:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}")
    if not (q.dtype == k.dtype == v.dtype):
        raise ValueError("q, k and v must share a dtype")
    if kv_valid is not None and kv_valid < 1:
        raise ValueError(f"kv_valid must be >= 1, got {kv_valid}")


def _check_kernel(q, k, v, kv_valid):
    """The kernels' contract: ``_check`` plus head_dim <= MAX_HEAD_DIM."""
    _check(q, k, v, kv_valid)
    if q.shape[-1] > MAX_HEAD_DIM:
        raise ValueError(f"head dim {q.shape[-1]} > {MAX_HEAD_DIM} is not supported")


def _check_cuda(name, *xs):
    if not all(x.is_cuda for x in xs):
        raise ValueError(f"{name} needs CUDA tensors")
    if xs[0].dtype not in _DTYPE_CODE:
        raise ValueError(f"{name} supports float32 and bfloat16, got {xs[0].dtype}")


def _n_actual(n_k: int, kv_valid: Optional[int]) -> int:
    return n_k if kv_valid is None else min(int(kv_valid), n_k)


def _logits(q, k, kv_valid, bias=None) -> torch.Tensor:
    """(B, H, Nq, Nk) f32 logits scaled by 1/sqrt(D), plus ``bias``, keys >=
    ``kv_valid`` set to -1e30."""
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) / math.sqrt(q.shape[-1])
    if bias is not None:
        s = s + bias.float()
    n_act = _n_actual(k.shape[1], kv_valid)
    if n_act < k.shape[1]:
        s[..., n_act:] = -1e30
    return s


def attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    kv_valid: Optional[int] = None,
                    bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Kernel 1's function in plain PyTorch: f32 logits scaled by
    1/sqrt(D), plus ``bias`` (broadcastable to (B, H, Nq, Nk)) if given,
    keys >= ``kv_valid`` masked to -1e30, softmax, P·V in f32, cast back to
    the input dtype (``_reference`` of the JAX module with the kernel's
    trailing-key mask). Any head_dim; differentiable."""
    _check(q, k, v, kv_valid)
    p = torch.softmax(_logits(q, k, kv_valid, bias), dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, v.float()).to(q.dtype)


def attention_plain_bias(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         bias: torch.Tensor, kv_valid: Optional[int] = None) -> torch.Tensor:
    """Kernel 5's function: ``attention_plain`` with the bias rounded to q's
    dtype first, as the TPU wrapper rounds it (``bias.astype(q.dtype)``)."""
    return attention_plain(q, k, v, kv_valid, bias.to(q.dtype))


def attention_plain_lse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        kv_valid: Optional[int] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel 2's function: ``attention_plain``'s output (the same bits) and
    the f32 log-sum-exp of each row's masked logits, (B, H, Nq) contiguous
    (the JAX kernel's m + log(max(l, 1e-30)))."""
    _check(q, k, v, kv_valid)
    s = _logits(q, k, kv_valid)
    o = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, dim=-1), v.float()).to(q.dtype)
    return o, torch.logsumexp(s, dim=-1)


def attention_delta(o: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """delta = rowsum(dO * O) in f32, (B, H, Nq) contiguous: what the JAX
    package computes in XLA between its forward and backward kernels
    (``flash_attention.py:414``)."""
    return (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()


def attention_plain_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
                        kv_valid: Optional[int] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Kernels 3 and 4's function with the JAX kernels' arithmetic: f32
    S = scale·QKᵀ, P = exp(S − lse) recomputed (keys >= ``kv_valid`` give
    P = 0), dP = dO·Vᵀ, dS = P∘(dP − δ) rounded to the input dtype;
    dQ = scale·dS·K, dK = scale·dSᵀ·Q, dV = P(rounded)ᵀ·dO, accumulated in f32
    and cast to the input dtype. Returns (dq, dk, dv) shaped like q, k, v."""
    _check(q, k, v, kv_valid)
    dt = q.dtype
    scale = 1.0 / math.sqrt(q.shape[-1])
    p = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()).mul_(scale)
    p.sub_(lse.float()[..., None]).exp_()
    n_act = _n_actual(k.shape[1], kv_valid)
    if n_act < k.shape[1]:
        p[..., n_act:] = 0.0
    ds = torch.einsum("bqhd,bkhd->bhqk", do.float(), v.float())
    ds.sub_(attention_delta(o, do)[..., None]).mul_(p)
    ds = ds.to(dt).float()
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, k.float()).mul_(scale)
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q.float()).mul_(scale)
    del ds
    dv = torch.einsum("bhqk,bqhd->bkhd", p.to(dt).float(), do.float())
    return dq.to(dt), dk.to(dt), dv.to(dt)


# Largest |kernel - plain| allowed for lse (f32 on both sides: the logits'
# summation order and exp2 vs exp; a dropped key moves lse by its weight,
# ~1/N = 3e-4 at the ViViT-B shape).
LSE_TOL = 1e-4
# f32 rounding slack relative to the absolute sums a gradient is made of.
F32_REL = 2e-5


def error_limit(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                kv_valid: Optional[int], ref: torch.Tensor,
                f32_tol: float = 1e-4, bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Elementwise limit on |kernel - attention_plain| for the on-card checks
    of kernels 1, 2 and 5's output (kernel 5: against
    ``attention_plain_bias``, with ``bias`` rounded as it rounds it).

    float32: ``f32_tol`` (TF32 off). bfloat16: the kernel rounds P to bf16
    for P.V, off by at most 2^-8 of sum(p |v|) / l, and both sides round
    their f32 output to bf16, at most 2^-8 of each value, so 2^-7 of |ref|;
    1e-5 more for f32 arithmetic (exp2, summation order). ``ref`` is
    ``attention_plain(q, k, v, kv_valid, bias)``."""
    if q.dtype == torch.float32:
        return torch.full(ref.shape, f32_tol, device=ref.device)
    p_abs_v = attention_plain(q, k, v.abs(), kv_valid, bias).float()
    return 2.0 ** -8 * p_abs_v + 2.0 ** -7 * ref.float().abs() + 1e-5


def backward_error_limit(q, k, v, o, lse, do, kv_valid, refs):
    """Elementwise limits on |kernel - attention_plain_bwd| for (dq, dk, dv).

    Each gradient is a sum of products; A is the same sum over absolute
    values (|dS| bounded by P·(|dO|·|V|ᵀ + |δ|), so it also covers dP's f32
    error). Both sides round dS (and P for dV) to the input dtype at the
    same place, but from f32 values that differ in the last bits, so a
    bf16 rounding can land one ulp apart: at most 2^-7 of each term, 2^-7·A.
    Both round their output: 2^-7·|ref|. f32 arithmetic: ``F32_REL``·A.
    1e-6 absolute keeps exact zeros (masked keys) from dividing by zero.
    float32 keeps the f32 terms only. ``refs`` = attention_plain_bwd(...)."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    qa, ka, va, da = (x.float().abs() for x in (q, k, v, do))
    p = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()).mul_(scale)
    p.sub_(lse.float()[..., None]).exp_()
    n_act = _n_actual(k.shape[1], kv_valid)
    if n_act < k.shape[1]:
        p[..., n_act:] = 0.0
    ds_abs = torch.einsum("bqhd,bkhd->bhqk", da, va)
    ds_abs.add_(attention_delta(o, do).abs()[..., None]).mul_(p)
    a_dq = torch.einsum("bhqk,bkhd->bqhd", ds_abs, ka).mul_(scale)
    a_dk = torch.einsum("bhqk,bqhd->bkhd", ds_abs, qa).mul_(scale)
    del ds_abs
    a_dv = torch.einsum("bhqk,bqhd->bkhd", p, da)
    rel = F32_REL if q.dtype == torch.float32 else 2.0 ** -7 + F32_REL
    out_rel = 0.0 if q.dtype == torch.float32 else 2.0 ** -7
    return tuple(rel * a + out_rel * r.float().abs() + 1e-6
                 for a, r in zip((a_dq, a_dk, a_dv), refs))


def _prepare(x: torch.Tensor, d_pad: int) -> torch.Tensor:
    """Lay a (B, N, H, D) tensor out as the kernels read it: unit head-dim
    stride, D padded with zeros to a multiple of 8, every other stride a
    multiple of 8 elements and a 16-byte aligned base."""
    d = x.shape[-1]
    if d_pad != d:
        x = torch.nn.functional.pad(x, (0, d_pad - d))
    ok = (x.stride(-1) == 1 and all(s % 8 == 0 for s in x.stride()[:3])
          and x.data_ptr() % 16 == 0)
    return x if ok else x.contiguous()


def _head_dims(q):
    """(D, D padded to a multiple of 8) of a launch."""
    d = q.shape[-1]
    return d, -(-d // 8) * 8


def _stream(x):
    return torch.cuda.current_stream(x.device).cuda_stream


def bias_view(bias: torch.Tensor, q: torch.Tensor, k: torch.Tensor) -> Tuple[torch.Tensor, int]:
    """Kernel 5's view of ``bias``: its broadcast to (B, H, Nq, Nk) with
    numpy's right-aligned rule, stride 0 on every broadcast dimension (no
    copy), in float32 or bfloat16 (another dtype is cast to q's, the one
    rounding the TPU wrapper makes), with unit key stride (a bias broadcast
    or strided along the keys is copied in its own leading shape). Also the
    block order that runs the blocks reading the same bias tile together
    (``block_coords`` in ``csrc/flash_attention_fwd.cuh``): 1 when only the
    batch is broadcast, 2 only the heads, 3 both, else 0."""
    if bias.ndim > 4:
        raise ValueError(f"bias of {bias.ndim} dimensions cannot broadcast to (B, H, Nq, Nk)")
    if bias.dtype not in _DTYPE_CODE:
        bias = bias.to(q.dtype)
    b, n_q, h, _ = q.shape
    n_k = k.shape[1]
    bias = bias[(None,) * (4 - bias.ndim)]
    keys = bias.expand(*bias.shape[:3], n_k)
    if n_k > 1 and keys.stride(3) != 1:
        bias = keys.contiguous()
    view = bias.expand(b, h, n_q, n_k)
    shared_b = b > 1 and view.stride(0) == 0
    shared_h = h > 1 and view.stride(1) == 0
    order = 3 if shared_b and shared_h else 1 if shared_b else 2 if shared_h else 0
    return view, order


def _forward_cuda(name: str, q, k, v, kv_valid, with_lse: bool = False, bias=None):
    _check_kernel(q, k, v, kv_valid)
    _check_cuda(name, q, k, v, *(() if bias is None else (bias,)))
    b, n_q, h, _ = q.shape
    n_k = k.shape[1]
    d, d_pad = _head_dims(q)
    qp, kp, vp = (_prepare(x, d_pad) for x in (q, k, v))
    out = torch.empty((b, n_q, h, d_pad), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, n_q), dtype=torch.float32, device=q.device) if with_lse else None
    if n_q > 0:
        ptrs = [qp.data_ptr(), kp.data_ptr(), vp.data_ptr()]
        codes, bias_args = [_DTYPE_CODE[q.dtype]], []
        if bias is not None:
            view, order = bias_view(bias, q, k)
            ptrs.append(view.data_ptr())
            codes.append(_DTYPE_CODE[view.dtype])
            bias_args = [*view.stride()[:3], order]
        ptrs.append(out.data_ptr())
        if with_lse:
            ptrs.append(lse.data_ptr())
        with torch.cuda.device(q.device):
            err = _kernel(name)(*ptrs, *codes, b, n_q, n_k, h, d_pad,
                                _n_actual(n_k, kv_valid), *qp.stride()[:3],
                                *kp.stride()[:3], *vp.stride()[:3], *out.stride()[:3],
                                *bias_args, 1.0 / math.sqrt(d), _stream(q))
        if err != 0:
            raise RuntimeError(f"{name} launch failed: cudaError {err}")
    out = out if d_pad == d else out[..., :d]
    return (out, lse) if with_lse else out


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         kv_valid: Optional[int] = None) -> torch.Tensor:
    """Kernel 1 on CUDA tensors; raises if it cannot launch."""
    global launches
    out = _forward_cuda("flash_attention_fwd", q, k, v, kv_valid, with_lse=False)
    if q.shape[1] > 0:
        launches += 1
    return out


def flash_attention_lse_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                             kv_valid: Optional[int] = None
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel 2 on CUDA tensors: (o, lse), lse f32 (B, H, Nq); raises if it
    cannot launch."""
    global lse_launches
    out = _forward_cuda("flash_attention_fwd_lse", q, k, v, kv_valid, with_lse=True)
    if q.shape[1] > 0:
        lse_launches += 1
    return out


def flash_attention_mma_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                             kv_valid: Optional[int] = None) -> torch.Tensor:
    """Kernel 1's earlier designs at every shape, on CUDA tensors: ``mma.sync``
    for bfloat16, the FMA kernel for float32; the yardsticks of the ``wgmma``
    and ``wgmma.tf32x3`` designs. Counts no launch; raises if it cannot
    launch."""
    return _forward_cuda("flash_attention_fwd_mma", q, k, v, kv_valid, with_lse=False)


def flash_attention_lse_mma_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                 kv_valid: Optional[int] = None
                                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel 2's earlier designs, as ``flash_attention_mma_cuda``."""
    return _forward_cuda("flash_attention_fwd_lse_mma", q, k, v, kv_valid, with_lse=True)


def flash_attention_bias_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                              bias: torch.Tensor, kv_valid: Optional[int] = None
                              ) -> torch.Tensor:
    """Kernel 5 on CUDA tensors: ``bias`` broadcastable to (B, H, Nq, Nk);
    raises if it cannot launch."""
    global bias_launches
    out = _forward_cuda("flash_attention_fwd_bias", q, k, v, kv_valid, bias=bias)
    if q.shape[1] > 0:
        bias_launches += 1
    return out


def _backward_launch(name, q, k, v, do, lse, delta, outs, kv_valid):
    b, n_q, h, _ = q.shape
    n_k = k.shape[1]
    d, d_pad = _head_dims(q)
    qp, kp, vp, dop = (_prepare(x, d_pad) for x in (q, k, v, do))
    if lse.shape != (b, h, n_q) or delta.shape != (b, h, n_q):
        raise ValueError(f"lse and delta must be (B, H, Nq) = {(b, h, n_q)}")
    lse = lse.float().contiguous()
    delta = delta.float().contiguous()
    strides = [s for x in (qp, kp, vp, dop, *outs) for s in x.stride()[:3]]
    st = (ctypes.c_longlong * len(strides))(*strides)
    ptrs = [o.data_ptr() for o in outs]
    with torch.cuda.device(q.device):
        if "dkv" in name:  # kernel 4's scratch: its f32 design's pre-pass forms
            n = _kernel("flash_attention_bwd_dkv_scratch_floats")(
                _DTYPE_CODE[q.dtype], b, n_q, h, d_pad, st, name.endswith("_mma"))
            scratch = torch.empty(n, dtype=torch.float32, device=q.device) if n else None
            ptrs.append(scratch.data_ptr() if n else None)
        err = _kernel(name)(qp.data_ptr(), kp.data_ptr(), vp.data_ptr(), dop.data_ptr(),
                            lse.data_ptr(), delta.data_ptr(), *ptrs, _DTYPE_CODE[q.dtype], b,
                            n_q, n_k, h, d_pad, _n_actual(n_k, kv_valid), st,
                            1.0 / math.sqrt(d), _stream(q))
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {err}")


def _dq(name, q, k, v, do, lse, delta, kv_valid) -> Tuple[torch.Tensor, bool]:
    """(dq, launched) of kernel 3's C entry ``name`` on CUDA tensors."""
    _check_kernel(q, k, v, kv_valid)
    _check_cuda(name, q, k, v, do, lse, delta)
    d, d_pad = _head_dims(q)
    dq = torch.empty((*q.shape[:3], d_pad), dtype=q.dtype, device=q.device)
    launched = q.shape[1] > 0 and k.shape[1] > 0
    if launched:
        _backward_launch(name, q, k, v, do, lse, delta, (dq,), kv_valid)
    else:
        dq.zero_()
    return (dq if d_pad == d else dq[..., :d]), launched


def _dkv(name, q, k, v, do, lse, delta, kv_valid):
    """((dk, dv), launched) of kernel 4's C entry ``name`` on CUDA tensors."""
    _check_kernel(q, k, v, kv_valid)
    _check_cuda(name, q, k, v, do, lse, delta)
    d, d_pad = _head_dims(q)
    dk, dv = (torch.empty((*k.shape[:3], d_pad), dtype=k.dtype, device=k.device)
              for _ in range(2))
    launched = q.shape[1] > 0 and k.shape[1] > 0
    if launched:
        _backward_launch(name, q, k, v, do, lse, delta, (dk, dv), kv_valid)
    else:
        dk.zero_()
        dv.zero_()
    return ((dk, dv) if d_pad == d else (dk[..., :d], dv[..., :d])), launched


def flash_attention_dq_cuda(q, k, v, do, lse, delta, kv_valid=None) -> torch.Tensor:
    """Kernel 3 on CUDA tensors: dq shaped like q; raises if it cannot launch."""
    global dq_launches
    dq, launched = _dq("flash_attention_bwd_dq", q, k, v, do, lse, delta, kv_valid)
    dq_launches += launched
    return dq


def flash_attention_dkv_cuda(q, k, v, do, lse, delta, kv_valid=None
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel 4 on CUDA tensors: (dk, dv) shaped like k; raises if it cannot
    launch."""
    global dkv_launches
    grads, launched = _dkv("flash_attention_bwd_dkv", q, k, v, do, lse, delta, kv_valid)
    dkv_launches += launched
    return grads


def flash_attention_dq_mma_cuda(q, k, v, do, lse, delta, kv_valid=None) -> torch.Tensor:
    """Kernel 3's earlier designs at every shape, on CUDA tensors: ``mma.sync``
    for bfloat16, the FMA kernel for float32; the yardsticks of the ``wgmma``
    and ``wgmma.tf32x3`` designs. Counts no launch; raises if it cannot
    launch."""
    return _dq("flash_attention_bwd_dq_mma", q, k, v, do, lse, delta, kv_valid)[0]


def flash_attention_dkv_mma_cuda(q, k, v, do, lse, delta, kv_valid=None
                                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel 4's earlier designs, as ``flash_attention_dq_mma_cuda``."""
    return _dkv("flash_attention_bwd_dkv_mma", q, k, v, do, lse, delta, kv_valid)[0]


# Designs of kernels 1-4, by the code ``flash_attention_fwd_last_design`` and
# ``flash_attention_bwd_last_design`` return ("wgmma.tf32x3": f32 on the
# tensor cores, each product as three TF32 products).
DESIGNS = ("fma", "mma.sync", "wgmma", "wgmma.tf32x3")


# The C design queries, bound once each, by (source, entry).
_design_queries: Dict[Tuple[str, str], object] = {}


def _last_designs(source: str, entry: str, designs=DESIGNS
                  ) -> Tuple[Optional[str], Optional[str]]:
    """The names (``designs``, by code) of the designs the C entry ``entry``
    reports for its two kernels' last launches; None before the first."""
    fn = _design_queries.get((source, entry))
    if fn is None:
        fn = getattr(_build.load(source), entry)
        fn.restype, fn.argtypes = ctypes.c_int, [ctypes.c_int]
        _design_queries[(source, entry)] = fn
    return tuple(designs[c] if c >= 0 else None for c in (fn(0), fn(1)))


def last_forward_designs() -> Tuple[Optional[str], Optional[str]]:
    """The designs (``DESIGNS``) of the last launches of kernel 1 and of
    kernel 2 in this process, through any of their entries (the ``_mma``
    ones included), as the C side chose them; None before the first."""
    return _last_designs(SOURCE, "flash_attention_fwd_last_design")


def last_backward_designs() -> Tuple[Optional[str], Optional[str]]:
    """The designs (``DESIGNS``) of the last launches of kernel 3 and of
    kernel 4 in this process, as the C side chose them; None before the
    first."""
    return _last_designs(BWD_SOURCE, "flash_attention_bwd_last_design")


def _on_cpu(q) -> bool:
    if q.is_cuda:
        return False
    if q.device.type != "cpu":
        raise ValueError(f"flash_attention runs on CUDA or CPU, got {q.device}")
    return True


def flash_attention_lse(q, k, v, kv_valid=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """(o, lse): kernel 2 on CUDA, ``attention_plain_lse`` on the CPU."""
    _check_kernel(q, k, v, kv_valid)
    if _on_cpu(q):
        return attention_plain_lse(q, k, v, kv_valid)
    return flash_attention_lse_cuda(q, k, v, kv_valid)


def flash_attention_bias(q, k, v, bias, kv_valid=None) -> torch.Tensor:
    """Kernel 5 on CUDA, ``attention_plain_bias`` on the CPU (no autograd)."""
    _check_kernel(q, k, v, kv_valid)
    if _on_cpu(q):
        return attention_plain_bias(q, k, v, bias, kv_valid)
    return flash_attention_bias_cuda(q, k, v, bias, kv_valid)


def flash_attention_bwd(q, k, v, o, lse, do, kv_valid=None):
    """(dq, dk, dv): delta in PyTorch, then kernels 3 and 4 on CUDA;
    ``attention_plain_bwd`` on the CPU."""
    _check_kernel(q, k, v, kv_valid)
    if _on_cpu(q):
        return attention_plain_bwd(q, k, v, o, lse, do, kv_valid)
    delta = attention_delta(o, do)
    dq = flash_attention_dq_cuda(q, k, v, do, lse, delta, kv_valid)
    dk, dv = flash_attention_dkv_cuda(q, k, v, do, lse, delta, kv_valid)
    return dq, dk, dv


class FlashAttentionFn(torch.autograd.Function):
    """Attention with the flash backward: the port's counterpart of the JAX
    ``custom_vjp``. Forward: kernel 2, saving (q, k, v, o, lse); backward:
    delta, kernel 3 (dq) and kernel 4 (dk, dv). Plain twins on the CPU."""

    @staticmethod
    def forward(ctx, q, k, v, kv_valid):
        o, lse = flash_attention_lse(q, k, v, kv_valid)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.kv_valid = kv_valid
        return o

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, o, lse, do, ctx.kv_valid)
        return dq, dk, dv, None


class FlashAttentionBiasFn(torch.autograd.Function):
    """Biased attention: the port's counterpart of the JAX ``custom_vjp`` on
    its biased path. Forward: kernel 5 (its plain twin on the CPU), saving
    (q, k, v, bias). Backward: ``attention_plain`` recomputed in f32 with the
    unrounded bias and the ``kv_valid`` mask applied inside it, then
    differentiated by autograd, so dbias has the bias's own shape."""

    @staticmethod
    def forward(ctx, q, k, v, bias, kv_valid):
        ctx.save_for_backward(q, k, v, bias)
        ctx.kv_valid = kv_valid
        return flash_attention_bias(q, k, v, bias, kv_valid)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, do):
        inputs = [x.detach().requires_grad_(need)
                  for x, need in zip(ctx.saved_tensors, ctx.needs_input_grad)]
        q, k, v, bias = inputs
        with torch.enable_grad():
            o = attention_plain(q, k, v, ctx.kv_valid, bias)
            grads = iter(torch.autograd.grad(o, [x for x in inputs if x.requires_grad], do))
        return (*(next(grads) if x.requires_grad else None for x in inputs), None)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    kv_valid: Optional[int] = None,
                    bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Scaled dot-product attention over (B, Nq, H, D) x (B, Nk, H, D).

    Under autograd (grad enabled and q, k or v requiring grad) it runs
    ``FlashAttentionFn`` (kernels 2-4); otherwise kernel 1. With a logits
    ``bias`` (broadcastable to (B, H, Nq, Nk)) it runs kernel 5, under
    autograd (q, k, v or the bias requiring grad) ``FlashAttentionBiasFn``.
    CPU tensors take the plain twins; CUDA tensors take the kernels (no
    fallback: a failed build or launch raises). ``kv_valid`` masks keys at
    index >= kv_valid out of the softmax."""
    _check_kernel(q, k, v, kv_valid)
    if bias is not None:
        if torch.is_grad_enabled() and any(x.requires_grad for x in (q, k, v, bias)):
            return FlashAttentionBiasFn.apply(q, k, v, bias, kv_valid)
        return flash_attention_bias(q, k, v, bias, kv_valid)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return FlashAttentionFn.apply(q, k, v, kv_valid)
    if _on_cpu(q):
        return attention_plain(q, k, v, kv_valid)
    return flash_attention_cuda(q, k, v, kv_valid)
