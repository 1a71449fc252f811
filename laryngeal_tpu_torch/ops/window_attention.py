"""Swin3D shifted-window attention: the hand-written CUDA kernels, their
plain twins and the autograd wiring.

Counterpart of ``laryngeal_tpu/ops/window_attention.py`` and of the two
ablation kernels of ``scripts/bench_window_kernel.py``. Their Pallas TPU
kernels have CUDA counterparts here (``csrc/window_attention.cu``):

====  ==========================================  ==============================
 #    TPU kernel (launch)                          CUDA entry
====  ==========================================  ==============================
 8    ``window_attention.py:55 _fwd_kernel``       ``window_attention_fwd``
      (:183)                                       (mode 0, one head a block)
 9    ``window_attention.py:95 _bwd_kernel``       ``window_attention_bwd``
      (:209)
 11   ``bench_window_kernel.py:76                  ``window_attention_fwd``
      _fwd_kernel_sm`` (:124)                      (mode 1 bf16sm, mode 2 exp2)
 12   ``bench_window_kernel.py:96                  ``window_attention_fwd``
      _fwd_kernel_h2`` (:142)                      (2 or 3 heads a block)
====  ==========================================  ==============================

Layout: q, k, v, out (B·nW, N, H, D); ``bias`` (H, N, N), the gathered
relative-position bias; ``region_id`` (nW, N) integer region labels of a
shifted block (window ``w`` uses row ``w % nW``, the JAX layout, batch
outer), or None for an unshifted block. The arithmetic is the JAX kernels':
S = (Q Kᵀ in f32)·scale + bias[h], then -100 added where the two positions'
region ids differ, an exact f32 softmax, the normalised P rounded to v's
dtype before P·V. The backward recomputes P, takes δ = Σ P·dP from the f32
P and dP, ds = P·(dP − δ) in f32; dQ = (bf16(ds)·K)·scale and
dK = (bf16(ds)ᵀ·Q)·scale round ds BEFORE the scale (unlike kernel 7), dV =
bf16(P)ᵀ·G, and dbias = the unrounded f32 ds summed over all B·nW windows,
cast to the bias dtype. Under autograd ``WindowAttentionFn`` (the
``custom_vjp`` counterpart, ``:224-245``) runs kernel 8 forward and kernel 9
backward; otherwise kernel 8. On a CPU tensor each kernel is replaced by its
plain twin (``window_attention_plain``, ``window_attention_plain_bwd``); on a
CUDA tensor each wrapper launches its kernel or raises.

The kernels take every shape where the JAX package runs its Pallas kernel
(N % 8 == 0 and D <= 256, ``supports_shape``,
``laryngeal_tpu/ops/window_attention.py:247-250``), and every N <=
``HELD_MAX_SEQ`` besides (448 = 7 key tiles of 64; Swin3D's full (8, 7, 7)
window is 392), D padded to a multiple of 8 inside the wrapper. Two
designs: the held ones (bias rows held in shared memory, ``mma.sync`` in
bf16, the FMA kernel with fixed shared arrays in f32) at N <=
``HELD_MAX_SEQ`` and D <= ``HELD_MAX_HEAD_DIM`` (128), and the wide path at
every other shape (the FMA units, the bias, region ids and row statistics
read from device memory, up to D = 256). The C side picks one per call and
``last_designs`` reports which ran. The bias stays f32 at every shape the
kernels take. Where JAX takes XLA and the kernels do not take the shape (N
% 8 != 0 with N > 448, or D > 256), the router
(``ops.attention.window_attention``) runs ``window_attention_xla`` (the
bias rounded to the compute dtype, ``laryngeal_tpu/ops/attention.py:
124-166``) on either device, differentiated by autograd and counting no
launch.
"""

from __future__ import annotations

import ctypes
import math
from typing import Dict, Optional, Tuple

import torch

from . import _build
from .flash_attention import F32_REL, _DTYPE_CODE, _check_cuda, _head_dims, _last_designs, \
    _on_cpu, _prepare, _stream

SOURCE = "window_attention.cu"
# The held designs' domain; the wide path takes the rest of ``kernel_takes``.
HELD_MAX_SEQ = 448
HELD_MAX_HEAD_DIM = 128
# The JAX package's gate for its Pallas window kernel (``supports_shape``,
# ``laryngeal_tpu/ops/window_attention.py:247-250``): N % 8 == 0 and D <= this.
JAX_PALLAS_MAX_HEAD_DIM = 256
MAX_HEAD_DIM = JAX_PALLAS_MAX_HEAD_DIM
# Designs of kernels 8-9, by the code ``window_attention_last_design`` returns.
DESIGNS = ("fma", "mma.sync", "wide")
MASK_VALUE = -100.0  # torchvision's Swin adds -100 across shifted-region boundaries
# Softmax modes of the forward kernel: 0 = exp (kernel 8), 1 = (s - m) rounded
# to bf16 before exp, 2 = exp2 of (s - m)·log2(e) (kernel 11's two softmaxes).
MODES = {"exp": 0, "bf16sm": 1, "exp2": 2}
VARIANTS = ("bf16sm", "exp2", "h2")
VARIANT_MAX_HEAD_DIM = 64  # the variants are built for D <= 64 (Swin3D's is 32)
# Kernel launches since the counts were last set to 0 (plain CPU calls do not
# count); ``chip_smoke.py`` reads them to prove a path used the kernels.
fwd_launches = 0   # kernel 8, window_attention_fwd
bwd_launches = 0   # kernel 9, window_attention_bwd
variant_launches = {kind: 0 for kind in VARIANTS}  # kernels 11 (bf16sm, exp2), 12 (h2)

_fns: Dict[str, object] = {}


def reset_launches() -> None:
    global fwd_launches, bwd_launches
    fwd_launches = bwd_launches = 0
    for kind in VARIANTS:
        variant_launches[kind] = 0


def launch_counts() -> Dict[str, int]:
    """Launches of each kernel, by its CUDA entry name (the variants by
    their softmax or head blocking)."""
    return {"window_attention_fwd": fwd_launches, "window_attention_bwd": bwd_launches,
            **{f"window_attention_fwd_{k}": n for k, n in variant_launches.items()}}


def _kernel(name: str):
    if name not in _fns:
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        st = ctypes.POINTER(ctypes.c_longlong)
        if name == "window_attention_fwd":
            args = [ptr] * 6 + [i32] * 8 + [st, ctypes.c_float, ptr]
        else:
            args = [ptr] * 12 + [i32] * 8 + [st, ctypes.c_float, ptr]
        fn = getattr(_build.load(SOURCE), name)
        fn.restype = ctypes.c_int
        fn.argtypes = args
        _fns[name] = fn
    return _fns[name]


def _check(q, k, v, bias, region_id):
    if q.ndim != 4 or not (q.shape == k.shape == v.shape):
        raise ValueError(f"window_attention expects matching (B·nW, N, H, D) q, k, v; got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    if not (q.dtype == k.dtype == v.dtype):
        raise ValueError("q, k and v must share a dtype")
    bw, n, h, _ = q.shape
    if tuple(bias.shape) != (h, n, n):
        raise ValueError(f"bias must be (H, N, N) = {(h, n, n)}, got {tuple(bias.shape)}")
    if region_id is not None:
        if region_id.ndim != 2 or region_id.shape[1] != n:
            raise ValueError(f"region_id must be (nW, {n}), got {tuple(region_id.shape)}")
        if region_id.dtype.is_floating_point or region_id.dtype == torch.bool:
            raise ValueError(f"region_id must be an integer tensor, got {region_id.dtype}")
        if bw % region_id.shape[0]:
            raise ValueError(f"B·nW = {bw} is not a multiple of nW = {region_id.shape[0]}")


def _check_kernel(q, k, v, bias, region_id):
    """The kernels' contract: ``_check`` plus ``kernel_takes`` (N, D)."""
    _check(q, k, v, bias, region_id)
    n, d = q.shape[1], q.shape[-1]
    if not kernel_takes(n, d):
        raise ValueError(f"kernels 8-9 take N <= {HELD_MAX_SEQ} at D <= {HELD_MAX_HEAD_DIM}, or "
                         f"N % 8 == 0 at D <= {MAX_HEAD_DIM}; got N = {n}, D = {d}")


def held_takes(n: int, d: int) -> bool:
    """Whether the held designs take windows of ``n`` positions at head dim
    ``d`` (elsewhere in ``kernel_takes`` the wide path runs)."""
    return 1 <= n <= HELD_MAX_SEQ and d <= HELD_MAX_HEAD_DIM


def kernel_takes(n: int, d: int) -> bool:
    """Whether kernels 8-9 take windows of ``n`` positions at head dim ``d``:
    the held designs' domain and every shape of the JAX Pallas kernel's."""
    return held_takes(n, d) or (n >= 1 and jax_takes_pallas(n, d))


def jax_takes_pallas(n: int, d: int) -> bool:
    """Whether the JAX package takes its Pallas kernel (f32 bias) at (n, d);
    elsewhere it takes XLA with the bias rounded to the compute dtype."""
    return n % 8 == 0 and d <= JAX_PALLAS_MAX_HEAD_DIM


def last_designs() -> Tuple[Optional[str], Optional[str]]:
    """The designs (``DESIGNS``) of the last launches of kernel 8 (the
    kernel-11/12 variants included) and of kernel 9 in this process, as the
    C side chose them; None before the first."""
    return _last_designs(SOURCE, "window_attention_last_design", DESIGNS)


def region_mask(region_id: torch.Tensor) -> torch.Tensor:
    """(nW, N) region ids -> (nW, N, N) bool, True where two positions lie
    in different regions (where the kernels add ``MASK_VALUE``)."""
    return region_id[:, :, None] != region_id[:, None, :]


def _logits(q, k, bias, region_id) -> torch.Tensor:
    """(B·nW, H, N, N) f32 S: (Q Kᵀ in f32)·scale + bias[h], then
    ``MASK_VALUE`` added across region boundaries (the JAX kernel's order)."""
    bw, n, h, d = q.shape
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * (1.0 / math.sqrt(d))
    s = s + bias.float()
    if region_id is not None:
        mask = region_mask(region_id.to(q.device))
        nw = mask.shape[0]
        s = s.view(bw // nw, nw, h, n, n)
        s = torch.where(mask[None, :, None], s + MASK_VALUE, s).view(bw, h, n, n)
    return s


def _softmax(s: torch.Tensor, kind: str = "exp") -> torch.Tensor:
    """exp(S - max) / sum, f32; ``bf16sm`` rounds S - max to bf16 before
    the exp (``bench_window_kernel.py:63-66``)."""
    z = s - s.amax(-1, keepdim=True)
    if kind == "bf16sm":
        z = z.to(torch.bfloat16).float()
    e = torch.exp(z)
    return e / e.sum(-1, keepdim=True)


def _probs(q, k, bias, region_id, kind: str = "exp") -> torch.Tensor:
    return _softmax(_logits(q, k, bias, region_id), kind)


def _pv(p, v, q_dtype) -> torch.Tensor:
    """P rounded to v's dtype, P·V accumulated in f32, cast to q's dtype."""
    return torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).float(), v.float()).to(q_dtype)


def window_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           bias: torch.Tensor, region_id: Optional[torch.Tensor] = None,
                           kind: str = "exp") -> torch.Tensor:
    """Kernel 8's function in plain PyTorch, the JAX ``_fwd_kernel``'s
    arithmetic (``window_attention.py:82-92``); with ``kind`` the twin of a
    kernel-11/12 variant: ``bf16sm`` rounds S - max to bf16 before exp,
    ``exp2`` and ``h2`` compute what kernel 8 computes."""
    _check(q, k, v, bias, region_id)
    if kind not in ("exp",) + VARIANTS:
        raise ValueError(f"unknown variant {kind!r}; expected one of {VARIANTS}")
    return _pv(_probs(q, k, bias, region_id, "bf16sm" if kind == "bf16sm" else "exp"), v,
               q.dtype)


def window_attention_xla(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         bias: torch.Tensor,
                         region_id: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The JAX package's XLA route (``laryngeal_tpu/ops/attention.py:152-166``
    into ``jax.nn.dot_product_attention``): the bias, with ``MASK_VALUE``
    added in f32 across region boundaries, rounded to q's dtype, added to the
    f32 scaled logits; then ``window_attention_plain``'s softmax and P·V.
    Differentiable by autograd (dbias through the rounding)."""
    _check(q, k, v, bias, region_id)
    bw, n, h, d = q.shape
    full = bias.float()[None]  # (1, H, N, N)
    if region_id is not None:
        mask = region_mask(region_id.to(q.device))
        full = full + MASK_VALUE * mask[:, None].float()  # (nW, H, N, N)
    nw = full.shape[0]
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * (1.0 / math.sqrt(d))
    s = (s.view(bw // nw, nw, h, n, n) + full.to(q.dtype).float()[None]).view(bw, h, n, n)
    return _pv(_softmax(s), v, q.dtype)


def window_attention_plain_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                               bias: torch.Tensor, region_id: Optional[torch.Tensor],
                               do: torch.Tensor
                               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Kernel 9's function, the JAX ``_bwd_kernel``'s arithmetic
    (``window_attention.py:111-136``): g = dO in q's dtype, P recomputed as
    in the forward, dV = P(rounded to g's dtype)ᵀ·g, dP = g·Vᵀ in f32,
    δ = Σ_k P·dP, ds = P·(dP − δ); dQ = (ds rounded to q's dtype)·K·scale,
    dK = (ds rounded)ᵀ·Q·scale; dbias = the f32 ds summed over the B·nW
    windows, cast to the bias dtype. Products accumulate in f32 and each
    gradient is cast to its input's dtype."""
    _check(q, k, v, bias, region_id)
    scale = 1.0 / math.sqrt(q.shape[-1])
    g = do.to(q.dtype)
    p = _probs(q, k, bias, region_id)
    dv = torch.einsum("bhqk,bqhd->bkhd", p.to(g.dtype).float(), g.float())
    ds = torch.einsum("bqhd,bkhd->bhqk", g.float(), v.float())
    ds.sub_((p * ds).sum(-1, keepdim=True)).mul_(p)
    del p
    dbias = ds.sum(0).to(bias.dtype)
    ds_lp = ds.to(q.dtype).float()
    del ds
    dq = torch.einsum("bhqk,bkhd->bqhd", ds_lp, k.float()) * scale
    dk = torch.einsum("bhqk,bqhd->bkhd", ds_lp, q.float()) * scale
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), dbias


def error_limit(q, k, v, bias, region_id, ref, kind: str = "exp",
                f32_tol: float = 1e-4) -> torch.Tensor:
    """Elementwise limit on |kernel - window_attention_plain| for kernels 8,
    11 and 12.

    float32: ``f32_tol`` (TF32 off). bfloat16: both sides round the f32 P to
    bf16 at the same place from values that differ in the last bits, so a
    rounding can land one bf16 ulp apart: 2^-7·Σ_k P|v|; both round their
    output: 2^-7·|ref|; 1e-5 for f32 arithmetic. ``bf16sm`` also rounds
    z = S - max to bf16 on both sides from f32 values that differ in the
    last bits: one ulp of z moves exp(z) by a factor up to 2^-8·|z|, so each
    P moves by at most 2^-8·(|z| + Σ_k P|z|) (the term and the normaliser):
    2^-8·(Σ_k P|z||v| + Σ_k P|z| · Σ_k P|v|). ``ref`` is
    ``window_attention_plain(q, k, v, bias, region_id, kind)``."""
    if q.dtype == torch.float32 and kind != "bf16sm":
        return torch.full(ref.shape, f32_tol, device=ref.device)
    s = _logits(q, k, bias, region_id)
    p = _softmax(s, "bf16sm" if kind == "bf16sm" else "exp")
    va = v.float().abs()
    a = torch.einsum("bhqk,bkhd->bqhd", p, va)
    limit = 2.0 ** -7 * a + 2.0 ** -7 * ref.float().abs() + 1e-5
    if q.dtype == torch.float32:
        limit = torch.full(ref.shape, f32_tol, device=ref.device)
    if kind == "bf16sm":
        z = (s.amax(-1, keepdim=True) - s).mul_(p)  # P|z|
        limit = limit + 2.0 ** -8 * (torch.einsum("bhqk,bkhd->bqhd", z, va)
                                     + z.sum(-1).transpose(1, 2)[..., None] * a)
    return limit


def backward_error_limit(q, k, v, bias, region_id, do, refs):
    """Elementwise limits on |kernel - window_attention_plain_bwd| for
    (dq, dk, dv, dbias).

    A is each gradient's sum over absolute values (|ds| bounded by
    P·(|g|·|V|ᵀ + |δ|), which also covers dP's and δ's f32 error). dq, dk,
    dv: both sides round ds (and P for dV) to the input dtype at the same
    place from f32 values that differ in the last bits, one bf16 ulp:
    2^-7·A; both round their output: 2^-7·|ref|; f32 arithmetic
    ``F32_REL``·A; 1e-6 absolute. dbias is the unrounded f32 ds summed over
    the windows in another order: ``F32_REL``·A + 1e-6 in either dtype.
    float32 keeps the f32 terms only. ``refs`` =
    window_attention_plain_bwd(q, k, v, bias, region_id, do)."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    qa, ka, va = (x.float().abs() for x in (q, k, v))
    g = do.to(q.dtype).float()
    p = _probs(q, k, bias, region_id)
    delta = (torch.einsum("bqhd,bkhd->bhqk", g, v.float()) * p).sum(-1, keepdim=True)
    ga = g.abs()
    ds_abs = torch.einsum("bqhd,bkhd->bhqk", ga, va).add_(delta.abs()).mul_(p)
    a_bias = ds_abs.sum(0)
    a_dq = torch.einsum("bhqk,bkhd->bqhd", ds_abs, ka).mul_(scale)
    a_dk = torch.einsum("bhqk,bqhd->bkhd", ds_abs, qa).mul_(scale)
    del ds_abs
    a_dv = torch.einsum("bhqk,bqhd->bkhd", p, ga)
    rel = F32_REL if q.dtype == torch.float32 else 2.0 ** -7 + F32_REL
    out_rel = 0.0 if q.dtype == torch.float32 else 2.0 ** -7
    limits = [rel * a + out_rel * r.float().abs() + 1e-6
              for a, r in zip((a_dq, a_dk, a_dv), refs[:3])]
    return (*limits, F32_REL * a_bias + 1e-6)


def _rid_arg(region_id, device):
    """(pointer, nW, keep-alive tensor) of the region ids as the kernels
    read them: int32, contiguous, on ``device``; null and nW = 1 for None."""
    if region_id is None:
        return None, 1, None
    rid = region_id.to(device=device, dtype=torch.int32).contiguous()
    return rid.data_ptr(), rid.shape[0], rid


def _launch_fwd(q, k, v, bias, region_id, mode: int, heads_per_block: int) -> torch.Tensor:
    """One forward launch: ``heads_per_block`` 0 runs kernels 8 and 11 (a
    block holds its query tile's bias rows and walks several windows), 1-3
    kernel 12 (a block takes that many heads of one window)."""
    _check_kernel(q, k, v, bias, region_id)
    _check_cuda("window_attention_fwd", q, k, v, bias)
    bw, n, h, _ = q.shape
    d, d_pad = _head_dims(q)
    qp, kp, vp = (_prepare(x, d_pad) for x in (q, k, v))
    out = torch.empty((bw, n, h, d_pad), dtype=q.dtype, device=q.device)
    bias_f = bias.to(device=q.device, dtype=torch.float32).contiguous()
    rid_ptr, nw, rid = _rid_arg(region_id, q.device)
    strides = [s for x in (qp, kp, vp, out) for s in x.stride()[:3]]
    st = (ctypes.c_longlong * len(strides))(*strides)
    with torch.cuda.device(q.device):
        err = _kernel("window_attention_fwd")(
            qp.data_ptr(), kp.data_ptr(), vp.data_ptr(), out.data_ptr(), bias_f.data_ptr(),
            rid_ptr, _DTYPE_CODE[q.dtype], bw, n, h, d_pad, nw, mode, heads_per_block, st,
            1.0 / math.sqrt(d), _stream(q))
    if err != 0:
        raise RuntimeError(f"window_attention_fwd launch failed: cudaError {err}")
    del rid
    return out if d_pad == d else out[..., :d]


def window_attention_fwd_cuda(q, k, v, bias, region_id=None) -> torch.Tensor:
    """Kernel 8 on CUDA tensors; raises if it cannot launch."""
    global fwd_launches
    out = _launch_fwd(q, k, v, bias, region_id, MODES["exp"], 0)
    fwd_launches += 1
    return out


def heads_per_block(h: int) -> int:
    """Kernel 12's heads a block: 2 when H is even, else 3 when H is a
    multiple of 3, else 1 (``bench_window_kernel.py:134``)."""
    return 2 if h % 2 == 0 else (3 if h % 3 == 0 else 1)


def _check_variant(q, k, v, bias, region_id, kind: str):
    """The variants' contract: a known ``kind``, ``_check_kernel``, and the
    held designs' N <= HELD_MAX_SEQ at D <= VARIANT_MAX_HEAD_DIM."""
    if kind not in VARIANTS:
        raise ValueError(f"unknown variant {kind!r}; expected one of {VARIANTS}")
    _check_kernel(q, k, v, bias, region_id)
    if q.shape[-1] > VARIANT_MAX_HEAD_DIM or q.shape[1] > HELD_MAX_SEQ:
        raise ValueError(f"the kernel-11/12 variants take head dim <= {VARIANT_MAX_HEAD_DIM} "
                         f"and N <= {HELD_MAX_SEQ}, got {q.shape[-1]} and {q.shape[1]}")


def window_attention_variant_cuda(q, k, v, bias, region_id, kind: str) -> torch.Tensor:
    """Kernel 11 (``kind`` 'bf16sm' or 'exp2') or kernel 12 ('h2') on CUDA
    bfloat16 tensors; raises if it cannot launch."""
    _check_variant(q, k, v, bias, region_id, kind)
    if q.dtype != torch.bfloat16:
        raise ValueError(f"the kernel-11/12 variants take bfloat16 (the ablation's dtype), "
                         f"got {q.dtype}")
    if kind == "h2":
        out = _launch_fwd(q, k, v, bias, region_id, MODES["exp"], heads_per_block(q.shape[2]))
    else:
        out = _launch_fwd(q, k, v, bias, region_id, MODES[kind], 0)
    variant_launches[kind] += 1
    return out


def window_attention_variant(q, k, v, bias, region_id, kind: str) -> torch.Tensor:
    """A kernel-11/12 ablation variant of kernel 8 (forward only): kernel on
    CUDA, ``window_attention_plain(..., kind)`` on the CPU."""
    _check_variant(q, k, v, bias, region_id, kind)
    if _on_cpu(q):
        return window_attention_plain(q, k, v, bias, region_id, kind)
    return window_attention_variant_cuda(q, k, v, bias, region_id, kind)


def dbias_groups(bw: int, n: int, h: int, sm_count: int, dtype: torch.dtype,
                 wide: bool = False) -> Tuple[int, int]:
    """(windows a group, groups) of kernel 9's dbias partial sums. Each
    group's (H, N, N) partial goes to a scratch buffer that a last launch
    sums in group order. bf16, held design: one block per (head, 64-query
    tile, 64-key tile, window group) keeps its tile of the sum in registers
    over the group's windows, 4 blocks an SM; f32 and the wide path
    (``wide``): one block per (head, 64-query tile, window group) keeps its
    64 rows in shared memory, 2 blocks an SM. The group count minimises
    (waves of blocks) x (windows a block walks + 1, its partial's write)."""
    n_t = -(-n // 64)
    if dtype == torch.bfloat16 and not wide:
        tiles, resident = h * n_t * n_t, 4 * sm_count
    else:
        tiles, resident = h * n_t, 2 * sm_count
    best = None
    for groups in range(1, min(bw, 64) + 1):
        per_group = -(-bw // groups)
        blocks = tiles * -(-bw // per_group)
        cost = -(-blocks // resident) * (per_group + 1)
        if best is None or cost < best[0]:
            best = (cost, per_group, -(-bw // per_group))
    return best[1], best[2]


def window_attention_bwd_cuda(q, k, v, bias, region_id, do):
    """Kernel 9 on CUDA tensors: (dq, dk, dv, dbias), dq/dk/dv shaped like
    q, dbias like ``bias`` in its dtype; ``do`` is cast to q's dtype first.
    Scratch (row statistics and the per-group dbias partials) is allocated
    here. Raises if it cannot launch."""
    global bwd_launches
    _check_kernel(q, k, v, bias, region_id)
    if do.shape != q.shape:
        raise ValueError(f"the output gradient {tuple(do.shape)} must be shaped like q "
                         f"{tuple(q.shape)}")
    _check_cuda("window_attention_bwd", q, k, v, bias, do)
    bw, n, h, _ = q.shape
    d, d_pad = _head_dims(q)
    qp, kp, vp, gp = (_prepare(x, d_pad) for x in (q, k, v, do.to(q.dtype)))
    grads = [torch.empty((bw, n, h, d_pad), dtype=q.dtype, device=q.device) for _ in range(3)]
    bias_f = bias.to(device=q.device, dtype=torch.float32).contiguous()
    dbias = torch.empty((h, n, n), dtype=torch.float32, device=q.device)
    stats = torch.empty((bw, h, 3, n), dtype=torch.float32, device=q.device)
    per_group, groups = dbias_groups(
        bw, n, h, torch.cuda.get_device_properties(q.device).multi_processor_count, q.dtype,
        wide=not held_takes(n, d_pad))
    partial = (torch.empty((groups, h, n, n), dtype=torch.float32, device=q.device)
               if groups > 1 else dbias)
    rid_ptr, nw, rid = _rid_arg(region_id, q.device)
    strides = [s for x in (qp, kp, vp, gp, *grads) for s in x.stride()[:3]]
    st = (ctypes.c_longlong * len(strides))(*strides)
    with torch.cuda.device(q.device):
        err = _kernel("window_attention_bwd")(
            qp.data_ptr(), kp.data_ptr(), vp.data_ptr(), gp.data_ptr(), bias_f.data_ptr(),
            rid_ptr, *(x.data_ptr() for x in grads), dbias.data_ptr(), stats.data_ptr(),
            partial.data_ptr(), _DTYPE_CODE[q.dtype], bw, n, h, d_pad, nw, per_group, groups,
            st, 1.0 / math.sqrt(d), _stream(q))
    if err != 0:
        raise RuntimeError(f"window_attention_bwd launch failed: cudaError {err}")
    bwd_launches += 1
    del rid, stats, partial
    dq, dk, dv = (x if d_pad == d else x[..., :d] for x in grads)
    return dq, dk, dv, dbias.to(bias.dtype)


def window_attention_forward(q, k, v, bias, region_id=None) -> torch.Tensor:
    """Kernel 8 on CUDA, ``window_attention_plain`` on the CPU."""
    _check_kernel(q, k, v, bias, region_id)
    if _on_cpu(q):
        return window_attention_plain(q, k, v, bias, region_id)
    return window_attention_fwd_cuda(q, k, v, bias, region_id)


def window_attention_backward(q, k, v, bias, region_id, do):
    """(dq, dk, dv, dbias): kernel 9 on CUDA, ``window_attention_plain_bwd``
    on the CPU."""
    _check_kernel(q, k, v, bias, region_id)
    if _on_cpu(q):
        return window_attention_plain_bwd(q, k, v, bias, region_id, do)
    return window_attention_bwd_cuda(q, k, v, bias, region_id, do)


class WindowAttentionFn(torch.autograd.Function):
    """Window attention with its own backward: the port's counterpart of the
    JAX ``custom_vjp``. Forward: kernel 8, saving (q, k, v, bias); backward:
    kernel 9, giving dq, dk, dv and dbias, and nothing for ``region_id``.
    Plain twins on the CPU."""

    @staticmethod
    def forward(ctx, q, k, v, bias, region_id):
        ctx.save_for_backward(q, k, v, bias)
        ctx.region_id = region_id
        return window_attention_forward(q, k, v, bias, region_id)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, do):
        q, k, v, bias = ctx.saved_tensors
        dq, dk, dv, dbias = window_attention_backward(q, k, v, bias, ctx.region_id, do)
        return dq, dk, dv, dbias, None


def window_attention_kernel(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                            bias: torch.Tensor,
                            region_id: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Window attention over (B·nW, N, H, D) at a shape ``kernel_takes``.

    Under autograd (grad enabled and q, k, v or bias requiring grad) it runs
    ``WindowAttentionFn`` (kernels 8 and 9); otherwise kernel 8. CPU tensors
    take the plain twins; CUDA tensors take the kernels (no fallback: a
    failed build or launch raises)."""
    _check_kernel(q, k, v, bias, region_id)
    if torch.is_grad_enabled() and any(x.requires_grad for x in (q, k, v, bias)):
        return WindowAttentionFn.apply(q, k, v, bias, region_id)
    return window_attention_forward(q, k, v, bias, region_id)
