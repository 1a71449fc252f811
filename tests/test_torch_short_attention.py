"""Port short-sequence attention (the plain twins of kernels 6-7, the CPU
path of ``short_attention`` and ``ShortAttentionFn``) against the JAX
package's ``short_attention``, which runs its Pallas kernels in interpret
mode on the CPU; and the attention router against the JAX router
(``laryngeal_tpu/ops/attention.py:94-121``). Inputs are made with numpy
from a seed.

Tolerances: float32 at the JAX test's own atol 2e-5, rtol 1e-4
(``tests/test_short_attention.py:28``); gradients at atol 5e-5, rtol 1e-4
(the same f32 sums in another order); bfloat16 under the twins' elementwise
``error_limit`` / ``backward_error_limit`` (one-ulp bf16 rounding flips).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import laryngeal_tpu.ops.flash_attention as jax_flash_module
import laryngeal_tpu.ops.short_attention as jax_short_module
from laryngeal_tpu.ops import attention as jax_att
from laryngeal_tpu.parallel.sp import TrailingKeyMask
from laryngeal_tpu_torch.ops import attention as att
from laryngeal_tpu_torch.ops import flash_attention as fa
from laryngeal_tpu_torch.ops import short_attention as sa

ATOL, RTOL = 2e-5, 1e-4
# (B, N, H, D): odd B*H throughout; N < 128 is the JAX kernel's packed layout.
SHAPES = [(3, 5, 1, 16), (1, 8, 3, 32), (3, 32, 5, 64), (1, 100, 3, 32), (1, 197, 3, 64)]


def _inputs(shape, seed=0):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(shape, dtype=np.float32) for _ in range(4))


def _jax_grads(q, k, v, g, dtype=jnp.float32):
    qj, kj, vj = (jnp.asarray(x, dtype) for x in (q, k, v))
    gj = jnp.asarray(g, dtype).astype(jnp.float32)
    loss = lambda a, b, c: (jax_short_module.short_attention(a, b, c).astype(jnp.float32)
                            * gj).sum()
    return jax.grad(loss, argnums=(0, 1, 2))(qj, kj, vj)


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_forward_matches_jax_kernel(shape):
    q, k, v, _ = _inputs(shape)
    ref = np.asarray(jax_short_module.short_attention(*(jnp.asarray(x) for x in (q, k, v))))
    out = sa.short_attention(*(torch.from_numpy(x) for x in (q, k, v)))
    assert out.dtype == torch.float32 and out.shape == shape
    np.testing.assert_allclose(out.numpy(), ref, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_gradients_match_jax_kernel(shape):
    """jax.grad through the JAX custom_vjp (kernel 7 in interpret mode)
    against autograd through ShortAttentionFn (kernel 7's twin)."""
    q, k, v, g = _inputs(shape, seed=1)
    refs = _jax_grads(q, k, v, g)
    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    out = sa.short_attention(*leaves)
    assert out.grad_fn.name().endswith("ShortAttentionFnBackward")
    (out * torch.from_numpy(g)).sum().backward()
    for name, x, ref in zip("qkv", leaves, refs):
        np.testing.assert_allclose(x.grad.numpy(), np.asarray(ref), atol=5e-5, rtol=RTOL,
                                   err_msg=f"d{name}")


# The last three are the edges of kernel 7's wgmma design (64 < N <= 256).
@pytest.mark.parametrize("shape", [(3, 5, 1, 16), (3, 32, 5, 64), (1, 197, 3, 64),
                                   (1, 65, 3, 64), (1, 128, 3, 64), (1, 256, 3, 64)], ids=str)
def test_bf16_forward_and_gradients_match_jax_kernel(shape):
    q, k, v, g = _inputs(shape, seed=2)
    tq, tk, tv, tg = (torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v, g))
    ref = np.asarray(jax_short_module.short_attention(
        *(jnp.asarray(x, jnp.bfloat16) for x in (q, k, v))), np.float32)
    out = sa.short_attention(tq, tk, tv)
    assert out.dtype == torch.bfloat16
    limit = sa.error_limit(tq, tk, tv, out).numpy()
    assert (np.abs(out.float().numpy() - ref) / limit).max() <= 1.0
    grads = sa.short_attention_plain_bwd(tq, tk, tv, tg)
    limits = sa.backward_error_limit(tq, tk, tv, tg, grads)
    for name, got, want, lim in zip("qkv", grads, _jax_grads(q, k, v, g, jnp.bfloat16),
                                    limits):
        assert got.dtype == torch.bfloat16
        use = (np.abs(got.float().numpy() - np.asarray(want, np.float32)) / lim.numpy()).max()
        assert use <= 1.0, (name, use)


def test_function_carries_the_gradient_not_a_plain_call(monkeypatch):
    """The gradient comes from ShortAttentionFn.backward (kernel 7's twin):
    with that twin stubbed to zeros, the inputs get zero gradient through
    the dispatcher, though the plain attention would have given one."""
    q, k, v, g = _inputs((1, 32, 3, 16), seed=3)
    monkeypatch.setattr(sa, "short_attention_plain_bwd",
                        lambda q_, k_, v_, do: tuple(torch.zeros_like(x) for x in (q_, k_, v_)))
    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    (att.dot_product_attention(*leaves, impl="kernel") * torch.from_numpy(g)).sum().backward()
    assert all(torch.count_nonzero(x.grad) == 0 for x in leaves)
    plain = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    (att.dot_product_attention(*plain, impl="plain") * torch.from_numpy(g)).sum().backward()
    assert all(torch.count_nonzero(x.grad) > 0 for x in plain)


def test_no_grad_takes_the_forward_twin_and_counts_no_launch(monkeypatch):
    calls = []
    real = sa.short_attention_plain
    monkeypatch.setattr(sa, "short_attention_plain",
                        lambda *a: calls.append("fwd") or real(*a))
    sa.reset_launches()
    q, k, v, _ = (torch.from_numpy(x) for x in _inputs((2, 20, 3, 8), seed=4))
    with torch.no_grad():
        out = sa.short_attention(q, k, v.requires_grad_())
    assert out.grad_fn is None and calls == ["fwd"]
    assert sa.launch_counts() == {"short_attention_fwd": 0, "short_attention_bwd": 0}


def test_twin_matches_the_plain_attention_in_f32():
    """In f32 the short twin and the one plain attention compute the same
    function (P is not rounded): they agree to f32 rounding."""
    q, k, v, _ = (torch.from_numpy(x) for x in _inputs((2, 77, 3, 24), seed=5))
    np.testing.assert_allclose(sa.short_attention_plain(q, k, v).numpy(),
                               fa.attention_plain(q, k, v).numpy(), atol=1e-6)


@pytest.mark.parametrize("bad", ["cross", "long", "head_dim", "dtype"])
def test_checks_reject_bad_input(bad):
    q, k, v, _ = (torch.from_numpy(x) for x in _inputs((1, 8, 1, 16), seed=6))
    if bad == "cross":
        k = k[:, :4]
    if bad == "long":
        q, k, v, _ = (torch.from_numpy(x) for x in _inputs((1, 512, 1, 16), seed=6))
    if bad == "head_dim":
        q, k, v, _ = (torch.from_numpy(x) for x in _inputs((1, 8, 1, 136), seed=6))
    if bad == "dtype":
        v = v.double()
    with pytest.raises(ValueError):
        sa.short_attention(q, k, v)


def test_kernel_wrappers_refuse_cpu_tensors():
    q, k, v, g = (torch.from_numpy(x) for x in _inputs((1, 8, 1, 16), seed=7))
    with pytest.raises(ValueError, match="CUDA"):
        sa.short_attention_fwd_cuda(q, k, v)
    with pytest.raises(ValueError, match="CUDA"):
        sa.short_attention_bwd_cuda(q, k, v, g)


def test_bf16_limit_refuses_a_dropped_key_tile():
    """The bf16 limit admits the kernel's roundings but not a kernel that
    lost a 64-key tile of the softmax."""
    q, k, v, _ = (torch.from_numpy(x).to(torch.bfloat16) for x in _inputs((1, 197, 2, 64), 8))
    ref = sa.short_attention_plain(q, k, v)
    limit = sa.error_limit(q, k, v, ref)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) / 8.0
    s[..., 64:128] = -1e30
    p = torch.softmax(s, -1).to(torch.bfloat16).float()
    dropped = torch.einsum("bhqk,bkhd->bqhd", p, v.float()).to(torch.bfloat16)
    assert ((dropped.float() - ref.float()).abs() / limit).max() > 1.0


# ---------- the router ----------

# (Nq, Nk, D, kv_valid, bias?) -> the function each side's router reaches.
ROUTES = [
    ((5, 5, 16, None, False), "short"),
    ((197, 197, 64, None, False), "short"),
    ((511, 511, 32, None, False), "short"),
    ((512, 512, 32, None, False), "flash"),
    ((600, 600, 128, None, False), "flash"),
    ((100, 200, 32, None, False), "other"),    # Nq != Nk
    ((300, 300, 32, 250, False), "other"),     # a key mask
    ((32, 32, 136, None, False), "other"),     # head_dim > 128
    ((40, 40, 16, None, True), "other"),       # a logits bias
]


def _jax_route(nq, nk, d, kv_valid, bias, monkeypatch):
    seen = []
    monkeypatch.setattr(jax_short_module, "short_attention",
                        lambda q, k, v: seen.append("short") or q)
    monkeypatch.setattr(jax_flash_module, "flash_attention",
                        lambda q, *a, **kw: seen.append("flash") or q)
    monkeypatch.setattr(jax.nn, "dot_product_attention",
                        lambda q, *a, **kw: seen.append("other") or q)
    q = jnp.zeros((1, nq, 1, d))
    kv = jnp.zeros((1, nk, 1, d))
    b = (jnp.zeros((1, 1, nq, nk)) if bias
         else TrailingKeyMask(nk, kv_valid) if kv_valid else None)
    jax_att.dot_product_attention(q, kv, kv, b, impl="pallas")
    return seen


def _port_route(nq, nk, d, kv_valid, bias, monkeypatch):
    seen = []
    monkeypatch.setattr(att, "short_attention", lambda q, k, v: seen.append("short") or q)
    monkeypatch.setattr(att, "flash_attention", lambda q, *a: seen.append("flash") or q)
    monkeypatch.setattr(att, "attention_plain", lambda q, *a: seen.append("plain") or q)
    q = torch.zeros((1, nq, 1, d))
    kv = torch.zeros((1, nk, 1, d))
    b = torch.zeros((1, 1, nq, nk)) if bias else None
    att.dot_product_attention(q, kv, kv, bias=b, impl="kernel", kv_valid=kv_valid)
    return seen


@pytest.mark.parametrize("shape,jax_route", ROUTES, ids=lambda x: str(x))
def test_router_matches_jax(shape, jax_route, monkeypatch):
    """Both sides send the same calls to the short kernel and to the flash
    kernel. The rest (Nq != Nk, a key mask, D > 128 or a bias) take XLA's
    attention in JAX; the port keeps them on the flash kernel when it can
    take them (bias-free, D <= 128) and on the plain attention otherwise."""
    assert _jax_route(*shape, monkeypatch) == [jax_route]
    nq, nk, d, kv_valid, bias = shape
    want = jax_route if jax_route != "other" else (
        "plain" if bias or d > fa.MAX_HEAD_DIM else "flash")
    assert _port_route(*shape, monkeypatch) == [want]


@pytest.mark.parametrize("bias", [False, True])
def test_head_dim_above_128_takes_plain_attention_as_jax_takes_xla(bias):
    """D = 160 has no kernel in either package: the port's ``kernel`` impl
    routes it to ``attention_plain`` (any device), JAX's ``pallas`` impl to
    XLA; the two agree to f32 round-off."""
    q, k, v, _ = _inputs((2, 40, 3, 160), seed=11)
    b = np.random.default_rng(12).standard_normal((1, 3, 40, 40), dtype=np.float32)
    ref = jax_att.dot_product_attention(*(jnp.asarray(x) for x in (q, k, v)),
                                        jnp.asarray(b) if bias else None, impl="pallas")
    out = att.dot_product_attention(*(torch.from_numpy(x) for x in (q, k, v)),
                                    bias=torch.from_numpy(b) if bias else None, impl="kernel")
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL, rtol=RTOL)


def _strides(*tensors):
    return [s for x in tensors for s in x.stride()[:3]]


@pytest.mark.parametrize("shape,dtype,layout,want", [
    ((256, 197, 12, 64), torch.bfloat16, "contiguous", True),   # TimeSformer-B spatial
    ((1568, 32, 12, 64), torch.bfloat16, "contiguous", False),  # temporal: N <= 64
    ((2, 64, 3, 64), torch.bfloat16, "contiguous", False),
    ((2, 65, 3, 64), torch.bfloat16, "contiguous", True),
    ((1, 256, 3, 64), torch.bfloat16, "contiguous", True),
    ((1, 257, 3, 64), torch.bfloat16, "contiguous", False),
    ((2, 197, 3, 32), torch.bfloat16, "fused", True),
    ((2, 197, 3, 40), torch.bfloat16, "contiguous", True),       # padded to 40
    ((2, 197, 3, 66), torch.bfloat16, "contiguous", False),      # padded to 72
    ((2, 197, 3, 128), torch.bfloat16, "contiguous", False),
    ((2, 197, 3, 64), torch.bfloat16, "expand", False),          # batch stride 0
    ((2, 197, 3, 64), torch.float32, "contiguous", False),
])
def test_bwd_wgmma_gate_table(shape, dtype, layout, want):
    """``bwd_wgmma_takes``, the Python mirror of kernel 7's C gate: bf16,
    64 < N <= 256, D padded to a multiple of 8 <= 64, every stride positive
    (the card test holds it against the design the C entry reports)."""
    b, n, h, d = shape
    if layout == "fused":
        q, k, v = torch.empty((b, n, 3, h, d), dtype=dtype).unbind(2)
    elif layout == "expand":
        q = k = v = torch.empty((1, n, h, d), dtype=dtype).expand(shape)
    else:
        q = k = v = torch.empty(shape, dtype=dtype)
    outs = [torch.empty(shape, dtype=dtype) for _ in range(4)]
    assert sa.bwd_wgmma_takes(q.shape, _strides(q, k, v, *outs), dtype) is want
