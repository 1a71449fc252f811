"""The port's flash-attention training path (kernels 2-4's plain twins and
``FlashAttentionFn``) against the JAX package's Pallas kernels, run in
interpret mode, and ``jax.grad`` of its ``custom_vjp``. Inputs are numpy
arrays from a seed.

Tolerances: float32 within 1e-5 of the largest |reference| value of each
tensor (both sides compute in f32; only summation order differs). bfloat16
within ``fa.error_limit`` (o), ``fa.LSE_TOL`` (lse) and
``fa.backward_error_limit`` (gradients): the bf16 roundings of P and dS
happen at the same places on both sides, so the limits are the ones the
card's kernels are held to.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from laryngeal_tpu.ops.flash_attention import _flash_backward, _flash_forward
from laryngeal_tpu.ops.flash_attention import flash_attention as jax_flash_attention
from laryngeal_tpu_torch.ops import attention as att
from laryngeal_tpu_torch.ops import flash_attention as fa
from test_torch_flash_attention import _split_tf32, _tf32

# (B, Nq, Nk, H, D, kv_valid)
SHAPES = [(1, 130, 130, 2, 64, None), (1, 300, 300, 2, 16, 250), (1, 100, 300, 2, 32, None)]
IDS = ["n130_d64", "n300_d16_kv250", "nq100_nk300"]
DTYPES = {"f32": (torch.float32, jnp.float32), "bf16": (torch.bfloat16, jnp.bfloat16)}


def _inputs(shape, seed=0):
    b, nq, nk, h, d, _ = shape
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, nq, h, d), dtype=np.float32),
            rng.standard_normal((b, nk, h, d), dtype=np.float32),
            rng.standard_normal((b, nk, h, d), dtype=np.float32),
            rng.standard_normal((b, nq, h, d), dtype=np.float32))


def _rel(a, ref):
    a, ref = (np.asarray(x, np.float32) for x in (a, ref))
    return np.abs(a - ref).max() / max(np.abs(ref).max(), 1e-30)


def _t(x, dtype):
    return torch.from_numpy(np.asarray(x, np.float32)).to(dtype)


@pytest.fixture(scope="module", params=list(zip(SHAPES, IDS)), ids=IDS)
def case(request):
    """Per shape: numpy inputs, and the JAX forward (o, trimmed lse) and
    backward (dq, dk, dv) of the Pallas kernels in interpret mode, f32 and
    bf16."""
    shape, _ = request.param
    b, nq, nk, h, d, kv_valid = shape
    q, k, v, g = _inputs(shape)
    out = {}
    for name, (_, jdt) in DTYPES.items():
        jq, jk, jv, jg = (jnp.asarray(x, jdt) for x in (q, k, v, g))
        o, lse_pad = _flash_forward(jq, jk, jv, None, 128, 128, interpret=True,
                                    return_lse=True, kv_valid=kv_valid)
        dq, dk, dv = _flash_backward(jq, jk, jv, o, lse_pad, jg, interpret=True,
                                     kv_valid=kv_valid)
        lse = np.array(lse_pad)[:, :nq, 0].reshape(b, h, nq)
        out[name] = dict(o=np.array(o.astype(jnp.float32)), lse=lse,
                         grads=[np.array(x.astype(jnp.float32)) for x in (dq, dk, dv)])
    return shape, (q, k, v, g), out


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_plain_lse_matches_jax_forward(case, dt):
    shape, (q, k, v, _), ref = case
    kv_valid = shape[-1]
    tdt = DTYPES[dt][0]
    qt, kt, vt = (_t(x, tdt) for x in (q, k, v))
    o, lse = fa.attention_plain_lse(qt, kt, vt, kv_valid)
    assert o.dtype == tdt and lse.dtype == torch.float32
    assert lse.shape == (shape[0], shape[3], shape[1]) and lse.is_contiguous()
    if dt == "f32":
        assert _rel(o, ref[dt]["o"]) <= 1e-5
        assert _rel(lse, ref[dt]["lse"]) <= 1e-5
    else:
        limit = fa.error_limit(qt, kt, vt, kv_valid, o)
        assert ((o.float() - torch.from_numpy(ref[dt]["o"])).abs() / limit).max() <= 1.0
        assert np.abs(lse.numpy() - ref[dt]["lse"]).max() <= fa.LSE_TOL


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_plain_bwd_matches_jax_backward(case, dt):
    """Fed the JAX forward's own o and lse, the plain twin of kernels 3-4
    gives the Pallas kernels' dq, dk, dv."""
    shape, (q, k, v, g), ref = case
    kv_valid = shape[-1]
    tdt = DTYPES[dt][0]
    qt, kt, vt, gt = (_t(x, tdt) for x in (q, k, v, g))
    o = _t(ref[dt]["o"], tdt)
    lse = torch.from_numpy(ref[dt]["lse"])
    grads = fa.attention_plain_bwd(qt, kt, vt, o, lse, gt, kv_valid)
    if dt == "f32":
        for got, want in zip(grads, ref[dt]["grads"]):
            assert _rel(got, want) <= 1e-5
    else:
        limits = fa.backward_error_limit(qt, kt, vt, o, lse, gt, kv_valid, grads)
        for got, want, lim in zip(grads, ref[dt]["grads"], limits):
            assert got.dtype == tdt
            assert ((got.float() - torch.from_numpy(want)).abs() / lim).max() <= 1.0


def test_function_grads_match_jax_grad(case):
    """``FlashAttentionFn`` on the CPU (kernel 2-4 wiring, plain twins)
    against ``jax.grad`` through the JAX ``custom_vjp`` (f32)."""
    shape, (q, k, v, g), _ = case
    kv_valid = shape[-1]

    def loss(q_, k_, v_):
        o = jax_flash_attention(q_, k_, v_, None, 128, 128, kv_valid)
        return jnp.sum(o * jnp.asarray(g))

    want = jax.grad(loss, argnums=(0, 1, 2))(*(jnp.asarray(x) for x in (q, k, v)))
    qt, kt, vt = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = fa.flash_attention(qt, kt, vt, kv_valid)
    assert out.grad_fn is not None and "FlashAttentionFn" in out.grad_fn.name()
    (out * torch.from_numpy(g)).sum().backward()
    for got, w in zip((qt.grad, kt.grad, vt.grad), want):
        assert _rel(got, w) <= 1e-5


def test_masked_keys_get_exact_zero_grads():
    shape = (1, 300, 300, 2, 16, 250)
    q, k, v, g = _inputs(shape, seed=3)
    for dtype in (torch.float32, torch.bfloat16):
        qt, kt, vt, gt = (_t(x, dtype) for x in (q, k, v, g))
        o, lse = fa.attention_plain_lse(qt, kt, vt, 250)
        _, dk, dv = fa.attention_plain_bwd(qt, kt, vt, o, lse, gt, 250)
        assert torch.count_nonzero(dk[:, 250:]) == 0 and torch.count_nonzero(dv[:, 250:]) == 0
        assert torch.count_nonzero(dk[:, :250]) > 0


def test_grad_routing_follows_is_grad_enabled(monkeypatch):
    """Under autograd the lse forward (kernel 2's twin) runs and the output
    carries FlashAttentionFn; under no_grad, or with no input requiring
    grad, kernel 1's twin runs."""
    calls = []
    real_lse, real_plain = fa.attention_plain_lse, fa.attention_plain
    monkeypatch.setattr(fa, "attention_plain_lse",
                        lambda *a, **kw: calls.append("lse") or real_lse(*a, **kw))
    monkeypatch.setattr(fa, "attention_plain",
                        lambda *a, **kw: calls.append("plain") or real_plain(*a, **kw))
    q, k, v, _ = _inputs((1, 64, 64, 2, 32, None))
    qt, kt, vt = (torch.from_numpy(x) for x in (q, k, v))
    kt.requires_grad_()
    out = fa.flash_attention(qt, kt, vt)
    assert calls == ["lse"] and out.requires_grad
    with torch.no_grad():
        out = fa.flash_attention(qt, kt, vt)
    assert calls == ["lse", "plain"] and out.grad_fn is None
    fa.flash_attention(qt, kt.detach(), vt)
    assert calls == ["lse", "plain", "plain"]


def test_function_carries_the_gradient_not_a_plain_call(monkeypatch):
    """The gradient comes from FlashAttentionFn.backward (kernels 3-4's
    twin): with that backward stubbed to zeros, the attention inputs get
    zero gradient, though a plain call would have given one. (The call goes
    to ``flash_attention`` directly: through the dispatcher, N = 64
    self-attention takes the short-sequence route.)"""
    q, k, v, g = _inputs((1, 64, 64, 2, 32, None), seed=5)
    qt, kt, vt = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    monkeypatch.setattr(fa, "attention_plain_bwd",
                        lambda q_, k_, v_, *a: tuple(torch.zeros_like(x) for x in (q_, k_, v_)))
    (fa.flash_attention(qt, kt, vt) * torch.from_numpy(g)).sum().backward()
    assert all(torch.count_nonzero(x.grad) == 0 for x in (qt, kt, vt))
    q2, k2, v2 = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    (att.dot_product_attention(q2, k2, v2, impl="plain") * torch.from_numpy(g)).sum().backward()
    assert all(torch.count_nonzero(x.grad) > 0 for x in (q2, k2, v2))


def test_bias_under_autograd_uses_differentiable_plain():
    q, k, v, g = _inputs((1, 40, 40, 2, 16, None), seed=6)
    bias = torch.from_numpy(np.random.default_rng(7).standard_normal((1, 2, 40, 40),
                                                                   dtype=np.float32))
    qt = torch.from_numpy(q).requires_grad_()
    out = att.dot_product_attention(qt, torch.from_numpy(k), torch.from_numpy(v), bias=bias,
                                    impl="kernel")
    assert "FlashAttentionFn" not in out.grad_fn.name()
    (out * torch.from_numpy(g)).sum().backward()
    assert torch.count_nonzero(qt.grad) > 0


def _emulate_kernel_bwd_bf16(q, k, v, o, lse, do, drop=None):
    """The bf16 kernels' arithmetic in another order (f64 sums, exp2), the
    roundings where the kernels make them; ``drop`` skips a key range as a
    kernel that lost a tile would."""
    f = lambda x: x.double()
    scale = q.shape[-1] ** -0.5
    s = torch.einsum("bqhd,bkhd->bhqk", f(q), f(k)) * scale
    p = torch.exp2((s - f(lse)[..., None]) * 1.4426950408889634)
    if drop is not None:
        p[..., drop] = 0
    dp = torch.einsum("bqhd,bkhd->bhqk", f(do), f(v))
    ds = (p * (dp - f(fa.attention_delta(o, do))[..., None])).to(torch.bfloat16).double()
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, f(k)) * scale
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, f(q)) * scale
    dv = torch.einsum("bhqk,bqhd->bkhd", p.to(torch.bfloat16).double(), f(do))
    return tuple(x.to(torch.bfloat16) for x in (dq, dk, dv))


def test_backward_limit_takes_kernel_rounding_and_refuses_a_dropped_tile():
    q, k, v, g = (_t(x, torch.bfloat16) for x in _inputs((1, 256, 256, 2, 64, None), seed=8))
    o, lse = fa.attention_plain_lse(q, k, v)
    ref = fa.attention_plain_bwd(q, k, v, o, lse, g)
    limits = fa.backward_error_limit(q, k, v, o, lse, g, None, ref)
    use = lambda got: max(((a.float() - r.float()).abs() / lim).max().item()
                          for a, r, lim in zip(got, ref, limits))
    assert use(_emulate_kernel_bwd_bf16(q, k, v, o, lse, g)) <= 0.75
    assert use(_emulate_kernel_bwd_bf16(q, k, v, o, lse, g, drop=slice(64, 128))) > 1.0


def _emulate_kernel_bwd_f32(q, k, v, o, lse, do, kv_valid=None, split="tf32x3"):
    """Kernels 3-4's f32 design (``wgmma.tf32x3``) on the CPU: S = Q Kᵀ,
    dP = dO Vᵀ and the gradients' products on split operands, each as
    small·big + big·small + big·big of the kernels' two TF32 parts
    (``"tf32x3"``), or as one TF32 product of the operands rounded to
    nearest (``"tf32"``). P = exp2(S·scale·log2e − lse·log2e) with keys >=
    ``kv_valid`` at 0 and dS = P∘(dP − δ), both split as A operands; dQ
    summed over 32-key steps, dK and dV over 32-query steps, each step's
    product added in f32 (the kernels' flush of a step's accumulator)."""
    nq, nk, d = q.shape[1], k.shape[1], q.shape[-1]
    n_act = nk if kv_valid is None else min(kv_valid, nk)
    scale, log2e = d ** -0.5, 1.4426950408889634
    parts = _split_tf32 if split == "tf32x3" else (lambda x: (_tf32(x), torch.zeros_like(x)))

    def prod(eq, a, c):
        (ab, as_), (cb, cs) = parts(a), parts(c)
        return torch.einsum(eq, as_, cb) + torch.einsum(eq, ab, cs) + torch.einsum(eq, ab, cb)

    p = torch.exp2(prod("bqhd,bkhd->bhqk", q, k) * (scale * log2e) - lse[..., None] * log2e)
    p[..., n_act:] = 0.0
    ds = p * (prod("bqhd,bkhd->bhqk", do, v) - fa.attention_delta(o, do)[..., None])
    dq = sum(prod("bhqk,bkhd->bqhd", ds[..., c:c + 32], k[:, c:c + 32])
             for c in range(0, nk, 32))
    dk = sum(prod("bhqk,bqhd->bkhd", ds[:, :, c:c + 32], q[:, c:c + 32])
             for c in range(0, nq, 32))
    dv = sum(prod("bhqk,bqhd->bkhd", p[:, :, c:c + 32], do[:, c:c + 32])
             for c in range(0, nq, 32))
    return dq * scale, dk * scale, dv


# (B, Nq, Nk, H, D, kv_valid): kv_valid inside the last 32-key step and at
# its edge, Nq != Nk both ways, D = 64, 32 and 40.
F32_SPLIT_SHAPES = [(1, 130, 130, 2, 64, None), (1, 300, 200, 2, 64, 150),
                    (1, 100, 300, 2, 32, 250), (1, 97, 65, 2, 40, 64)]


@pytest.mark.parametrize("shape", F32_SPLIT_SHAPES, ids=str)
def test_f32_split_tf32_backward_emulation_holds_the_limits_where_one_term_does_not(shape):
    """Kernels 3-4's f32 design splits every operand, P and dS included,
    into two TF32 parts and sums three products a product (3xTF32).
    Emulated on the CPU, its dq, dk and dv stay within the f32 terms of
    ``backward_error_limit`` (F32_REL·A + 1e-6) of the JAX package's Pallas
    backward in interpret mode, masked keys' dK and dV exactly 0; one-term
    TF32 on the same inputs misses that limit, which is why the split
    exists."""
    b, nq, nk, h, d, kv_valid = shape
    q, k, v, g = _inputs(shape, seed=11)
    jq, jk, jv, jg = (jnp.asarray(x) for x in (q, k, v, g))
    o, lse_pad = _flash_forward(jq, jk, jv, None, 128, 128, interpret=True, return_lse=True,
                                kv_valid=kv_valid)
    refs = [torch.from_numpy(np.array(x)) for x in
            _flash_backward(jq, jk, jv, o, lse_pad, jg, interpret=True, kv_valid=kv_valid)]
    qt, kt, vt, gt = (torch.from_numpy(x) for x in (q, k, v, g))
    ot = torch.from_numpy(np.array(o))
    lse = torch.from_numpy(np.array(lse_pad)[:, :nq, 0].reshape(b, h, nq))
    limits = fa.backward_error_limit(qt, kt, vt, ot, lse, gt, kv_valid, refs)
    use = lambda got: max(((x - r).abs() / lim).max().item()
                          for x, r, lim in zip(got, refs, limits))
    split = _emulate_kernel_bwd_f32(qt, kt, vt, ot, lse, gt, kv_valid)
    assert use(split) <= 1.0
    if kv_valid is not None and kv_valid < nk:
        assert all(torch.count_nonzero(x[:, kv_valid:]) == 0 for x in split[1:])
    assert use(_emulate_kernel_bwd_f32(qt, kt, vt, ot, lse, gt, kv_valid, split="tf32")) > 1.0
