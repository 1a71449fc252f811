"""Port flash attention (plain version, the CPU path of the kernel wrapper)
and the attention dispatch against the JAX package's kernel (interpret
mode) and its einsum reference. Inputs are made with numpy from a seed."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from laryngeal_tpu.ops.attention import attention_reference as jax_attention_reference
from laryngeal_tpu.ops.flash_attention import flash_attention as jax_flash_attention
from laryngeal_tpu_torch.ops import attention as att
from laryngeal_tpu_torch.ops import flash_attention as fa

ATOL, RTOL = 2e-5, 1e-4


def _qkv(b=2, nq=300, nk=None, h=3, d=32, seed=0):
    rng = np.random.default_rng(seed)
    nk = nq if nk is None else nk
    return (rng.standard_normal((b, nq, h, d), dtype=np.float32),
            rng.standard_normal((b, nk, h, d), dtype=np.float32),
            rng.standard_normal((b, nk, h, d), dtype=np.float32))


def _torch(*xs):
    return tuple(torch.from_numpy(x) for x in xs)


@pytest.mark.parametrize("n", [64, 300, 513])
def test_plain_matches_jax_flash(n):
    q, k, v = _qkv(nq=n)
    ref = jax_flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), None, 128, 128)
    out = fa.flash_attention(*_torch(q, k, v))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("n", [64, 300, 513])
def test_plain_matches_jax_reference(n):
    q, k, v = _qkv(nq=n, d=64, seed=1)
    ref = jax_attention_reference(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    out = fa.attention_plain(*_torch(q, k, v))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("nq,nk", [(100, 333), (333, 100), (64, 513)])
def test_plain_matches_jax_flash_cross(nq, nk):
    q, k, v = _qkv(nq=nq, nk=nk, seed=2)
    ref = jax_flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), None, 128, 128)
    out = fa.flash_attention(*_torch(q, k, v))
    assert out.shape == q.shape
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("n,kv_valid", [(300, 250), (513, 500), (64, 1)])
def test_plain_matches_jax_flash_kv_valid(n, kv_valid):
    q, k, v = _qkv(nq=n, seed=3)
    ref = jax_flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), None,
                              128, 128, kv_valid)
    out = fa.flash_attention(*_torch(q, k, v), kv_valid=kv_valid)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL, rtol=RTOL)
    # The masked keys carry no weight: dropping them changes nothing.
    trimmed = fa.flash_attention(*_torch(q, k[:, :kv_valid], v[:, :kv_valid]))
    np.testing.assert_allclose(out.numpy(), trimmed.numpy(), atol=1e-6)


def test_plain_bf16_keeps_dtype():
    q, k, v = _qkv(nq=256, seed=4)
    qb, kb, vb = (x.to(torch.bfloat16) for x in _torch(q, k, v))
    out = fa.flash_attention(qb, kb, vb)
    assert out.dtype == torch.bfloat16
    ref = jax_flash_attention(*(jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)),
                              None, 128, 128)
    np.testing.assert_allclose(out.float().numpy(), np.asarray(ref, np.float32),
                               atol=3e-2, rtol=3e-2)


def test_cpu_call_does_not_count_a_launch():
    fa.launches = 0
    fa.flash_attention(*_torch(*_qkv(nq=64)))
    att.dot_product_attention(*_torch(*_qkv(nq=64)), impl="kernel")
    assert fa.launches == 0


def test_kernel_wrapper_refuses_cpu_tensors():
    with pytest.raises(ValueError, match="CUDA"):
        fa.flash_attention_cuda(*_torch(*_qkv(nq=8)))


@pytest.mark.parametrize("bad", ["head_dim", "shape", "kv_valid"])
def test_checks_reject_bad_input(bad):
    q, k, v = _torch(*_qkv(nq=8, d=16))
    if bad == "head_dim":
        q, k, v = _torch(*_qkv(nq=8, d=160))
    if bad == "shape":
        k = k[:, :, :2]
    with pytest.raises(ValueError):
        fa.flash_attention(q, k, v, kv_valid=0 if bad == "kv_valid" else None)


def test_dispatch_impls_agree_with_jax_reference():
    q, k, v = _qkv(nq=200, d=64, seed=5)
    ref = np.asarray(jax_attention_reference(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)))
    for impl in ("kernel", "plain", None):
        out = att.dot_product_attention(*_torch(q, k, v), impl=impl)
        np.testing.assert_allclose(out.numpy(), ref, atol=ATOL, rtol=RTOL)


def test_dispatch_bias_matches_jax_reference():
    q, k, v = _qkv(b=1, nq=40, h=2, d=16, seed=6)
    bias = np.random.default_rng(7).standard_normal((1, 2, 40, 40)).astype(np.float32)
    ref = jax_attention_reference(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                  jnp.asarray(bias))
    out = att.dot_product_attention(*_torch(q, k, v), bias=torch.from_numpy(bias))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("bias_shape", [(1, 2, 40, 40), (1, 1, 40, 40), (2, 1, 1, 40)])
@pytest.mark.parametrize("d", [16, 160])
def test_plain_bias_matches_jax_reference(bias_shape, d):
    """One plain function serves the kernel's CPU path and the 'plain' impl:
    with a broadcast bias, and at a head_dim the kernel does not take."""
    q, k, v = _qkv(b=2, nq=40, h=2, d=d, seed=9)
    bias = np.random.default_rng(10).standard_normal(bias_shape).astype(np.float32)
    ref = np.asarray(jax_attention_reference(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                             jnp.asarray(bias)))
    out = fa.attention_plain(*_torch(q, k, v), bias=torch.from_numpy(bias))
    np.testing.assert_allclose(out.numpy(), ref, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cpu_routes_reach_one_plain_function(dtype):
    """Every CPU route (kernel wrapper, 'kernel', 'plain', default) gives
    the same bits: f32 logits, cast back to the input dtype once."""
    q, k, v = (x.to(dtype) for x in _torch(*_qkv(nq=130, d=64, seed=11)))
    want = fa.attention_plain(q, k, v, kv_valid=100)
    assert want.dtype == dtype
    outs = [fa.flash_attention(q, k, v, kv_valid=100)]
    outs += [att.dot_product_attention(q, k, v, impl=impl, kv_valid=100)
             for impl in ("kernel", "plain", None)]
    for out in outs:
        assert torch.equal(out, want)


def test_dispatch_kv_valid_plain_matches_kernel_path():
    q, k, v = _torch(*_qkv(nq=120, seed=8))
    a = att.dot_product_attention(q, k, v, impl="plain", kv_valid=100)
    b = att.dot_product_attention(q, k, v, impl="kernel", kv_valid=100)
    np.testing.assert_allclose(a.numpy(), b.numpy(), atol=ATOL, rtol=RTOL)


def test_impl_switch(monkeypatch):
    monkeypatch.setattr(att, "_IMPL", None)
    assert att.get_attention_impl(torch.device("cpu")) == "plain"
    assert att.get_attention_impl(torch.device("cuda")) == "kernel"
    att.set_attention_impl("plain")
    assert att.get_attention_impl(torch.device("cuda")) == "plain"
    att.set_attention_impl(None)
    with pytest.raises(ValueError):
        att.set_attention_impl("xla")


def _emulate_kernel_bf16(q, k, v, drop=None):
    """The bf16 kernel's arithmetic on the CPU: f32 logits and row sums, P
    rounded to bf16 for P.V, the output rounded to bf16. ``drop`` masks keys
    out, as a kernel that skipped them would."""
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) / q.shape[-1] ** 0.5
    if drop is not None:
        s[..., drop] = -1e30
    p = torch.exp(s - s.amax(-1, keepdim=True))
    o = torch.einsum("bhqk,bkhd->bqhd", p.to(torch.bfloat16).float(), v.float())
    return (o / p.sum(-1).transpose(1, 2)[..., None]).to(torch.bfloat16)


def _tf32(x):
    """x rounded to TF32 (10 mantissa bits) to nearest, ties away from zero,
    by integer ops on the f32 bits: ``cvt.rna.tf32.f32``."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _split_tf32(x):
    """The kernel's split (``tf32_split``): big = x with its low 13 bits
    masked, small = tf32(x - big); x - big is exact in f32."""
    big = (x.float().contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)
    return big, _tf32(x.float() - big)


def _split_bf16(x):
    """hi = bf16(x), lo = bf16(x - hi), both rounded to nearest even: bf16x3."""
    hi = x.float().to(torch.bfloat16).float()
    return hi, (x.float() - hi).to(torch.bfloat16).float()


def _emulate_kernel_f32(q, k, v, kv_valid=None, split="tf32x3", bias=None):
    """The f32 wgmma design's arithmetic on the CPU: per 64-key tile, S = Q K^T
    and O += P V on split operands, each product as the three terms
    small.big + big.small + big.big: two TF32 parts (``"tf32x3"``, the
    kernel's split) or two bf16 parts (``"bf16x3"``, a split no kernel
    runs); or one TF32 product of the operands rounded to nearest
    (``"tf32"``). The online softmax in f32, base 2, keys >= ``kv_valid``
    dropped, the row sum floored at 1e-30. With a ``bias`` (kernel 5,
    broadcastable to (B, H, Nq, Nk)) each tile's S starts from the f32 bias
    divided by the scale, unsplit, as the kernel loads it into the S
    accumulators, and the products add to it."""
    b, nq, h, d = q.shape
    n_act = k.shape[1] if kv_valid is None else min(kv_valid, k.shape[1])
    sl2 = 1.4426950408889634 / d ** 0.5
    if bias is not None:  # bias / scale in f32, the kernel's x * (1 / scale)
        inv_scale = 1.0 / torch.tensor(1.0 / d ** 0.5, dtype=torch.float32)
        bias = torch.broadcast_to(bias.float()[(None,) * (4 - bias.ndim)],
                                  (b, h, nq, k.shape[1])) * inv_scale
    parts = {"tf32x3": _split_tf32, "bf16x3": _split_bf16,
             "tf32": lambda x: (_tf32(x), x)}[split]  # "tf32": small unused
    (qb, qs), (kb, ks), (vb, vs) = (parts(x) for x in (q, k, v))

    def prod(eq, a, c, a_small, c_small):
        out = torch.einsum(eq, a, c)
        if split != "tf32":
            out = torch.einsum(eq, a_small, c) + torch.einsum(eq, a, c_small) + out
        return out

    m = torch.full((b, h, nq, 1), -1e30)
    l = torch.zeros((b, h, nq, 1))
    o = torch.zeros((b, h, nq, d))
    for k0 in range(0, n_act, 64):
        t = slice(k0, min(k0 + 64, n_act))
        s = prod("bqhd,bkhd->bhqk", qb, kb[:, t], qs, ks[:, t])
        if bias is not None:
            s = bias[..., t] + s
        m_new = torch.maximum(m, s.amax(-1, keepdim=True) * sl2)
        alpha = torch.exp2(m - m_new)
        p = torch.exp2(s * sl2 - m_new)
        l, m = l * alpha + p.sum(-1, keepdim=True), m_new
        pb, ps = parts(p)
        o = o * alpha + prod("bhqk,bkhd->bhqd", pb, vb[:, t], ps, vs[:, t])
    return (o / l.clamp_min(1e-30)).transpose(1, 2)


@pytest.mark.parametrize("b,n,h,kv_valid", [(2, 300, 2, 250), (1, 700, 2, 650),
                                            (2, 200, 3, 150)])
def test_f32_split_tf32_emulation_holds_1e4_where_one_term_does_not(b, n, h, kv_valid):
    """Kernels 1-2's f32 wgmma design splits each operand into two TF32
    parts and sums three products per product (3xTF32). Emulated on the CPU
    at D = 64 with kv_valid, it stays within the kernels' 1e-4 f32 limit of
    the JAX package's f32 flash attention (interpret mode); one-term TF32 on
    the same inputs does not, which is why the split exists."""
    q, k, v = _qkv(b=b, nq=n, h=h, d=64, seed=21)
    ref = np.asarray(jax_flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), None,
                                         128, 128, kv_valid))
    split = _emulate_kernel_f32(*_torch(q, k, v), kv_valid).numpy()
    one_term = _emulate_kernel_f32(*_torch(q, k, v), kv_valid, split="tf32").numpy()
    assert np.abs(split - ref).max() <= 1e-4
    assert np.abs(one_term - ref).max() > 1e-4


@pytest.mark.parametrize("b,n,h,kv_valid", [(2, 300, 2, 250), (1, 700, 2, 650),
                                            (2, 200, 3, 150)])
def test_f32_split_bf16x3_emulation_holds_1e4_above_tf32x3(b, n, h, kv_valid):
    """The other split: hi and lo bf16 parts, three products a product at
    the bf16 rate (twice TF32's). Emulated as the kernel's split, on the same
    inputs, it too stays within the 1e-4 f32 limit of the JAX package's f32
    flash attention, but further from it than 3xTF32: its parts keep 16
    mantissa bits to TF32x3's 22."""
    q, k, v = _qkv(b=b, nq=n, h=h, d=64, seed=21)
    ref = np.asarray(jax_flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), None,
                                         128, 128, kv_valid))
    bf16x3 = np.abs(_emulate_kernel_f32(*_torch(q, k, v), kv_valid, split="bf16x3").numpy()
                    - ref).max()
    tf32x3 = np.abs(_emulate_kernel_f32(*_torch(q, k, v), kv_valid).numpy() - ref).max()
    assert bf16x3 <= 1e-4
    assert bf16x3 > tf32x3


def _emulation_bias(kind, b, h, nq, nk, seed):
    """A kernel-5 bias: per-head (1, H, Nq, Nk), key-padding (B, 1, 1, Nk)
    with its last keys at -1e9 (keys >= 192: the tiles of 64 keys from 192
    on wholly padded), or full-shape (B, H, Nq, Nk)."""
    rng = np.random.default_rng(seed)
    if kind == "keys":
        bias = np.zeros((b, 1, 1, nk), np.float32)
        bias[..., 192:] = -1e9
        return bias
    shape = (1, h, nq, nk) if kind == "head" else (b, h, nq, nk)
    return 2.0 * rng.standard_normal(shape, dtype=np.float32)


@pytest.mark.parametrize("kv_valid", [None, 250], ids=str)
@pytest.mark.parametrize("kind", ["head", "keys", "full"])
def test_f32_split_tf32_emulation_with_a_bias_holds_1e4(kind, kv_valid):
    """Kernel 5's f32 design (kernels 1-2's wgmma.tf32x3 with the bias as the
    S accumulators' initial value) emulated on the CPU at D = 64 stays within
    the 1e-4 f32 limit of the JAX package's ``_attention_kernel_bias``
    (interpret mode) with a per-head, a key-padding (two wholly padded key
    tiles) and a full-shape bias, with and without kv_valid; one-term TF32
    on the same inputs does not."""
    b, n, h = 2, 300, 2
    q, k, v = _qkv(b=b, nq=n, h=h, d=64, seed=22)
    bias = _emulation_bias(kind, b, h, n, n, seed=23)
    ref = np.asarray(jax_flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                         jnp.asarray(bias), 128, 128, kv_valid))
    tb = torch.from_numpy(bias)
    split = _emulate_kernel_f32(*_torch(q, k, v), kv_valid, bias=tb).numpy()
    one_term = _emulate_kernel_f32(*_torch(q, k, v), kv_valid, split="tf32", bias=tb).numpy()
    assert np.isfinite(split).all()
    assert np.abs(split - ref).max() <= 1e-4
    assert np.abs(one_term - ref).max() > 1e-4


# (dtype, D, the 12 q, k, v, o strides or None) -> the design kernels 1, 2 and 5
# run: wgmma (bf16) and wgmma.tf32x3 (f32 at D <= 64) with every q, k, v stride
# positive; mma.sync (bf16) and FMA (f32) otherwise.
FORWARD_DESIGN_CASES = [
    ((torch.bfloat16, 64, None), "wgmma"),
    ((torch.bfloat16, 128, None), "wgmma"),
    ((torch.bfloat16, 20, None), "wgmma"),             # padded to 24
    ((torch.float32, 64, None), "wgmma.tf32x3"),
    ((torch.float32, 32, None), "wgmma.tf32x3"),
    ((torch.float32, 40, None), "wgmma.tf32x3"),       # padded to 40
    ((torch.float32, 72, None), "fma"),
    ((torch.float32, 128, None), "fma"),
    ((torch.bfloat16, 64, (0, 8, 64, 1, 8, 64, 1, 8, 64, 1, 8, 64)), "mma.sync"),
    ((torch.float32, 64, (1, 8, 64, 0, 8, 64, 1, 8, 64, 1, 8, 64)), "fma"),
    ((torch.float32, 64, (1, 8, 64, 1, 8, 64, 1, 8, 0, 1, 8, 64)), "fma"),
    ((torch.bfloat16, 64, (1, 8, 64, 1, 8, 64, 1, 8, 64, 0, 8, 64)), "wgmma"),  # o is written
]


@pytest.mark.parametrize("case,want", FORWARD_DESIGN_CASES, ids=str)
def test_forward_design_mirrors_the_c_choice(case, want):
    """``forward_design``, the Python mirror of the C choice of kernels 1, 2
    and 5 (held against it on the card), by dtype, D and strides; the bias's
    strides do not enter."""
    assert fa.forward_design(*case) == want


def test_forward_design_refuses_what_no_kernel_takes():
    with pytest.raises(ValueError):
        fa.forward_design(torch.float16, 64)
    with pytest.raises(ValueError):
        fa.forward_design(torch.float32, 136)


@pytest.mark.parametrize("n,h,d", [(1200, 2, 64), (300, 3, 32), (64, 3, 32), (5, 1, 8)])
def test_error_limit_takes_kernel_rounding_and_refuses_a_dropped_tile(n, h, d):
    q, k, v = (x.to(torch.bfloat16) for x in _torch(*_qkv(b=1, nq=n, h=h, d=d, seed=12)))
    ref = fa.attention_plain(q, k, v)
    limit = fa.error_limit(q, k, v, None, ref)
    assert ((_emulate_kernel_bf16(q, k, v).float() - ref.float()).abs() / limit).max() <= 0.75
    if n >= 128:
        dropped = _emulate_kernel_bf16(q, k, v, drop=slice(64, 128))
        assert ((dropped.float() - ref.float()).abs() / limit).max() > 1.0
    f32 = fa.error_limit(*(x.float() for x in (q, k, v)), None, ref.float())
    assert torch.equal(f32, torch.full_like(f32, 1e-4))
