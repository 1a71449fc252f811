"""Port biased attention (kernel 5's route: ``flash_attention(bias=...)``,
its plain twin ``attention_plain_bias``, ``FlashAttentionBiasFn`` and the
router) against the JAX package's biased flash attention in interpret mode,
``dot_product_attention(impl="pallas")`` and its ``TransformerBlock``. The
same numpy inputs, made from a seed, go through both; on the CPU the port
runs kernel 5's plain twin."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import laryngeal_tpu.ops.attention as jax_attention
from laryngeal_tpu.models.layers import TransformerBlock as JaxTransformerBlock
from laryngeal_tpu.ops.flash_attention import flash_attention as jax_flash_attention
from laryngeal_tpu_torch.compat.flax_weights import _dense, _layernorm
from laryngeal_tpu_torch.models.layers import TransformerBlock
from laryngeal_tpu_torch.ops import attention as att
from laryngeal_tpu_torch.ops import flash_attention as fa

ATOL, RTOL = 2e-5, 1e-4  # tests/test_flash_attention.py:58-76
B, H, N, D = 1, 2, 520, 16  # N >= 512: the JAX router's flash route
# The four broadcast forms of a bias: (B, H, N, N), (1, H, N, N), (H, N, N), (1, 1, 1, N).
BIAS_SHAPES = [(B, H, N, N), (1, H, N, N), (H, N, N), (1, 1, 1, N)]


def _qkv(nq=N, nk=N, seed=0):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal((B, n, H, D), dtype=np.float32) for n in (nq, nk, nk))


def _bias(shape, seed=1, scale=1.0):
    return scale * np.random.default_rng(seed).standard_normal(shape, dtype=np.float32)


def _torch(*xs):
    return tuple(torch.from_numpy(x) for x in xs)


def _jax_flash(q, k, v, bias, kv_valid=None):
    return jax_flash_attention(*(jnp.asarray(x) for x in (q, k, v, bias)), 128, 128, kv_valid)


@pytest.mark.parametrize("bias_shape", BIAS_SHAPES, ids=str)
@pytest.mark.parametrize("kv_valid", [None, 480])
def test_flash_bias_matches_jax(bias_shape, kv_valid):
    q, k, v = _qkv()
    bias = _bias(bias_shape)
    want = np.asarray(_jax_flash(q, k, v, bias, kv_valid))
    got = fa.flash_attention(*_torch(q, k, v), kv_valid, torch.from_numpy(bias))
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("nq,nk,kv_valid", [(100, 520, None), (520, 200, 150)])
def test_flash_bias_cross_matches_jax(nq, nk, kv_valid):
    q, k, v = _qkv(nq, nk, seed=2)
    bias = _bias((1, H, nq, nk), seed=3)
    want = np.asarray(_jax_flash(q, k, v, bias, kv_valid))
    got = fa.flash_attention(*_torch(q, k, v), kv_valid, torch.from_numpy(bias))
    assert got.shape == (B, nq, H, D)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("bias_shape", [(1, H, N, N), (1, 1, 1, N)], ids=str)
def test_flash_bias_bf16_rounds_the_bias(bias_shape):
    """bf16: the JAX kernel adds the bias rounded to bf16 and rounds P before
    P·V. The port's twin rounds the bias where it does and stays within
    ``error_limit`` (P's rounding, the output's); with the bias left in f32
    the same comparison breaks the limit."""
    q, k, v = (x.astype(jnp.bfloat16) for x in map(jnp.asarray, _qkv(seed=4)))
    bias = _bias(bias_shape, seed=5, scale=16.0)
    want = torch.from_numpy(np.array(jax_flash_attention(
        q, k, v, jnp.asarray(bias), 128, 128).astype(jnp.float32)))
    tq, tk, tv = (torch.from_numpy(np.array(x.astype(jnp.float32))).to(torch.bfloat16)
                  for x in (q, k, v))
    tb = torch.from_numpy(bias)
    got = fa.flash_attention(tq, tk, tv, None, tb)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, fa.attention_plain_bias(tq, tk, tv, tb))
    limit = fa.error_limit(tq, tk, tv, None, got, bias=tb.to(torch.bfloat16))
    assert ((got.float() - want).abs() / limit).max().item() <= 1.0
    unrounded = fa.attention_plain(tq, tk, tv, None, tb)
    assert ((unrounded.float() - want).abs() / limit).max().item() > 1.0


@pytest.mark.parametrize("bias_shape,kv_valid", [((B, H, N, N), None), ((H, N, N), 480),
                                                 ((1, 1, N, N), 480), ((1, 1, 1, N), None)],
                         ids=str)
def test_gradients_match_jax(bias_shape, kv_valid):
    """dq, dk, dv and dbias through FlashAttentionBiasFn (the f32 recompute
    backward) against ``jax.grad`` through the JAX biased ``custom_vjp``;
    dbias comes back in the primal bias's shape under kv_valid
    (``tests/test_flash_attention.py:171-185``)."""
    q, k, v = _qkv(seed=6)
    bias = _bias(bias_shape, seed=7)
    w = np.random.default_rng(8).standard_normal((B, N, H, D), dtype=np.float32)

    def loss(q, k, v, b):
        return (jax_flash_attention(q, k, v, b, 128, 128, kv_valid) * jnp.asarray(w)).sum()

    want = jax.grad(loss, argnums=(0, 1, 2, 3))(*(jnp.asarray(x) for x in (q, k, v, bias)))
    leaves = [x.clone().requires_grad_() for x in _torch(q, k, v, bias)]
    (fa.flash_attention(*leaves[:3], kv_valid, leaves[3]) * torch.from_numpy(w)).sum().backward()
    for name, leaf, ref in zip(("dq", "dk", "dv", "dbias"), leaves, want):
        assert leaf.grad.shape == ref.shape, name
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(ref), atol=1e-5, rtol=1e-4,
                                   err_msg=name)


def test_gradient_flows_to_the_bias_alone():
    """A bias that needs a gradient takes FlashAttentionBiasFn even when q, k
    and v do not; the forward is the twin's."""
    q, k, v = _torch(*_qkv(seed=9))
    bias = torch.from_numpy(_bias((1, H, N, N), seed=10)).requires_grad_()
    out = fa.flash_attention(q, k, v, None, bias)
    assert out.grad_fn is not None
    out.sum().backward()
    ref = bias.detach().clone().requires_grad_()
    fa.attention_plain(q, k, v, None, ref).sum().backward()
    assert torch.equal(out.detach(), fa.attention_plain_bias(q, k, v, bias.detach()))
    torch.testing.assert_close(bias.grad, ref.grad)


@pytest.mark.parametrize("n,kv_valid", [(N, None), (N, 480), (300, None), (300, 250)])
def test_router_matches_jax_pallas_impl(n, kv_valid):
    """N >= 512: both routers take the biased flash kernel (the port's twin on
    the CPU); N < 512: both take the plain attention with the f32 bias
    (JAX's XLA route). The JAX side gets the trailing-key mask as its
    additive form (-1e9); the port masks those keys to -1e30; both give them
    no weight."""
    from laryngeal_tpu.parallel.sp import TrailingKeyMask

    q, k, v = _qkv(n, n, seed=11)
    bias = _bias((1, H, n, n), seed=12)
    jbias = jnp.asarray(bias)
    if kv_valid is not None:
        jbias = jbias + TrailingKeyMask(n, kv_valid).materialize()
    want = np.asarray(jax_attention.dot_product_attention(
        *(jnp.asarray(x) for x in (q, k, v)), bias=jbias, impl="pallas"))
    launches = fa.bias_launches
    for impl in ("kernel", "plain"):
        got = att.dot_product_attention(*_torch(q, k, v), bias=torch.from_numpy(bias),
                                        impl=impl, kv_valid=kv_valid)
        np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=RTOL, err_msg=impl)
    assert fa.bias_launches == launches  # CPU calls are the twin, not launches


def _block_state_dict(params):
    sd = {}
    att_p = params["attention"]
    for name in ("query", "key", "value"):
        _dense(att_p[name], f"attention.attention.{name}", sd)
    _dense(att_p["out"], "attention.output.dense", sd)
    _dense(params["mlp"]["fc1"], "intermediate.dense", sd)
    _dense(params["mlp"]["fc2"], "output.dense", sd)
    _layernorm(params["layernorm_before"], "layernorm_before", sd)
    _layernorm(params["layernorm_after"], "layernorm_after", sd)
    return sd


def test_transformer_block_with_a_bias_matches_jax(monkeypatch):
    """``TransformerBlock(x, bias)`` at N = 520: the port (kernel 5's route,
    its twin on the CPU) against the JAX block on the ``pallas`` impl (the
    biased flash kernel in interpret mode), weights carried across."""
    hidden, heads, inter = 32, 2, 64
    rng = np.random.default_rng(13)
    x = rng.standard_normal((B, N, hidden), dtype=np.float32)
    bias = _bias((1, heads, N, N), seed=14)
    jblock = JaxTransformerBlock(hidden, heads, inter)
    params = jblock.init(jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(bias))["params"]
    params = jax.tree_util.tree_map(
        lambda p: np.asarray(p) + 0.02 * rng.standard_normal(p.shape).astype(np.float32),
        params)
    monkeypatch.setattr(jax_attention, "_IMPL", "pallas")
    want = np.asarray(jblock.apply({"params": params}, jnp.asarray(x), jnp.asarray(bias)))
    block = TransformerBlock(hidden, heads, inter)
    block.load_state_dict(_block_state_dict(params))
    att.set_attention_impl("kernel")
    try:
        with torch.no_grad():
            got = block(torch.from_numpy(x), torch.from_numpy(bias))
    finally:
        att.set_attention_impl(None)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=1e-4)
