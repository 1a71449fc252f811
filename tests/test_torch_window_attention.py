"""Port shifted-window attention (the plain twins of kernels 8-9 and 11-12,
the CPU path of ``ops.attention.window_attention`` and
``WindowAttentionFn``) against the JAX package's ``window_attention_pallas``
in interpret mode and its XLA route (``window_attention(impl="xla")``), and
the kernel-11/12 twins against the ablation script's kernel bodies run in a
``pl.pallas_call(..., interpret=True)`` built here. Inputs are made with
numpy from a seed.

Tolerances: float32 at the JAX test's own (``tests/test_window_attention.py``):
forward atol 2e-5 / rtol 1e-4, gradients including dbias atol 2e-4 /
rtol 1e-3; bfloat16 under the twins' elementwise ``error_limit`` /
``backward_error_limit`` (one-ulp bf16 rounding flips); the bf16-softmax
variant under its own limit (both sides round S - max to bf16).
"""

import functools
import importlib.util
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

import laryngeal_tpu.ops.window_attention as WA
from laryngeal_tpu.ops import attention as jax_att
from laryngeal_tpu_torch.ops import attention as att
from laryngeal_tpu_torch.ops import window_attention as wa

ATOL, RTOL = 2e-5, 1e-4
GRAD_ATOL, GRAD_RTOL = 2e-4, 1e-3
# (B·nW, N, H, D, nW); N % 8 == 0 reaches the JAX Pallas kernel.
SHAPES = [(4, 32, 2, 16, 2), (6, 56, 3, 32, 3), (2, 98, 2, 32, 1), (8, 8, 4, 8, 4)]
_BENCH = pathlib.Path(__file__).resolve().parent.parent / "scripts" / "bench_window_kernel.py"


def _bench():
    spec = importlib.util.spec_from_file_location("bench_window_kernel", _BENCH)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _inputs(shape, masked=True, seed=0):
    bw, n, h, d, nw = shape
    rng = np.random.default_rng(seed)
    q, k, v, g = (rng.standard_normal((bw, n, h, d), dtype=np.float32) for _ in range(4))
    bias = (0.5 * rng.standard_normal((h, n, n))).astype(np.float32)
    rid = rng.integers(0, 3, (nw, n)).astype(np.int32) if masked else None
    return q, k, v, bias, rid, g


def _torch(x, dtype=torch.float32):
    return None if x is None else torch.from_numpy(x).to(dtype)


def _rid_t(rid):
    return None if rid is None else torch.from_numpy(rid)


def _jax(x, dtype=jnp.float32):
    return None if x is None else jnp.asarray(x, dtype)


@pytest.mark.parametrize("masked", [True, False], ids=["masked", "unmasked"])
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_forward_matches_jax_kernel_and_xla(shape, masked):
    q, k, v, bias, rid, _ = _inputs(shape, masked)
    rid_j = None if rid is None else jnp.asarray(rid)
    ref = np.asarray(WA.window_attention_pallas(*(_jax(x) for x in (q, k, v, bias)), rid_j))
    xla = np.asarray(jax_att.window_attention(*(_jax(x) for x in (q, k, v, bias)), rid_j,
                                              impl="xla"))
    out = att.window_attention(*(_torch(x) for x in (q, k, v, bias)), _rid_t(rid),
                               impl="kernel")
    assert out.dtype == torch.float32 and out.shape == q.shape
    np.testing.assert_allclose(out.numpy(), ref, atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(out.numpy(), xla, atol=ATOL, rtol=RTOL)


def _jax_grads(q, k, v, bias, rid, g, fn, dtype=jnp.float32):
    qj, kj, vj = (_jax(x, dtype) for x in (q, k, v))
    gj = jnp.asarray(g, dtype).astype(jnp.float32)
    rid_j = None if rid is None else jnp.asarray(rid)
    loss = lambda a, b, c, d: (fn(a, b, c, d, rid_j).astype(jnp.float32) * gj).sum()
    return jax.grad(loss, argnums=(0, 1, 2, 3))(qj, kj, vj, jnp.asarray(bias))


@pytest.mark.parametrize("masked", [True, False], ids=["masked", "unmasked"])
@pytest.mark.parametrize("shape", SHAPES[:3], ids=str)
def test_gradients_including_dbias_match_jax(shape, masked):
    """jax.grad through the JAX custom_vjp (kernel 9 in interpret mode) and
    through the XLA route, against autograd through WindowAttentionFn
    (kernel 9's twin)."""
    q, k, v, bias, rid, g = _inputs(shape, masked, seed=1)
    leaves = [_torch(x).requires_grad_() for x in (q, k, v, bias)]
    out = att.window_attention(*leaves, _rid_t(rid), impl="kernel")
    assert out.grad_fn.name().endswith("WindowAttentionFnBackward")
    (out * torch.from_numpy(g)).sum().backward()
    xla = functools.partial(jax_att.window_attention, impl="xla")
    for fn in (WA.window_attention_pallas, xla):
        refs = _jax_grads(q, k, v, bias, rid, g, fn)
        for name, x, ref in zip(("dq", "dk", "dv", "dbias"), leaves, refs):
            np.testing.assert_allclose(x.grad.numpy(), np.asarray(ref), atol=GRAD_ATOL,
                                       rtol=GRAD_RTOL, err_msg=name)


@pytest.mark.parametrize("shape", [(4, 32, 2, 16, 2), (2, 56, 3, 32, 1)], ids=str)
def test_bf16_forward_and_gradients_match_jax_kernel(shape):
    q, k, v, bias, rid, g = _inputs(shape, seed=2)
    tq, tk, tv, tg = (_torch(x, torch.bfloat16) for x in (q, k, v, g))
    tb, tr = _torch(bias), _rid_t(rid)
    ref = np.asarray(WA.window_attention_pallas(
        *(_jax(x, jnp.bfloat16) for x in (q, k, v)), jnp.asarray(bias), jnp.asarray(rid)),
        np.float32)
    out = wa.window_attention_forward(tq, tk, tv, tb, tr)
    assert out.dtype == torch.bfloat16
    limit = wa.error_limit(tq, tk, tv, tb, tr, out).numpy()
    assert (np.abs(out.float().numpy() - ref) / limit).max() <= 1.0
    grads = wa.window_attention_plain_bwd(tq, tk, tv, tb, tr, tg)
    limits = wa.backward_error_limit(tq, tk, tv, tb, tr, tg, grads)
    refs = _jax_grads(q, k, v, bias, rid, g, WA.window_attention_pallas, jnp.bfloat16)
    for name, got, want, lim in zip(("dq", "dk", "dv", "dbias"), grads, refs, limits):
        assert got.dtype == (torch.float32 if name == "dbias" else torch.bfloat16)
        use = (np.abs(got.float().numpy() - np.asarray(want, np.float32)) / lim.numpy()).max()
        assert use <= 1.0, (name, use)


def test_bias_is_not_rounded_at_unaligned_n():
    """N % 8 != 0 (a clamped or padded window): the JAX package leaves its
    Pallas kernel for XLA, which rounds the bias to the compute dtype; the
    port's path keeps it f32. In f32 both agree; in bf16 the port matches
    the f32-bias function, the twin that the kernel computes at every N."""
    q, k, v, bias, rid, _ = _inputs((3, 27, 2, 16, 3), seed=3)
    assert not WA.supports_shape(27, 16)
    xla = np.asarray(jax_att.window_attention(*(_jax(x) for x in (q, k, v, bias)),
                                              jnp.asarray(rid), impl="pallas"))
    out = att.window_attention(*(_torch(x) for x in (q, k, v, bias)), _rid_t(rid), impl="kernel")
    np.testing.assert_allclose(out.numpy(), xla, atol=ATOL, rtol=RTOL)
    tq, tk, tv = (_torch(x, torch.bfloat16) for x in (q, k, v))
    out16 = att.window_attention(tq, tk, tv, _torch(bias), _rid_t(rid), impl="kernel")
    ref = wa.window_attention_plain(tq, tk, tv, _torch(bias), _rid_t(rid))
    assert torch.equal(out16, ref)


# (B·nW, N, H, D, nW) outside the held designs' domain (N <= 448, D <= 128):
# the JAX router takes its Pallas kernel at N % 8 == 0 and D <= 256 (456, 64
# at D = 160, 512 and 392 at D = 256), and so do kernels 8-9 (their wide
# path); XLA elsewhere (453), where the kernels take nothing.
OUTSIDE_SHAPES = [(2, 456, 1, 32, 2), (2, 453, 1, 32, 1), (4, 64, 2, 160, 2),
                  (1, 512, 1, 16, 1), (2, 40, 1, 256, 2)]


@pytest.mark.parametrize("shape", OUTSIDE_SHAPES, ids=str)
def test_kernel_impl_outside_the_kernels_domain_matches_jax(shape):
    """A window outside the held designs' domain: the kernels take it exactly
    where JAX's Pallas kernel does, and on CPU tensors the port's kernel impl
    computes what the JAX package's ``window_attention(impl="pallas")``
    computes there (its Pallas kernel in interpret mode, or its XLA route),
    forward and every gradient, at the f32 tolerances."""
    q, k, v, bias, rid, g = _inputs(shape, seed=13)
    _, n, _, d, _ = shape
    assert not wa.held_takes(n, d)
    assert wa.kernel_takes(n, d) == WA.supports_shape(n, d)
    jfn = functools.partial(jax_att.window_attention, impl="pallas")
    ref = np.asarray(jfn(*(_jax(x) for x in (q, k, v, bias)), jnp.asarray(rid)))
    leaves = [_torch(x).requires_grad_() for x in (q, k, v, bias)]
    out = att.window_attention(*leaves, _rid_t(rid), impl="kernel")
    assert out.shape == q.shape
    np.testing.assert_allclose(out.detach().numpy(), ref, atol=ATOL, rtol=RTOL)
    (out * torch.from_numpy(g)).sum().backward()
    for name, x, want in zip(("dq", "dk", "dv", "dbias"), leaves,
                             _jax_grads(q, k, v, bias, rid, g, jfn)):
        np.testing.assert_allclose(x.grad.numpy(), np.asarray(want), atol=GRAD_ATOL,
                                   rtol=GRAD_RTOL, err_msg=name)


def test_xla_route_rounds_the_bias_as_jax_does():
    """N = 453 > 448 and not a multiple of 8: JAX takes XLA, which rounds the
    bias (with the region mask added) to bf16; the port's kernel impl
    computes ``window_attention_xla``, within the twins' bf16 limit of JAX's
    output, while the f32-bias function is not."""
    q, k, v, bias, rid, _ = _inputs((2, 453, 1, 32, 1), seed=14)
    bias = bias * 8.0
    tq, tk, tv = (_torch(x, torch.bfloat16) for x in (q, k, v))
    tb, tr = _torch(bias), _rid_t(rid)
    out = att.window_attention(tq, tk, tv, tb, tr, impl="kernel")
    assert torch.equal(out, wa.window_attention_xla(tq, tk, tv, tb, tr))
    ref = torch.from_numpy(np.asarray(jax_att.window_attention(
        *(_jax(x, jnp.bfloat16) for x in (q, k, v)), jnp.asarray(bias), jnp.asarray(rid),
        impl="pallas"), np.float32))
    limit = wa.error_limit(tq, tk, tv, tb, tr, out)
    assert ((out.float() - ref).abs() / limit).max() <= 1.0
    f32_bias = wa.window_attention_plain(tq, tk, tv, tb, tr)
    assert ((f32_bias.float() - ref).abs() / limit).max() > 1.0


@pytest.mark.parametrize("d", [8, 16, 32, 40, 64, 96, 128, 136, 160, 200, 256, 264, 512])
def test_kernel_takes_every_shape_jax_runs_its_pallas_kernel_at(d):
    """``kernel_takes`` equals the JAX package's Pallas gate
    (``supports_shape``) wherever JAX takes its Pallas kernel, and wherever
    the held designs do not take the shape; within the held domain the
    kernels also take N % 8 != 0 (JAX's XLA route there rounds the bias, the
    kernels keep it f32: ``test_bias_is_not_rounded_at_unaligned_n``)."""
    for n in list(range(1, 1100)) + [1568, 2048, 3136, 4096, 6272]:
        jax_pallas = WA.supports_shape(n, d)
        assert wa.jax_takes_pallas(n, d) == jax_pallas, (n, d)
        if jax_pallas:
            assert wa.kernel_takes(n, d), (n, d)
        if not wa.held_takes(n, d):
            assert wa.kernel_takes(n, d) == jax_pallas, (n, d)
        else:
            assert wa.kernel_takes(n, d) and n <= wa.HELD_MAX_SEQ and d <= wa.HELD_MAX_HEAD_DIM


@pytest.mark.parametrize("shape", [(2, 464, 1, 16, 2), (2, 48, 2, 192, 1)], ids=str)
def test_bf16_twin_at_the_wide_shapes_matches_jax(shape):
    """bf16 at shapes the wide path newly takes: the port's kernel impl on
    CPU tensors (the twins the wide path computes) within the twins'
    elementwise limits of JAX's ``window_attention_pallas`` run in bf16
    (interpret mode), forward and gradients."""
    q, k, v, bias, rid, g = _inputs(shape, seed=15)
    _, n, _, d, _ = shape
    assert wa.kernel_takes(n, d) and not wa.held_takes(n, d)
    tq, tk, tv, tg = (_torch(x, torch.bfloat16) for x in (q, k, v, g))
    tb, tr = _torch(bias), _rid_t(rid)
    out = att.window_attention(tq, tk, tv, tb, tr, impl="kernel")
    ref = np.asarray(WA.window_attention_pallas(*(_jax(x, jnp.bfloat16) for x in (q, k, v)),
                                                jnp.asarray(bias), jnp.asarray(rid)), np.float32)
    limit = wa.error_limit(tq, tk, tv, tb, tr, out).numpy()
    assert (np.abs(out.float().numpy() - ref) / limit).max() <= 1.0
    grads = wa.window_attention_plain_bwd(tq, tk, tv, tb, tr, tg)
    limits = wa.backward_error_limit(tq, tk, tv, tb, tr, tg, grads)
    refs = _jax_grads(q, k, v, bias, rid, g, WA.window_attention_pallas, jnp.bfloat16)
    for name, got, want, lim in zip(("dq", "dk", "dv", "dbias"), grads, refs, limits):
        use = (np.abs(got.float().numpy() - np.asarray(want, np.float32)) / lim.numpy()).max()
        assert use <= 1.0, (name, use)


def test_region_mask_matches_jax():
    rid = np.random.default_rng(4).integers(0, 4, (5, 24)).astype(np.int32)
    want = np.asarray(WA.region_mask(jnp.asarray(rid))) != 0
    np.testing.assert_array_equal(wa.region_mask(torch.from_numpy(rid)).numpy(), want)


# ---------- kernels 11 and 12: the ablation variants ----------

def _jax_variant(q, k, v, bias, rid, kind):
    """The script's kernel body for ``kind`` in an interpret-mode pallas_call
    (the script's own launcher passes no ``interpret``)."""
    bench = _bench()
    bw, n, h, d = q.shape
    scale = 1.0 / float(np.sqrt(d))
    qt, kt, vt, bias_f, ridp = WA._prep(q, k, v, bias, rid)
    nw = ridp.shape[0]
    out_shape = jax.ShapeDtypeStruct((bw, h, n, d), q.dtype)
    if kind in ("bf16sm", "exp2"):
        nwin = WA._pick_nwin(bw, nw)
        qkv, bsp, rsp = WA._specs(bw, h, n, d, nw, nwin, interpret=True)
        sm = bench._softmax_bf16 if kind == "bf16sm" else bench._softmax_exp2
        body = functools.partial(bench._fwd_kernel_sm, scale=scale, nwin=nwin, softmax=sm)
        grid = (h, bw // nwin)
    else:
        hblk = 2 if h % 2 == 0 else (3 if h % 3 == 0 else 1)
        qkv = pl.BlockSpec((1, hblk, n, d), lambda hi, bwi: (bwi, hi, 0, 0))
        bsp = pl.BlockSpec((hblk, n, n), lambda hi, bwi: (hi, 0, 0))
        rsp = pl.BlockSpec((1, n, 1), lambda hi, bwi: (jax.lax.rem(bwi, nw) if nw > 1 else 0,
                                                       0, 0))
        body = functools.partial(bench._fwd_kernel_h2, scale=scale, hblk=hblk)
        grid = (h // hblk, bw)
    out = pl.pallas_call(body, grid=grid, in_specs=[qkv, qkv, qkv, bsp, rsp], out_specs=qkv,
                         out_shape=out_shape, interpret=True)(qt, kt, vt, bias_f, ridp)
    return out.transpose(0, 2, 1, 3)


@pytest.mark.parametrize("kind", wa.VARIANTS)
@pytest.mark.parametrize("shape,masked", [((4, 32, 2, 16, 2), True), ((3, 24, 3, 8, 1), False),
                                          ((2, 16, 5, 16, 2), True)], ids=str)
def test_variant_twins_match_the_script_kernels(shape, masked, kind):
    """f32 inputs: exp2 and h2 compute kernel 8's function (the JAX test's
    f32 tolerance); bf16sm rounds S - max to bf16 on both sides (its limit)."""
    q, k, v, bias, rid, _ = _inputs(shape, masked, seed=5)
    rid_j = None if rid is None else jnp.asarray(rid)
    ref = np.asarray(_jax_variant(*(_jax(x) for x in (q, k, v, bias)), rid_j, kind))
    tq, tk, tv, tb, tr = (*(_torch(x) for x in (q, k, v, bias)), _rid_t(rid))
    out = wa.window_attention_variant(tq, tk, tv, tb, tr, kind)
    if kind == "bf16sm":
        limit = wa.error_limit(tq, tk, tv, tb, tr, out, kind, f32_tol=ATOL).numpy()
        assert (np.abs(out.numpy() - ref) / limit).max() <= 1.0
    else:
        np.testing.assert_allclose(out.numpy(), ref, atol=ATOL, rtol=RTOL)


def test_bf16sm_variant_in_bf16_matches_the_script_kernel():
    q, k, v, bias, rid, _ = _inputs((4, 32, 2, 16, 2), seed=6)
    ref = np.asarray(_jax_variant(*(_jax(x, jnp.bfloat16) for x in (q, k, v)),
                                  jnp.asarray(bias), jnp.asarray(rid), "bf16sm"), np.float32)
    tq, tk, tv = (_torch(x, torch.bfloat16) for x in (q, k, v))
    tb, tr = _torch(bias), _rid_t(rid)
    out = wa.window_attention_variant(tq, tk, tv, tb, tr, "bf16sm")
    limit = wa.error_limit(tq, tk, tv, tb, tr, out, "bf16sm").numpy()
    assert (np.abs(out.float().numpy() - ref) / limit).max() <= 1.0
    # The variant's rounding is real: it differs from kernel 8's function.
    assert not torch.equal(out, wa.window_attention_plain(tq, tk, tv, tb, tr))


def test_heads_per_block_matches_the_script():
    for h in (1, 2, 3, 4, 5, 6, 9, 12, 24):
        assert wa.heads_per_block(h) == (2 if h % 2 == 0 else (3 if h % 3 == 0 else 1))


# ---------- wiring, checks and limits ----------

def test_function_carries_the_gradient_not_a_plain_call(monkeypatch):
    """The gradient comes from WindowAttentionFn.backward (kernel 9's twin):
    with that twin stubbed to zeros, q, k, v and the bias get zero gradient
    through the dispatcher; the plain impl's autograd gives one."""
    q, k, v, bias, rid, g = _inputs((4, 16, 2, 8, 2), seed=7)
    monkeypatch.setattr(wa, "window_attention_plain_bwd",
                        lambda q_, k_, v_, b_, r_, do: tuple(
                            torch.zeros_like(x) for x in (q_, k_, v_, b_)))
    leaves = [_torch(x).requires_grad_() for x in (q, k, v, bias)]
    (att.window_attention(*leaves, _rid_t(rid), impl="kernel") * _torch(g)).sum().backward()
    assert all(torch.count_nonzero(x.grad) == 0 for x in leaves)
    plain = [_torch(x).requires_grad_() for x in (q, k, v, bias)]
    (att.window_attention(*plain, _rid_t(rid), impl="plain") * _torch(g)).sum().backward()
    assert all(torch.count_nonzero(x.grad) > 0 for x in plain)


def test_cpu_calls_take_the_twins_and_count_no_launch():
    wa.reset_launches()
    q, k, v, bias, rid, g = (_torch(x) if x is not None and x.dtype == np.float32 else x
                             for x in _inputs((2, 16, 2, 8, 1), seed=8))
    with torch.no_grad():
        out = att.window_attention(q, k, v, bias, _rid_t(rid))
    assert out.grad_fn is None
    wa.window_attention_variant(q.bfloat16(), k.bfloat16(), v.bfloat16(), bias, _rid_t(rid),
                                "h2")
    assert all(n == 0 for n in wa.launch_counts().values())
    assert set(wa.launch_counts()) == {"window_attention_fwd", "window_attention_bwd",
                                       "window_attention_fwd_bf16sm",
                                       "window_attention_fwd_exp2", "window_attention_fwd_h2"}


@pytest.mark.parametrize("bad", ["shape", "bias", "rid_width", "rid_period", "rid_dtype",
                                 "long", "head_dim", "dtype", "kind"])
def test_checks_reject_bad_input(bad):
    q, k, v, bias, rid, _ = (_torch(x) if x is not None and x.dtype == np.float32 else x
                             for x in _inputs((4, 8, 2, 8, 2), seed=9))
    rid = _rid_t(rid)
    kind = "exp2"
    if bad == "shape":
        k = k[:, :4]
    if bad == "bias":
        bias = bias[:1]
    if bad == "rid_width":
        rid = rid[:, :4]
    if bad == "rid_period":
        rid = torch.zeros((3, 8), dtype=torch.int32)
    if bad == "rid_dtype":
        rid = rid.float()
    if bad == "long":
        q = k = v = torch.zeros((1, 449, 1, 8))
        bias, rid = torch.zeros((1, 449, 449)), None
    if bad == "head_dim":  # above the JAX Pallas kernel's 256 as well
        q = k = v = torch.zeros((4, 8, 2, 264))
    if bad == "dtype":
        v = v.double()
    if bad == "kind":
        kind = "h4"
    with pytest.raises(ValueError):
        wa.window_attention_variant(q, k, v, bias, rid, kind)
    if bad != "kind":
        with pytest.raises(ValueError):
            wa.window_attention_kernel(q, k, v, bias, rid)


def test_kernel_wrappers_refuse_cpu_tensors():
    q, k, v, bias, rid, g = (_torch(x) if x is not None and x.dtype == np.float32 else x
                             for x in _inputs((2, 8, 1, 8, 1), seed=10))
    with pytest.raises(ValueError, match="CUDA"):
        wa.window_attention_fwd_cuda(q, k, v, bias, _rid_t(rid))
    with pytest.raises(ValueError, match="CUDA"):
        wa.window_attention_bwd_cuda(q, k, v, bias, _rid_t(rid), g)
    with pytest.raises(ValueError, match="CUDA"):
        wa.window_attention_variant_cuda(q.bfloat16(), k.bfloat16(), v.bfloat16(), bias,
                                         _rid_t(rid), "h2")


def test_bf16_limit_refuses_a_dropped_key_tile_and_a_rounded_bias():
    """The bf16 limit admits the kernel's roundings, but not a kernel that
    lost a 64-key tile of the softmax, nor one that read the bias rounded
    to bf16."""
    q, k, v, bias, rid, _ = _inputs((2, 200, 2, 32, 2), seed=11)
    bias = bias * 8.0
    tq, tk, tv = (_torch(x, torch.bfloat16) for x in (q, k, v))
    tb, tr = _torch(bias), _rid_t(rid)
    ref = wa.window_attention_plain(tq, tk, tv, tb, tr)
    limit = wa.error_limit(tq, tk, tv, tb, tr, ref)
    s = wa._logits(tq, tk, tb, tr)
    s[..., 64:128] = -1e30
    dropped = wa._pv(torch.softmax(s, -1), tv, tq.dtype)
    assert ((dropped.float() - ref.float()).abs() / limit).max() > 1.0
    rounded = wa.window_attention_plain(tq, tk, tv, tb.bfloat16().float(), tr)
    assert ((rounded.float() - ref.float()).abs() / limit).max() > 1.0


def test_dbias_limit_refuses_a_dropped_window():
    """dbias sums ds over every window: a sum that left windows out is
    outside its limit."""
    q, k, v, bias, rid, g = _inputs((4, 32, 2, 16, 2), seed=12)
    args = [_torch(x) for x in (q, k, v, bias)] + [_rid_t(rid)]
    refs = wa.window_attention_plain_bwd(*args, _torch(g))
    limits = wa.backward_error_limit(*args, _torch(g), refs)
    part = wa.window_attention_plain_bwd(*(x[2:] for x in args[:3]), args[3], args[4],
                                         _torch(g)[2:])
    assert ((part[3] - refs[3]).abs() / limits[3]).max() > 1.0


def test_router_entry_matches_jax_dispatch(monkeypatch):
    """The JAX router takes its Pallas kernel when N % 8 == 0 and XLA
    otherwise; the port's kernel impl reaches its kernel entry at every N."""
    seen = []
    monkeypatch.setattr(att, "window_attention_kernel",
                        lambda *a: seen.append("kernel") or a[0])
    monkeypatch.setattr(att, "window_attention_plain", lambda *a: seen.append("plain") or a[0])
    for n in (392, 27, 1):
        q = torch.zeros((2, n, 1, 8))
        att.window_attention(q, q, q, torch.zeros((1, n, n)), None, impl="kernel")
        att.window_attention(q, q, q, torch.zeros((1, n, n)), None, impl="plain")
    assert seen == ["kernel", "plain"] * 3
    assert [WA.supports_shape(n, 8) for n in (392, 27, 1)] == [True, False, False]
    with pytest.raises(ValueError):
        att.window_attention(q, q, q, torch.zeros((1, 1, 1)), None, impl="xla")


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("bw,n,h", [(1024, 392, 3), (256, 392, 6), (64, 392, 12), (16, 392, 24),
                                    (1, 1, 1), (7, 100, 5), (3, 448, 2)])
def test_dbias_groups_cover_every_window_once(bw, n, h, dtype):
    """Kernel 9's window groups partition the B·nW windows: groups of
    ``per_group`` consecutive windows, the last one not empty."""
    per_group, groups = wa.dbias_groups(bw, n, h, 132, dtype)
    assert 1 <= groups <= 64 and per_group >= 1
    assert per_group * (groups - 1) < bw <= per_group * groups
