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


def _emulate_h2_schedule(q, k, v, bias, rid, kind="h2"):
    """Kernel 12's wgmma design on the CPU, in its schedule: per window the
    region ids once (a window whose ids name one region skips the mask), per
    block of ``heads_per_block`` heads each head in turn, per 64-query tile
    the two warpgroups' key ranges of KW (72, 136 or 200: 64-key chunks and
    an 8-wide last one), each chunk's S = Q K^T in f32 plus its bias tile as
    TMA streams it (rows and keys past N zero-filled), the -100 region mask,
    keys past N masked; the exact softmax over both warpgroups (the row max
    and sum exchanged, exp2 of S·log2(e) - max·log2(e)), P normalised and
    rounded to v's dtype, and warpgroup 1's partial P V added to warpgroup
    0's. Returns the output in q's dtype.

    With ``kind`` "bf16sm" or "exp2" it is kernel 11 on kernel 8's wgmma
    design (one head a block, the same key split, logits, exchanges and P V;
    the held bias rows give the logits the streamed tiles give): the
    exponential takes z = S - max (the exchanged row max), rounded to bf16
    before exp2(z·log2(e)) for bf16sm, or exp2(z·log2(e)) with the
    subtraction and the product each rounded for exp2."""
    bw, n, h, d = q.shape
    hb = wa.heads_per_block(h) if kind == "h2" else 1
    kw = 72 if n <= 144 else 136 if n <= 272 else 200
    nc = kw // 64 + 1
    log2e = 1.4426950408889634
    scale = torch.tensor(1.0 / d ** 0.5, dtype=torch.float32)
    span = 2 * kw + 64  # the keys the last chunk's box reaches
    n_rows = -(-n // 64) * 64
    bias_t = torch.zeros((h, n_rows, span))
    bias_t[:, :n, :n] = bias.float()
    kp, vp = (torch.zeros((bw, span, h, d)) for _ in range(2))
    kp[:, :n], vp[:, :n] = k.float(), v.float()
    ids = None if rid is None else rid.long()[torch.arange(bw) % rid.shape[0]]
    mixed = None if ids is None else (ids != ids[:, :1]).any(-1)
    out = torch.empty(q.shape, dtype=torch.float32)
    for hg in range(h // hb):
        for head in range(hg * hb, hg * hb + hb):
            for q0 in range(0, n, 64):
                rows = torch.arange(q0, min(q0 + 64, n))
                qt = q[:, rows, head].float()
                parts = []
                for wg in (0, 1):
                    chunks = []
                    for c in range(nc):
                        key0 = wg * kw + 64 * c
                        keys = torch.arange(key0, key0 + (64 if c < nc - 1 else 8))
                        s = torch.einsum("bqd,bkd->bqk", qt, kp[:, keys, head]) * scale
                        s = s + bias_t[head, rows][:, keys]
                        if ids is not None:
                            kid = ids[:, keys.clamp(max=n - 1)]
                            differ = (ids[:, rows, None] != kid[:, None, :]) & mixed[:, None, None]
                            s = torch.where(differ, s + wa.MASK_VALUE, s)
                        s[..., keys >= n] = -1e30
                        chunks.append((s, keys))
                    parts.append(chunks)
                mx = torch.maximum(*(torch.cat([s for s, _ in ch], -1).amax(-1, keepdim=True)
                                     for ch in parts))

                def exp(s):
                    if kind == "h2":
                        return torch.exp2(s * log2e - mx * log2e)
                    z = s - mx
                    if kind == "bf16sm":
                        z = z.to(torch.bfloat16).float()
                    return torch.exp2(z * log2e)

                ps = [[(exp(s), keys) for s, keys in ch] for ch in parts]
                l = sum(p.sum(-1, keepdim=True) for ch in ps for p, _ in ch)
                o = sum(torch.einsum("bqk,bkd->bqd", (p / l).to(v.dtype).float(),
                                     vp[:, keys, head]) for ch in ps for p, keys in ch)
                out[:, rows, head] = o
    return out.to(q.dtype)


@pytest.mark.parametrize("shape,masked", [((2, 392, 3, 32, 2), True), ((2, 392, 6, 16, 1), False),
                                          ((3, 100, 2, 32, 3), True)], ids=str)
def test_h2_wgmma_schedule_emulation_matches_the_script_kernel(shape, masked):
    """Kernel 12's new design, emulated in its schedule on the CPU (bias tiles
    of 64 keys as TMA streams them, the two warpgroups' 200-key ranges with
    N = 392's tail in the second, hb heads sharing a window's region ids), is
    held against the script's ``_fwd_kernel_h2`` in interpret mode at the
    JAX test's f32 tolerance, masked and unmasked, and in bf16 under the
    variant's ``error_limit``."""
    q, k, v, bias, rid, _ = _inputs(shape, masked, seed=8)
    rid_j = None if rid is None else jnp.asarray(rid)
    ref = np.asarray(_jax_variant(*(_jax(x) for x in (q, k, v, bias)), rid_j, "h2"))
    tq, tk, tv, tb, tr = (*(_torch(x) for x in (q, k, v, bias)), _rid_t(rid))
    emu = _emulate_h2_schedule(tq, tk, tv, tb, tr)
    np.testing.assert_allclose(emu.numpy(), ref, atol=ATOL, rtol=RTOL)
    bq, bk, bv = (_torch(x, torch.bfloat16) for x in (q, k, v))
    ref16 = np.asarray(_jax_variant(*(_jax(x, jnp.bfloat16) for x in (q, k, v)),
                                    jnp.asarray(bias), rid_j, "h2"), np.float32)
    emu16 = _emulate_h2_schedule(bq, bk, bv, tb, tr)
    limit = wa.error_limit(bq, bk, bv, tb, tr, emu16, "h2").numpy()
    assert (np.abs(emu16.float().numpy() - ref16) / limit).max() <= 1.0


@pytest.mark.parametrize("kind", ["bf16sm", "exp2"])
@pytest.mark.parametrize("shape,masked", [((2, 392, 3, 32, 2), True), ((2, 392, 6, 16, 1), False),
                                          ((3, 100, 2, 32, 3), True), ((2, 30, 2, 16, 1), True)],
                         ids=str)
def test_sm_wgmma_schedule_emulation_matches_the_script_kernel(shape, masked, kind):
    """Kernel 11 on kernel 8's wgmma design, emulated in its schedule on the
    CPU (the two warpgroups' key ranges with the row max and sum exchanged,
    z = S - max rounded to bf16 after the subtraction for bf16sm, the
    subtraction then the product by log2(e) for exp2), is held against the
    script's ``_fwd_kernel_sm`` in interpret mode under the variant's
    ``error_limit``, in f32 and in bf16, masked and unmasked."""
    q, k, v, bias, rid, _ = _inputs(shape, masked, seed=9)
    rid_j = None if rid is None else jnp.asarray(rid)
    tb, tr = _torch(bias), _rid_t(rid)
    for dtype, jdtype in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)):
        ref = np.asarray(_jax_variant(*(_jax(x, jdtype) for x in (q, k, v)), jnp.asarray(bias),
                                      rid_j, kind), np.float32)
        tq, tk, tv = (_torch(x, dtype) for x in (q, k, v))
        emu = _emulate_h2_schedule(tq, tk, tv, tb, tr, kind)
        limit = wa.error_limit(tq, tk, tv, tb, tr, emu, kind, f32_tol=ATOL).numpy()
        assert emu.dtype == dtype
        assert (np.abs(emu.float().numpy() - ref) / limit).max() <= 1.0


# (N, D, strides) -> kernel 11's design (bf16): kernel 8's, wgmma at N <= 400 and
# D <= 32 (padded) with every stride positive, mma.sync elsewhere.
SM_DESIGN = {(392, 32, None): "wgmma", (100, 32, None): "wgmma", (8, 16, None): "wgmma",
             (400, 24, None): "wgmma", (392, 20, None): "wgmma", (30, 16, None): "wgmma",
             (402, 32, None): "mma.sync", (448, 32, None): "mma.sync",
             (77, 64, None): "mma.sync", (392, 40, None): "mma.sync",
             (392, 32, (1, 8, 8, 0, 8, 8)): "mma.sync"}

# (N, D, strides) -> kernel 12's design (bf16): wgmma at N <= 400 with N % 4 == 0
# and D <= 32 (padded) with every stride positive, mma.sync elsewhere.
H2_DESIGN_CASES = [
    ((392, 32, None), "wgmma"),            # every Swin3D-T stage
    ((100, 32, None), "wgmma"),
    ((8, 16, None), "wgmma"),
    ((400, 24, None), "wgmma"),
    ((392, 20, None), "wgmma"),            # D padded to 24
    ((30, 16, None), "mma.sync"),          # a bias row of 120 bytes: no TMA box
    ((402, 32, None), "mma.sync"),
    ((448, 32, None), "mma.sync"),
    ((77, 64, None), "mma.sync"),
    ((392, 40, None), "mma.sync"),         # padded to 48
    ((392, 32, (1, 8, 8, 0, 8, 8)), "mma.sync"),  # a broadcast stride
]


@pytest.mark.parametrize("case,want", H2_DESIGN_CASES, ids=str)
def test_h2_design_takes_mirrors_the_c_choice(case, want):
    """``design_takes(..., kind="h2")`` names kernel 12's design as the C
    entry chooses it (held against ``window_attention_design`` on the card);
    kernel 11's variants run kernel 8's choice (``SM_DESIGN``: wgmma where
    kernel 8 runs it, with no N % 4 rule), and the variants refuse f32."""
    n, d, strides = case
    assert wa.design_takes(n, d, torch.bfloat16, strides, kind="h2") == want
    for kind in ("bf16sm", "exp2"):
        assert wa.design_takes(n, d, torch.bfloat16, strides, kind=kind) == SM_DESIGN[case]
        assert wa.design_takes(n, d, torch.bfloat16, strides, kind=kind) == (
            wa.design_takes(n, d, torch.bfloat16, strides))
    with pytest.raises(ValueError):
        wa.design_takes(n, d, torch.float32, strides, kind="h2")


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


@pytest.mark.parametrize("design", wa.DESIGNS)
@pytest.mark.parametrize("bw,n,h", [(1024, 392, 3), (256, 392, 6), (64, 392, 12), (16, 392, 24),
                                    (1, 1, 1), (7, 100, 5), (3, 448, 2)])
def test_dbias_groups_cover_every_window_once(bw, n, h, design):
    """Kernel 9's window groups partition the B·nW windows: groups of
    ``per_group`` consecutive windows, the last one not empty, so that every
    (head, 64-row tile, window) of the dbias launch (the wgmma design's
    dK/dV launch: its key tiles) is walked by exactly one block."""
    per_group, groups = wa.dbias_groups(bw, n, h, 132, design)
    assert 1 <= groups <= 64 and per_group >= 1
    assert per_group * (groups - 1) < bw <= per_group * groups
    n_t = -(-n // 64)
    walked = np.zeros((h, n_t, bw), dtype=np.int64)
    for head in range(h):
        for tile in range(n_t):
            for grp in range(groups):
                walked[head, tile, grp * per_group:min(bw, (grp + 1) * per_group)] += 1
    assert (walked == 1).all()


def test_dbias_groups_fill_the_card_at_the_swin3d_stages():
    """The wgmma design's dK/dV launch (one block an SM) fills the card
    about once at stages 1-2 and never leaves more than one group's
    partial per 22 windows; an unknown design is refused."""
    assert wa.dbias_groups(1024, 392, 3, 132, "wgmma") == (171, 6)
    assert wa.dbias_groups(256, 392, 6, 132, "wgmma") == (86, 3)
    assert wa.dbias_groups(16, 392, 24, 132, "wgmma") == (8, 2)
    # The f32 design's dK/dV launch has the same blocks: the same groups.
    for bw, h in ((1024, 3), (256, 6), (64, 12), (16, 24)):
        assert (wa.dbias_groups(bw, 392, h, 132, "wgmma.tf32x3")
                == wa.dbias_groups(bw, 392, h, 132, "wgmma"))
    with pytest.raises(ValueError):
        wa.dbias_groups(16, 392, 24, 132, "tensor")


# (N, D, dtype, strides) -> the design the C entries run: the wgmma design at
# bf16, N <= 400, D <= 32 (padded) with positive strides, wgmma.tf32x3 in f32
# there; mma.sync (bf16) and fma (f32) elsewhere at N <= 448, D <= 128; the
# wide path beyond.
DESIGN_CASES = [
    ((392, 32, torch.bfloat16, None), "wgmma"),          # every Swin3D-T stage
    ((8, 32, torch.bfloat16, None), "wgmma"),
    ((56, 32, torch.bfloat16, None), "wgmma"),
    ((200, 32, torch.bfloat16, None), "wgmma"),
    ((400, 32, torch.bfloat16, None), "wgmma"),
    ((1, 8, torch.bfloat16, None), "wgmma"),
    ((245, 20, torch.bfloat16, None), "wgmma"),          # D padded to 24
    ((401, 32, torch.bfloat16, None), "mma.sync"),
    ((448, 32, torch.bfloat16, None), "mma.sync"),
    ((392, 64, torch.bfloat16, None), "mma.sync"),
    ((392, 40, torch.bfloat16, None), "mma.sync"),       # padded to 48
    ((392, 32, torch.bfloat16, (1, 8, 8, 0, 8, 8)), "mma.sync"),  # a broadcast stride
    ((392, 32, torch.float32, None), "wgmma.tf32x3"),   # every Swin3D-T stage in f32
    ((8, 32, torch.float32, None), "wgmma.tf32x3"),
    ((400, 32, torch.float32, None), "wgmma.tf32x3"),
    ((245, 20, torch.float32, None), "wgmma.tf32x3"),    # D padded to 24
    ((401, 32, torch.float32, None), "fma"),
    ((392, 64, torch.float32, None), "fma"),
    ((392, 32, torch.float32, (1, 8, 8, 0, 8, 8)), "fma"),  # a broadcast stride
    ((512, 32, torch.bfloat16, None), "wide"),
    ((392, 192, torch.bfloat16, None), "wide"),
    ((512, 32, torch.float32, None), "wide"),
]


@pytest.mark.parametrize("case,want", DESIGN_CASES, ids=str)
def test_design_takes_mirrors_the_c_choice(case, want):
    n, d, dtype, strides = case
    assert wa.design_takes(n, d, dtype, strides) == want
    assert wa.kernel_takes(n, d)


# -- kernels 8-9's f32 design (wgmma.tf32x3), emulated on the CPU ----------


def _tf32(x):
    """x rounded to TF32 (10 mantissa bits) to nearest, ties away from zero,
    by integer ops on the f32 bits: ``cvt.rna.tf32.f32``."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _split_tf32(x):
    """The kernels' split (``tf32_split``): big = x with its low 13 bits
    masked, small = tf32(x - big); x - big is exact in f32."""
    big = (x.float().contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)
    return big, _tf32(x.float() - big)


def _split_bf16(x):
    """hi = bf16(x), lo = bf16(x - hi), both rounded to nearest even: bf16x3."""
    hi = x.float().to(torch.bfloat16).float()
    return hi, (x.float() - hi).to(torch.bfloat16).float()


def _emulate_f32_design(q, k, v, bias, rid, g, split="tf32x3"):
    """The f32 tensor-core design's arithmetic on the CPU, forward and
    backward: each of the five products (S = Q K^T, O = P V, dP = dO V^T,
    dV = P^T dO, dQ = ds K and dK = ds^T Q) as small.big + big.small +
    big.big over two TF32 parts (``"tf32x3"``, the kernels' split) or two
    bf16 parts (``"bf16x3"``, a split no kernel runs), or one TF32 product of
    the operands rounded to nearest (``"tf32"``); the logits, the exact
    softmax, delta, ds, the scale and dbias in f32. Returns (o, (dq, dk, dv,
    dbias))."""
    parts = {"tf32x3": _split_tf32, "bf16x3": _split_bf16,
             "tf32": lambda x: (_tf32(x), None)}[split]

    def prod(eq, a, b):
        (ab, a_small), (bb, b_small) = parts(a), parts(b)
        out = torch.einsum(eq, ab, bb)
        if a_small is not None:
            out = torch.einsum(eq, a_small, bb) + torch.einsum(eq, ab, b_small) + out
        return out

    bw, n, h, d = q.shape
    scale = 1.0 / d ** 0.5
    s = prod("bqhd,bkhd->bhqk", q, k) * scale + bias
    if rid is not None:
        mask = wa.region_mask(rid)
        nw = mask.shape[0]
        s = s.view(bw // nw, nw, h, n, n)
        s = torch.where(mask[None, :, None], s + wa.MASK_VALUE, s).view(bw, h, n, n)
    p = torch.exp(s - s.amax(-1, keepdim=True))
    p = p / p.sum(-1, keepdim=True)
    o = prod("bhqk,bkhd->bqhd", p, v)
    dp = prod("bqhd,bkhd->bhqk", g, v)
    ds = p * (dp - (p * dp).sum(-1, keepdim=True))
    dv = prod("bhqk,bqhd->bkhd", p, g)
    dq = prod("bhqk,bkhd->bqhd", ds, k) * scale
    dk = prod("bhqk,bqhd->bkhd", ds, q) * scale
    return o, (dq, dk, dv, ds.sum(0))


def _f32_design_uses(shape, seed):
    """|err| / limit of each split's emulation against the JAX package's f32
    ``window_attention_pallas`` (interpret mode) and ``jax.grad`` through it:
    {split: [o / 1e-4, dq, dk, dv, dbias under backward_error_limit]}."""
    q, k, v, bias, rid, g = _inputs(shape, seed=seed)
    rid_j = jnp.asarray(rid)
    ref = np.asarray(WA.window_attention_pallas(*(_jax(x) for x in (q, k, v, bias)), rid_j))
    refs = [torch.from_numpy(np.array(x))
            for x in _jax_grads(q, k, v, bias, rid, g, WA.window_attention_pallas)]
    args = [_torch(x) for x in (q, k, v, bias)] + [_rid_t(rid), _torch(g)]
    limits = wa.backward_error_limit(*args, refs)
    out = {}
    for split in ("tf32x3", "tf32", "bf16x3"):
        o, grads = _emulate_f32_design(*args, split=split)
        out[split] = [np.abs(o.numpy() - ref).max() / 1e-4] + [
            ((x - r).abs() / lim).max().item() for x, r, lim in zip(grads, refs, limits)]
    return out


@pytest.mark.parametrize("shape", [(2, 392, 2, 32, 2), (3, 200, 2, 32, 1)], ids=str)
def test_f32_split_tf32_emulation_holds_the_limits_where_one_term_does_not(shape):
    """Kernels 8-9's f32 design splits every operand into two TF32 parts
    and sums three products per product (3xTF32). Emulated on the CPU at
    Swin3D's N = 392, D = 32 with region ids, forward and backward, it
    stays within 1e-4 of the JAX package's f32 window kernel on O and within
    ``backward_error_limit`` (F32_REL·A + 1e-6) on dq, dk, dv and dbias;
    one-term TF32 on the same inputs does not, which is why the split exists.
    bf16x3 (hi and lo bf16 parts, a split no kernel runs) holds them too,
    but nearer the limits than 3xTF32 on every output."""
    uses = _f32_design_uses(shape, seed=30)
    assert max(uses["tf32x3"]) <= 0.25, uses["tf32x3"]
    assert uses["tf32"][0] > 1.0 and max(uses["tf32"][1:]) > 1.0, uses["tf32"]
    assert max(uses["bf16x3"]) <= 1.0, uses["bf16x3"]
    assert all(b > t for b, t in zip(uses["bf16x3"], uses["tf32x3"])), uses
