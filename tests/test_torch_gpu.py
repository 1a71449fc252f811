"""Port tests that need the card: the CUDA kernels (flash, kernels 1-4,
with kernels 3-4 in both bf16 designs; short-sequence, kernels 6-7;
shifted-window, kernels 8-9 and the ablation variants 11-12; the biased
flash forward, kernel 5; the tubelet embedding, kernel 10) against their
plain versions, gradients through them, the routing, the ViViT,
TimeSformer and Swin3D train steps on the card, remat (every kernel
launched as often as without it), gradient accumulation and the profiler's
trace there, and the wires (``-k wire``: each decode head against the CPU's,
the native library where libav is present, a tiny ViViT served over each
wire and trained on dctp, the Pillow route).

They skip on a machine without CUDA. On the card, run them with
``python -m pytest --noconftest -p no:cacheprovider tests/test_torch_gpu.py``
(``--noconftest``: the suite's conftest imports JAX, which the card's
machine does not need). This file imports no JAX.
"""

import math

import numpy as np
import pytest
import torch

from laryngeal_tpu_torch.ops import flash_attention as fa
from laryngeal_tpu_torch.ops import short_attention as sa
from laryngeal_tpu_torch.ops import tubelet as tt
from laryngeal_tpu_torch.ops import window_attention as wa

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _within_limit(q, k, v, kv_valid, out, ref):
    """Largest |out - ref| / limit, with the kernel's rounding limit."""
    diff = (out.float() - ref.float()).abs()
    return (diff / fa.error_limit(q, k, v, kv_valid, ref)).max().item()


def _qkv(shape_q, shape_k, dtype, device, seed=0):
    rng = np.random.default_rng(seed)
    q = torch.from_numpy(rng.standard_normal(shape_q, dtype=np.float32))
    k = torch.from_numpy(rng.standard_normal(shape_k, dtype=np.float32))
    v = torch.from_numpy(rng.standard_normal(shape_k, dtype=np.float32))
    return tuple(x.to(device=device, dtype=dtype) for x in (q, k, v))


# (B, Nq, Nk, H, D, kv_valid)
SHAPES = [
    (2, 64, 64, 3, 32, None),
    (2, 300, 300, 3, 32, 250),
    (2, 513, 513, 4, 16, None),
    (1, 100, 333, 2, 64, None),
    (1, 333, 100, 2, 64, 77),
    (2, 200, 200, 2, 40, None),    # D padded to 48 inside the wrapper
    (1, 129, 257, 2, 128, 200),
    (1, 1, 5, 1, 8, None),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", SHAPES)
def test_kernel_matches_plain(cuda, shape, dtype):
    b, nq, nk, h, d, kv_valid = shape
    q, k, v = _qkv((b, nq, h, d), (b, nk, h, d), dtype, cuda)
    before = fa.launches
    out = fa.flash_attention(q, k, v, kv_valid)
    torch.cuda.synchronize()
    assert fa.launches == before + 1
    assert out.dtype == dtype and out.shape == (b, nq, h, d)
    ref = fa.attention_plain(q, k, v, kv_valid)
    use = _within_limit(q, k, v, kv_valid, out, ref)
    assert use <= 1.0, use


def test_kernel_reads_strided_views(cuda):
    """q/k/v as views into one fused (B, N, 3, H, D) tensor: no copies needed."""
    rng = np.random.default_rng(1)
    qkv = torch.from_numpy(rng.standard_normal((2, 200, 3, 4, 64), dtype=np.float32))
    qkv = qkv.to(cuda, torch.bfloat16)
    q, k, v = qkv.unbind(2)
    out = fa.flash_attention(q, k, v)
    ref = fa.attention_plain(q, k, v)
    use = _within_limit(q, k, v, None, out, ref)
    assert use <= 1.0, use


def test_kernel_rejects_bad_input(cuda):
    q, k, v = _qkv((1, 8, 1, 16), (1, 8, 1, 16), torch.float16, cuda)
    with pytest.raises(ValueError):
        fa.flash_attention(q, k, v)
    q, k, v = _qkv((1, 8, 1, 160), (1, 8, 1, 160), torch.bfloat16, cuda)
    with pytest.raises(ValueError):
        fa.flash_attention(q, k, v)


def _tiny_vivit(dtype):
    from laryngeal_tpu_torch.models.vivit import create_vivit

    return create_vivit(num_frames=16, image_size=128, hidden_size=64, num_layers=2,
                        num_heads=4, intermediate_size=128, dtype=dtype, seed=0)


@pytest.mark.parametrize("dtype,atol", [(torch.float32, 1e-4), (torch.bfloat16, 3e-2)])
def test_vivit_kernel_matches_plain_attention(cuda, dtype, atol):
    """N = 513 tokens: every layer launches the kernel once; the logits agree
    with the same model on the plain attention."""
    from laryngeal_tpu_torch.ops import attention as att

    model = _tiny_vivit(dtype).to(cuda)
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (2, 16, 128, 128, 3), dtype=np.float32)).to(cuda)
    with torch.inference_mode():
        before = fa.launches
        out = model(x)
        assert fa.launches == before + 2
        att.set_attention_impl("plain")
        try:
            ref = model(x)
        finally:
            att.set_attention_impl(None)
    assert out.dtype == torch.float32
    err = (out - ref).abs().max().item()
    assert err <= atol, err


def test_predictor_on_card_matches_cpu(cuda):
    from laryngeal_tpu_torch.infer.predictor import Predictor
    from laryngeal_tpu_torch.models.registry import get_model_spec

    spec = get_model_spec("vivit")
    model = _tiny_vivit(torch.float32)
    cpu = Predictor(_tiny_vivit(torch.float32), spec, num_frames=16, crop_size=128,
                    device="cpu")
    card = Predictor(model, spec, num_frames=16, crop_size=128)
    assert card.device.type == "cuda"
    clip = np.random.default_rng(3).integers(0, 256, (2, 16, 128, 128, 3), dtype=np.uint8)
    before = fa.launches
    probs = card.predict_clip(clip)
    assert fa.launches == before + 2
    np.testing.assert_allclose(probs, cpu.predict_clip(clip), atol=1e-4)


# -- kernels 2-4: the training path --------------------------------------


def _grad_inputs(shape, dtype, device, seed=0):
    b, nq, nk, h, d, _ = shape
    q, k, v = _qkv((b, nq, h, d), (b, nk, h, d), dtype, device, seed)
    g = torch.from_numpy(np.random.default_rng(seed + 100).standard_normal(
        (b, nq, h, d), dtype=np.float32)).to(device=device, dtype=dtype)
    return q, k, v, g


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", SHAPES)
def test_lse_kernel_matches_plain(cuda, shape, dtype):
    b, nq, nk, h, d, kv_valid = shape
    q, k, v = _qkv((b, nq, h, d), (b, nk, h, d), dtype, cuda)
    before = fa.lse_launches
    out, lse = fa.flash_attention_lse(q, k, v, kv_valid)
    torch.cuda.synchronize()
    assert fa.lse_launches == before + 1
    assert out.dtype == dtype and lse.shape == (b, h, nq) and lse.dtype == torch.float32
    ref, ref_lse = fa.attention_plain_lse(q, k, v, kv_valid)
    assert _within_limit(q, k, v, kv_valid, out, ref) <= 1.0
    assert (lse - ref_lse).abs().max().item() <= fa.LSE_TOL


# Kernels 1-2's phase-2 cases at small batch: (B, Nq, Nk, H, D, kv_valid,
# layout): the ViViT-B sequence (N = 3137, a one-key last tile), N = 300 with
# kv_valid, Nq != Nk both ways, D = 32, 40 (padded to 48) and 128, views of
# a fused (B, N, 3, H, D) projection and (B, H, N, D) tensors transposed.
FWD_CASES = [
    (1, 3137, 3137, 2, 64, None, "contiguous"),
    (2, 300, 300, 3, 64, 250, "contiguous"),
    (2, 257, 1100, 3, 64, None, "contiguous"),
    (2, 1100, 257, 3, 64, 200, "contiguous"),
    (2, 1000, 1000, 2, 32, 900, "contiguous"),
    (2, 700, 700, 2, 40, None, "contiguous"),
    (1, 600, 600, 2, 128, 555, "contiguous"),
    (1, 3137, 3137, 2, 64, None, "fused"),
    (2, 1000, 777, 2, 64, 700, "bhnd"),
]


def _fwd_inputs(case, device, seed=0, dtype=torch.bfloat16):
    """q, k, v of a FWD_CASES case in its layout, ``dtype`` on ``device``."""
    b, nq, nk, h, d, _, layout = case
    rng = np.random.default_rng(seed)
    mk = lambda *shape: torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).to(
        device=device, dtype=dtype)
    if layout == "fused":
        return mk(b, nq, 3, h, d).unbind(2)
    if layout == "bhnd":
        return mk(b, h, nq, d).transpose(1, 2), *(mk(b, h, nk, d).transpose(1, 2)
                                                  for _ in range(2))
    return mk(b, nq, h, d), mk(b, nk, h, d), mk(b, nk, h, d)


def _entry_design(dtype, d):
    """The design kernels 1-2's entries run at head dim ``d`` with positive
    strides: wgmma in bf16; wgmma.tf32x3 in f32 at D <= 64, FMA above."""
    if dtype == torch.bfloat16:
        return "wgmma"
    return "wgmma.tf32x3" if d <= 64 else "fma"


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=str)
@pytest.mark.parametrize("case", FWD_CASES, ids=str)
def test_forward_designs_both_match_plain(cuda, case, dtype):
    """Kernels 1 and 2 in the entries' design (bf16: wgmma; f32: wgmma.tf32x3
    at D <= 64, FMA at 128) and in the earlier design (the _mma entries:
    mma.sync in bf16, FMA in f32) are all within error_limit (f32: 1e-4),
    lse within LSE_TOL, and kernel 1 gives kernel 2's bits."""
    kv_valid = case[5]
    q, k, v = _fwd_inputs(case, cuda, dtype=dtype)
    ref, ref_lse = fa.attention_plain_lse(q, k, v, kv_valid)
    earlier = "mma.sync" if dtype == torch.bfloat16 else "fma"
    for design, (one, two) in (
            (_entry_design(dtype, case[4]), (fa.flash_attention_cuda, fa.flash_attention_lse_cuda)),
            (earlier, (fa.flash_attention_mma_cuda, fa.flash_attention_lse_mma_cuda))):
        out = one(q, k, v, kv_valid)
        out2, lse = two(q, k, v, kv_valid)
        torch.cuda.synchronize()
        assert fa.last_forward_designs() == (design, design)
        assert out.shape == ref.shape and out.dtype == dtype
        assert _within_limit(q, k, v, kv_valid, out, ref) <= 1.0, design
        assert torch.equal(out, out2), design
        assert (lse - ref_lse).abs().max().item() <= fa.LSE_TOL, design


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=str)
@pytest.mark.parametrize("case", [FWD_CASES[0], FWD_CASES[3], FWD_CASES[6]], ids=str)
def test_forward_kernels_are_deterministic(cuda, case, dtype):
    """Two calls of the entries' design (bf16: wgmma; f32: wgmma.tf32x3, FMA
    at D = 128) give bitwise the same o and lse."""
    q, k, v = _fwd_inputs(case, cuda, seed=1, dtype=dtype)
    (o1, l1), (o2, l2) = (fa.flash_attention_lse_cuda(q, k, v, case[5]) for _ in range(2))
    torch.cuda.synchronize()
    assert fa.last_forward_designs()[1] == _entry_design(dtype, case[4])
    assert torch.equal(o1, o2) and torch.equal(l1, l2)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=str)
@pytest.mark.parametrize("case", [c for c in FWD_CASES if c[6] != "contiguous"] + [
    (2, 333, 200, 3, 32, None, "fused"), (2, 333, 200, 3, 128, 150, "bhnd")], ids=str)
def test_forward_kernels_read_fused_and_transposed_views(cuda, case, dtype):
    """Views of a fused projection or of transposed (B, H, N, D) tensors:
    kernels 1-2 read them through their strides (the wgmma designs, TMA; f32
    at D = 128 the FMA kernel) and give bitwise the o and lse of contiguous
    copies."""
    q, k, v = _fwd_inputs(case, cuda, seed=2, dtype=dtype)
    views = fa.flash_attention_lse_cuda(q, k, v, case[5])
    assert fa.last_forward_designs()[1] == _entry_design(dtype, case[4])
    copies = fa.flash_attention_lse_cuda(*(x.contiguous() for x in (q, k, v)), case[5])
    torch.cuda.synchronize()
    assert torch.equal(views[0], copies[0]) and torch.equal(views[1], copies[1])


def test_forward_kernels_report_the_design_they_ran(cuda):
    """The C side reports the design of its last launch: bf16 takes wgmma at
    every head dim when every stride is positive, mma.sync for a stride of 0
    (a broadcast key, which TMA cannot describe) and through the _mma
    entries; f32 takes wgmma.tf32x3 at D <= 64 when every stride is
    positive, and the FMA kernel at D = 128, for a stride of 0 and through
    the _mma entries."""
    q, k, v = _qkv((1, 200, 2, 64), (1, 150, 2, 64), torch.bfloat16, cuda)
    for d in (32, 64, 128):
        qd, kd, vd = (torch.nn.functional.pad(x, (0, d - 64)) if d > 64 else x[..., :d]
                      for x in (q, k, v))
        fa.flash_attention_cuda(qd, kd, vd)
        fa.flash_attention_lse_cuda(qd, kd, vd)
        assert fa.last_forward_designs() == ("wgmma", "wgmma"), d
    kb, vb = (x[:, :1].expand(-1, 150, -1, -1) for x in (k, v))  # sequence stride 0
    out = fa.flash_attention_cuda(q, kb, vb)
    assert fa.last_forward_designs()[0] == "mma.sync"
    assert _within_limit(q, kb, vb, None, out, fa.attention_plain(q, kb, vb)) <= 1.0
    fa.flash_attention_mma_cuda(q, k, v)
    fa.flash_attention_lse_mma_cuda(q, k, v)
    assert fa.last_forward_designs() == ("mma.sync", "mma.sync")
    qf, kf, vf = q.float(), k.float(), v.float()
    for d in (32, 64, 128):
        qd, kd, vd = (torch.nn.functional.pad(x, (0, d - 64)) if d > 64 else x[..., :d]
                      for x in (qf, kf, vf))
        fa.flash_attention_cuda(qd, kd, vd)
        fa.flash_attention_lse_cuda(qd, kd, vd)
        assert fa.last_forward_designs() == (_entry_design(torch.float32, d),) * 2, d
    kb, vb = (x[:, :1].expand(-1, 150, -1, -1) for x in (kf, vf))  # sequence stride 0
    out = fa.flash_attention_cuda(qf, kb, vb)
    assert fa.last_forward_designs()[0] == "fma"
    assert _within_limit(qf, kb, vb, None, out, fa.attention_plain(qf, kb, vb)) <= 1.0
    fa.flash_attention_mma_cuda(qf, kf, vf)
    fa.flash_attention_lse_mma_cuda(qf, kf, vf)
    assert fa.last_forward_designs() == ("fma", "fma")


def test_forward_f32_launch_error_raises(cuda, monkeypatch):
    """No fallback: when the f32 wgmma.tf32x3 design cannot launch (here a
    sequence stride of 66 elements, 264 bytes, which TMA refuses, reaching
    the C entry because the layout step is bypassed) kernels 1 and 2 raise
    with the CUDA error and count no launch; they do not run the FMA kernel
    instead."""
    b, n, h, d = 2, 300, 1, 64
    base = torch.zeros((3, b, n, h, 66), dtype=torch.float32, device=cuda)
    q, k, v = (x[..., :d] for x in base.unbind(0))
    monkeypatch.setattr(fa, "_prepare", lambda x, d_pad: x)
    before = (fa.launches, fa.lse_launches)
    with pytest.raises(RuntimeError, match="flash_attention_fwd launch failed: cudaError"):
        fa.flash_attention_cuda(q, k, v)
    with pytest.raises(RuntimeError, match="flash_attention_fwd_lse launch failed: cudaError"):
        fa.flash_attention_lse_cuda(q, k, v)
    assert fa.last_forward_designs() == ("wgmma.tf32x3", "wgmma.tf32x3")
    assert (fa.launches, fa.lse_launches) == before


def test_forward_kernels_count_one_launch_per_call(cuda):
    """Kernel 1's wrapper counts one launch of kernel 1, kernel 2's one of
    kernel 2; the mma.sync design's wrappers count none."""
    q, k, v = _qkv((1, 300, 2, 64), (1, 300, 2, 64), torch.bfloat16, cuda)
    for fn, want in ((fa.flash_attention_cuda, (1, 0)), (fa.flash_attention_lse_cuda, (0, 1)),
                     (fa.flash_attention_mma_cuda, (0, 0)),
                     (fa.flash_attention_lse_mma_cuda, (0, 0))):
        before = (fa.launches, fa.lse_launches)
        fn(q, k, v)
        assert (fa.launches - before[0], fa.lse_launches - before[1]) == want, fn.__name__


# Kernels 3-4: SHAPES, then the ViViT-B sequence (N = 3137 = 49 x 64 + 1, a
# one-row last tile) at D = 64 and at D = 128 with kv_valid, and Nq != Nk both
# ways at D = 32 (kv_valid) and 40 (padded to 48).
BWD_SHAPES = SHAPES + [
    (1, 3137, 3137, 2, 64, None),
    (1, 3137, 3137, 1, 128, 3000),
    (2, 200, 700, 2, 32, 650),
    (1, 700, 200, 3, 40, None),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", BWD_SHAPES)
def test_backward_kernels_match_plain(cuda, shape, dtype):
    b, nq, nk, h, d, kv_valid = shape
    q, k, v, g = _grad_inputs(shape, dtype, cuda)
    o, lse = fa.attention_plain_lse(q, k, v, kv_valid)
    before = (fa.dq_launches, fa.dkv_launches)
    grads = fa.flash_attention_bwd(q, k, v, o, lse, g, kv_valid)
    torch.cuda.synchronize()
    assert (fa.dq_launches, fa.dkv_launches) == (before[0] + 1, before[1] + 1)
    refs = fa.attention_plain_bwd(q, k, v, o, lse, g, kv_valid)
    limits = fa.backward_error_limit(q, k, v, o, lse, g, kv_valid, refs)
    for name, got, ref, lim in zip(("dq", "dk", "dv"), grads, refs, limits):
        assert got.dtype == dtype and got.shape == ref.shape, name
        use = ((got.float() - ref.float()).abs() / lim).max().item()
        assert use <= 1.0, (name, use)
    if kv_valid is not None and kv_valid < nk:
        assert torch.count_nonzero(grads[1][:, kv_valid:]) == 0
        assert torch.count_nonzero(grads[2][:, kv_valid:]) == 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_autograd_carries_gradients_through_the_kernels(cuda, dtype):
    """A CUDA attention call under autograd gives q, k and v gradients,
    through kernels 2-4 (not kernel 1), matching the plain attention's."""
    shape = (2, 300, 300, 3, 32, 250)
    q, k, v, g = _grad_inputs(shape, dtype, cuda, seed=4)
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    counts = fa.launch_counts()
    out = fa.flash_attention(*leaves, kv_valid=250)
    (out.float() * g.float()).sum().backward()
    torch.cuda.synchronize()
    after = fa.launch_counts()
    assert {n: after[n] - counts[n] for n in after} == {
        "flash_attention_fwd": 0, "flash_attention_fwd_lse": 1,
        "flash_attention_bwd_dq": 1, "flash_attention_bwd_dkv": 1,
        "flash_attention_fwd_bias": 0}
    plain = [x.clone().requires_grad_() for x in (q, k, v)]
    (fa.attention_plain(*plain, kv_valid=250).float() * g.float()).sum().backward()
    o, lse = fa.attention_plain_lse(q, k, v, 250)
    refs = fa.attention_plain_bwd(q, k, v, o, lse, g, 250)
    limits = fa.backward_error_limit(q, k, v, o, lse, g, 250, refs)
    for x, p, lim in zip(leaves, plain, limits):
        assert x.grad is not None and torch.isfinite(x.grad).all()
        if dtype == torch.float32:
            assert ((x.grad - p.grad).abs() / lim).max().item() <= 1.0
        else:  # the bf16 plain autograd rounds elsewhere: same direction, loose
            cos = torch.nn.functional.cosine_similarity(
                x.grad.float().flatten(), p.grad.float().flatten(), dim=0)
            assert cos.item() > 0.99


def _bwd_calls(q, k, v, g, kv_valid):
    """(lse, delta, refs, limits) of a backward case: the plain forward's lse,
    delta from its o, and attention_plain_bwd's (dq, dk, dv) with their
    limits."""
    o, lse = fa.attention_plain_lse(q, k, v, kv_valid)
    refs = fa.attention_plain_bwd(q, k, v, o, lse, g, kv_valid)
    limits = fa.backward_error_limit(q, k, v, o, lse, g, kv_valid, refs)
    return lse, fa.attention_delta(o, g), refs, limits


@pytest.mark.parametrize("shape", BWD_SHAPES)
def test_backward_designs_both_match_plain(cuda, shape):
    """bf16: the entries' design (wgmma; dK/dV at D = 128 mma.sync) and the
    earlier mma.sync design (the _mma entries) are both within
    backward_error_limit, and both give masked keys exactly zero dK, dV."""
    b, nq, nk, h, d, kv_valid = shape
    q, k, v, g = _grad_inputs(shape, torch.bfloat16, cuda, seed=6)
    lse, delta, refs, limits = _bwd_calls(q, k, v, g, kv_valid)
    designs = {
        "entries": (fa.flash_attention_dq_cuda(q, k, v, g, lse, delta, kv_valid),
                    *fa.flash_attention_dkv_cuda(q, k, v, g, lse, delta, kv_valid)),
        "mma.sync": (fa.flash_attention_dq_mma_cuda(q, k, v, g, lse, delta, kv_valid),
                     *fa.flash_attention_dkv_mma_cuda(q, k, v, g, lse, delta, kv_valid))}
    torch.cuda.synchronize()
    for design, grads in designs.items():
        for name, got, ref, lim in zip(("dq", "dk", "dv"), grads, refs, limits):
            assert got.dtype == torch.bfloat16 and got.shape == ref.shape, (design, name)
            use = ((got.float() - ref.float()).abs() / lim).max().item()
            assert use <= 1.0, (design, name, use)
        if kv_valid is not None and kv_valid < nk:
            assert torch.count_nonzero(grads[1][:, kv_valid:]) == 0, design
            assert torch.count_nonzero(grads[2][:, kv_valid:]) == 0, design


@pytest.mark.parametrize("shape", [(2, 1000, 1000, 3, 64, 900), (1, 600, 300, 2, 128, 250),
                                   (2, 3137, 3137, 2, 32, None)])
def test_backward_kernels_are_deterministic(cuda, shape):
    """Two calls give bitwise the same dq, dk and dv: each block owns its
    output rows and no sum uses atomics."""
    b, nq, nk, h, d, kv_valid = shape
    q, k, v, g = _grad_inputs(shape, torch.bfloat16, cuda, seed=7)
    lse, delta, _, _ = _bwd_calls(q, k, v, g, kv_valid)
    first, second = ((fa.flash_attention_dq_cuda(q, k, v, g, lse, delta, kv_valid),
                      *fa.flash_attention_dkv_cuda(q, k, v, g, lse, delta, kv_valid))
                     for _ in range(2))
    torch.cuda.synchronize()
    for name, a, b_ in zip(("dq", "dk", "dv"), first, second):
        assert torch.equal(a, b_), name


@pytest.mark.parametrize("d", [32, 64, 128])
@pytest.mark.parametrize("layout", ["fused", "bhnd"])
def test_backward_kernels_read_fused_and_transposed_views(cuda, d, layout):
    """q, k, v as views of one fused (B, N, 3, H, D) projection, or (B, H, N,
    D) tensors transposed to (B, N, H, D) views (Nq != Nk): the kernels read
    them through their strides and give bitwise the dq, dk, dv of contiguous
    copies."""
    rng = np.random.default_rng(8)
    b, n, h = 2, 333, 3
    if layout == "fused":
        fused = torch.from_numpy(rng.standard_normal((b, n, 3, h, d), dtype=np.float32))
        q, k, v = fused.to(cuda, torch.bfloat16).unbind(2)
    else:
        q = torch.from_numpy(rng.standard_normal((b, h, n, d), dtype=np.float32))
        q = q.to(cuda, torch.bfloat16).transpose(1, 2)
        k, v = (torch.from_numpy(rng.standard_normal((b, h, 200, d), dtype=np.float32))
                .to(cuda, torch.bfloat16).transpose(1, 2) for _ in range(2))
    g = torch.from_numpy(rng.standard_normal(q.shape, dtype=np.float32)).to(cuda, torch.bfloat16)
    lse, delta, _, _ = _bwd_calls(q, k, v, g, None)

    def grads(*xs):
        qq, kk, vv = xs
        return (fa.flash_attention_dq_cuda(qq, kk, vv, g, lse, delta),
                *fa.flash_attention_dkv_cuda(qq, kk, vv, g, lse, delta))

    views, copies = grads(q, k, v), grads(*(x.contiguous() for x in (q, k, v)))
    torch.cuda.synchronize()
    for name, a, b_ in zip(("dq", "dk", "dv"), views, copies):
        assert torch.equal(a, b_), name


def test_backward_kernels_count_one_launch_per_call(cuda):
    """Kernel 3's wrapper counts one launch of kernel 3, kernel 4's one of
    kernel 4; the mma.sync design's wrappers count none."""
    shape = (1, 300, 300, 2, 64, None)
    q, k, v, g = _grad_inputs(shape, torch.bfloat16, cuda, seed=9)
    lse, delta, _, _ = _bwd_calls(q, k, v, g, None)
    for fn, want in ((fa.flash_attention_dq_cuda, (1, 0)), (fa.flash_attention_dkv_cuda, (0, 1)),
                     (fa.flash_attention_dq_mma_cuda, (0, 0)),
                     (fa.flash_attention_dkv_mma_cuda, (0, 0))):
        before = (fa.dq_launches, fa.dkv_launches)
        fn(q, k, v, g, lse, delta)
        assert (fa.dq_launches - before[0], fa.dkv_launches - before[1]) == want, fn.__name__


def test_backward_kernels_report_the_design_they_ran(cuda):
    """The C side reports the design of its last launch: bf16 at D = 64
    takes wgmma for both kernels, at D = 128 wgmma for dQ and mma.sync for
    dK/dV; the _mma wrappers run mma.sync; f32 at D = 64 takes wgmma.tf32x3
    for both kernels."""
    for d, dtype, fns, want in (
            (64, torch.bfloat16, (fa.flash_attention_dq_cuda, fa.flash_attention_dkv_cuda),
             ("wgmma", "wgmma")),
            (128, torch.bfloat16, (fa.flash_attention_dq_cuda, fa.flash_attention_dkv_cuda),
             ("wgmma", "mma.sync")),
            (64, torch.bfloat16, (fa.flash_attention_dq_mma_cuda,
                                  fa.flash_attention_dkv_mma_cuda), ("mma.sync", "mma.sync")),
            (64, torch.float32, (fa.flash_attention_dq_cuda, fa.flash_attention_dkv_cuda),
             ("wgmma.tf32x3", "wgmma.tf32x3"))):
        q, k, v, g = _grad_inputs((1, 200, 200, 2, d, None), dtype, cuda, seed=10)
        lse, delta, _, _ = _bwd_calls(q, k, v, g, None)
        for fn in fns:
            fn(q, k, v, g, lse, delta)
        assert fa.last_backward_designs() == want, (d, dtype)


# Kernels 3-4's f32 design, wgmma.tf32x3 (D <= 64, every stride positive):
# (Nq, Nk, kv_valid) at its 32-row steps' and 64-row tiles' edges, Nq != Nk.
TF32_BWD_NS = [(1, 1, None), (31, 33, 32), (32, 32, None), (33, 31, 1), (63, 65, 64),
               (64, 64, 33), (65, 63, None), (300, 1100, 1000), (1100, 300, 257)]


def _tf32_bwd_inputs(nq, nk, d, layout, seed):
    """f32 q, k, v (contiguous, views of a fused (B, N, 3, H, D) projection
    with Nk = Nq, or (B, H, N, D) tensors transposed) and a contiguous g."""
    rng = np.random.default_rng(seed)
    mk = lambda *shape: torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).cuda()
    b, h = 2, 3
    if layout == "fused":
        q, k, v = mk(b, nq, 3, h, d).unbind(2)
    elif layout == "bhnd":
        q = mk(b, h, nq, d).transpose(1, 2)
        k, v = (mk(b, h, nk, d).transpose(1, 2) for _ in range(2))
    else:
        q, k, v = mk(b, nq, h, d), mk(b, nk, h, d), mk(b, nk, h, d)
    return q, k, v, mk(b, nq, h, d)


@pytest.mark.parametrize("layout", ["contiguous", "fused", "bhnd"])
@pytest.mark.parametrize("d", [32, 40, 64])
@pytest.mark.parametrize("case", TF32_BWD_NS, ids=str)
def test_backward_tf32_edges_match_plain_and_repeat(cuda, case, d, layout):
    """f32 kernels 3-4 on wgmma.tf32x3 at the edges of its steps and tiles
    (Nq != Nk, kv_valid; fused-qkv views take Nk = Nq): within
    backward_error_limit of attention_plain_bwd (F32_REL*A + 1e-6), masked
    keys' dK and dV exactly 0, bitwise the same on a second call."""
    nq, nk, kv_valid = case
    if layout == "fused":
        nk = nq
        kv_valid = kv_valid if kv_valid is None or kv_valid < nq else None
    q, k, v, g = _tf32_bwd_inputs(nq, nk, d, layout, seed=nq + nk + d)
    o, lse = fa.attention_plain_lse(q, k, v, kv_valid)
    refs = fa.attention_plain_bwd(q, k, v, o, lse, g, kv_valid)
    limits = fa.backward_error_limit(q, k, v, o, lse, g, kv_valid, refs)
    first = fa.flash_attention_bwd(q, k, v, o, lse, g, kv_valid)
    assert fa.last_backward_designs() == ("wgmma.tf32x3", "wgmma.tf32x3")
    second = fa.flash_attention_bwd(q, k, v, o, lse, g, kv_valid)
    torch.cuda.synchronize()
    for name, got, again, ref, lim in zip(("dq", "dk", "dv"), first, second, refs, limits):
        assert got.shape == ref.shape and got.dtype == torch.float32, name
        use = ((got - ref).abs() / lim).max().item()
        assert use <= 1.0, (name, use)
        assert torch.equal(got, again), name
    if kv_valid is not None and kv_valid < nk:
        assert torch.count_nonzero(first[1][:, kv_valid:]) == 0
        assert torch.count_nonzero(first[2][:, kv_valid:]) == 0


def test_backward_tf32_vivit_b_shape_matches_plain_and_repeats(cuda):
    """The ViViT-B sequence (N = 3137 = 98 x 32 + 1, a one-key last step)
    at D = 64 on a fused-qkv view: within the limits, bitwise repeatable."""
    q, k, v, g = _tf32_bwd_inputs(3137, 3137, 64, "fused", seed=3)
    o, lse = fa.attention_plain_lse(q, k, v)
    refs = fa.attention_plain_bwd(q, k, v, o, lse, g)
    limits = fa.backward_error_limit(q, k, v, o, lse, g, None, refs)
    first, second = (fa.flash_attention_bwd(q, k, v, o, lse, g) for _ in range(2))
    torch.cuda.synchronize()
    assert fa.last_backward_designs() == ("wgmma.tf32x3", "wgmma.tf32x3")
    for name, got, again, ref, lim in zip(("dq", "dk", "dv"), first, second, refs, limits):
        assert ((got - ref).abs() / lim).max().item() <= 1.0, name
        assert torch.equal(got, again), name


def test_backward_f32_outside_the_tf32_domain_runs_fma(cuda):
    """f32 kernels 3-4 take the FMA kernels at D = 128, for an expanded
    (stride-0) key view, which TMA cannot describe, and through the _mma
    entries; each within the limits."""
    q, k, v, g = _grad_inputs((1, 200, 150, 2, 128, None), torch.float32, cuda, seed=12)
    kb, vb = (x[:, :1].expand(-1, 150, -1, -1) for x in (k[..., :64], v[..., :64]))
    for qq, kk, vv, gg, fns in (
            (q, k, v, g, (fa.flash_attention_dq_cuda, fa.flash_attention_dkv_cuda)),
            (q[..., :64], kb, vb, g[..., :64], (fa.flash_attention_dq_cuda,
                                                 fa.flash_attention_dkv_cuda)),
            (q[..., :64], k[..., :64], v[..., :64], g[..., :64],
             (fa.flash_attention_dq_mma_cuda, fa.flash_attention_dkv_mma_cuda))):
        lse, delta, refs, limits = _bwd_calls(qq, kk, vv, gg, None)
        got = (fns[0](qq, kk, vv, gg, lse, delta), *fns[1](qq, kk, vv, gg, lse, delta))
        torch.cuda.synchronize()
        assert fa.last_backward_designs() == ("fma", "fma"), qq.shape
        for name, x, ref, lim in zip(("dq", "dk", "dv"), got, refs, limits):
            assert ((x - ref).abs() / lim).max().item() <= 1.0, name


def test_backward_tf32_counts_one_launch_per_call(cuda):
    """In f32 too, kernel 3's wrapper counts one launch of kernel 3 and
    kernel 4's one of kernel 4; the _mma wrappers (FMA) count none."""
    q, k, v, g = _grad_inputs((1, 300, 300, 2, 64, None), torch.float32, cuda, seed=13)
    lse, delta, _, _ = _bwd_calls(q, k, v, g, None)
    for fn, want in ((fa.flash_attention_dq_cuda, (1, 0)), (fa.flash_attention_dkv_cuda, (0, 1)),
                     (fa.flash_attention_dq_mma_cuda, (0, 0)),
                     (fa.flash_attention_dkv_mma_cuda, (0, 0))):
        before = (fa.dq_launches, fa.dkv_launches)
        fn(q, k, v, g, lse, delta)
        assert (fa.dq_launches - before[0], fa.dkv_launches - before[1]) == want, fn.__name__


@pytest.mark.parametrize("layout", ["fused", "bhnd"])
def test_backward_tf32_gradients_through_autograd_match_plain(cuda, layout):
    """FlashAttentionFn in f32 at D = 64 (kernel 2 on wgmma.tf32x3, then
    kernels 3-4 on wgmma.tf32x3) on views: q, k and v gradients within
    backward_error_limit of the plain attention's autograd."""
    nq, nk = 700, (700 if layout == "fused" else 500)
    q, k, v, g = _tf32_bwd_inputs(nq, nk, 64, layout, seed=14)
    leaves = [x.detach().clone().requires_grad_() for x in (q, k, v)]
    counts = fa.launch_counts()
    (fa.flash_attention(*leaves, kv_valid=450) * g).sum().backward()
    torch.cuda.synchronize()
    after = fa.launch_counts()
    assert {n: after[n] - counts[n] for n in after} == {
        "flash_attention_fwd": 0, "flash_attention_fwd_lse": 1,
        "flash_attention_bwd_dq": 1, "flash_attention_bwd_dkv": 1,
        "flash_attention_fwd_bias": 0}
    assert fa.last_backward_designs() == ("wgmma.tf32x3", "wgmma.tf32x3")
    plain = [x.detach().clone().requires_grad_() for x in (q, k, v)]
    (fa.attention_plain(*plain, kv_valid=450) * g).sum().backward()
    o, lse = fa.attention_plain_lse(q, k, v, 450)
    refs = fa.attention_plain_bwd(q, k, v, o, lse, g, 450)
    limits = fa.backward_error_limit(q, k, v, o, lse, g, 450, refs)
    for x, p, lim in zip(leaves, plain, limits):
        assert ((x.grad - p.grad).abs() / lim).max().item() <= 1.0


def test_backward_dkv_scratch_is_the_f32_designs_prepass_forms(cuda):
    """Kernel 4's C side asks for scratch only where wgmma.tf32x3 takes the
    call (its pre-pass's forms of q and dO, 8 B H Npad HD floats, and each
    query's lse and delta, 2 B H Npad, Npad = Nq rounded up to 32, HD = 32
    or 64): none in bf16, at D = 128, for a stride of 0 or through the _mma
    entry."""
    import ctypes

    query = fa._kernel("flash_attention_bwd_dkv_scratch_floats")
    st = lambda *xs: (ctypes.c_longlong * 18)(*xs, *([1] * (18 - len(xs))))
    pos = st(*([8] * 12))
    b, nq, h = 2, 100, 3
    assert query(0, b, nq, h, 64, pos, 0) == 8 * b * h * 128 * 64 + 2 * b * h * 128
    assert query(0, b, nq, h, 24, pos, 0) == 8 * b * h * 128 * 32 + 2 * b * h * 128
    assert query(1, b, nq, h, 64, pos, 0) == 0
    assert query(0, b, nq, h, 128, pos, 0) == 0
    assert query(0, b, nq, h, 64, st(8, 8, 8, 8, 0, 8, *([8] * 6)), 0) == 0
    assert query(0, b, nq, h, 64, pos, 1) == 0


def test_backward_tf32_launch_error_raises(cuda, monkeypatch):
    """No fallback: when the f32 wgmma.tf32x3 design cannot launch (a
    sequence stride of 66 elements, 264 bytes, which TMA refuses, reaching
    the C entries because the layout step is bypassed) kernels 3 and 4
    raise with the CUDA error and count no launch; they do not run the FMA
    kernels instead."""
    b, n, h, d = 2, 300, 1, 64
    base = torch.zeros((4, b, n, h, 66), dtype=torch.float32, device=cuda)
    q, k, v, g = (x[..., :d] for x in base.unbind(0))
    lse = torch.zeros((b, h, n), dtype=torch.float32, device=cuda)
    delta = torch.zeros_like(lse)
    monkeypatch.setattr(fa, "_prepare", lambda x, d_pad: x)
    before = (fa.dq_launches, fa.dkv_launches)
    with pytest.raises(RuntimeError, match="flash_attention_bwd_dq launch failed: cudaError"):
        fa.flash_attention_dq_cuda(q, k, v, g, lse, delta)
    with pytest.raises(RuntimeError, match="flash_attention_bwd_dkv launch failed: cudaError"):
        fa.flash_attention_dkv_cuda(q, k, v, g, lse, delta)
    assert fa.last_backward_designs() == ("wgmma.tf32x3", "wgmma.tf32x3")
    assert (fa.dq_launches, fa.dkv_launches) == before


def test_train_step_on_card_launches_kernels_2_to_4(cuda):
    """A tiny ViViT train step on the card: 2 launches each of kernels 2-4
    and none of kernel 1 (2 layers); the eval step launches kernel 1 twice.
    Loss and updated weights agree with the same step on the CPU (f32)."""
    from laryngeal_tpu_torch.train.state import create_train_state
    from laryngeal_tpu_torch.train.steps import make_eval_step, make_train_step

    rng = np.random.default_rng(5)
    pix = torch.from_numpy(rng.integers(0, 256, (2, 16, 128, 128, 3), dtype=np.uint8))
    labels, mask = torch.tensor([0, 1]), torch.tensor([True, True])
    results = {}
    for dev in ("cpu", cuda):
        model = _tiny_vivit(torch.float32).to(dev)
        state = create_train_state(model, "adamw", 1e-3, 0.01)
        step = make_train_step(model, "vivit", "ce", crop=128)
        before = fa.launch_counts()
        state, m = step(state, pix.to(dev), labels.to(dev), mask.to(dev))
        if dev == cuda:
            torch.cuda.synchronize()
            after = fa.launch_counts()
            assert {k: after[k] - before[k] for k in after} == {
                "flash_attention_fwd": 0, "flash_attention_fwd_lse": 2,
                "flash_attention_bwd_dq": 2, "flash_attention_bwd_dkv": 2,
                "flash_attention_fwd_bias": 0}
            before = after
            make_eval_step(model, "vivit", "ce", crop=128)(state, pix.to(dev), labels.to(dev),
                                                           mask.to(dev))
            torch.cuda.synchronize()
            after = fa.launch_counts()
            assert after["flash_attention_fwd"] - before["flash_attention_fwd"] == 2
            assert after["flash_attention_fwd_lse"] == before["flash_attention_fwd_lse"]
        results[str(dev)] = (m["loss"].item(), {n: p.detach().cpu() for n, p in
                                                model.state_dict().items()})
    (loss_c, w_c), (loss_g, w_g) = results["cpu"], results[str(cuda)]
    assert abs(loss_c - loss_g) <= 1e-4 * max(1.0, abs(loss_c))
    for n, w in w_c.items():
        if n.endswith("attention.attention.key.bias"):
            continue  # its gradient is round-off (softmax is shift-invariant)
        assert ((w_g[n] - w).norm() / w.norm()).item() <= 1e-4, n


# -- kernels 6-7: short-sequence attention (TimeSformer) -------------------
# (B, N, H, D) across the router's domain: N in 1..511, D <= 128, odd B*H;
# then the edges of kernel 6's wgmma design (64 < N <= 256) at D 32, 64, 128.
SHORT_SHAPES = [
    (3, 1, 5, 64),
    (5, 5, 3, 16),
    (7, 16, 3, 32),
    (3, 32, 5, 64),
    (2, 33, 3, 40),     # D padded to 48 inside the wrapper
    (3, 64, 3, 128),
    (2, 100, 3, 64),
    (1, 197, 5, 64),
    (1, 300, 3, 128),
    (1, 511, 3, 16),
    (1, 511, 1, 128),
    (3, 65, 1, 32),
    (1, 65, 3, 128),
    (1, 128, 3, 64),
    (3, 100, 1, 72),    # D padded to 72, the 128-wide design
    (3, 192, 1, 128),
    (1, 197, 3, 32),
    (3, 208, 1, 64),
    (1, 255, 3, 128),
    (1, 256, 3, 32),
    (3, 256, 1, 128),
    (1, 256, 5, 64),
    (1, 257, 3, 64),
    (3, 257, 1, 32),
]


def _short_inputs(shape, dtype, device, seed=0):
    b, n, h, d = shape
    rng = np.random.default_rng(seed)
    return tuple(torch.from_numpy(rng.standard_normal((b, n, h, d), dtype=np.float32))
                 .to(device=device, dtype=dtype) for _ in range(4))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", SHORT_SHAPES)
def test_short_forward_kernel_matches_plain(cuda, shape, dtype):
    q, k, v, _ = _short_inputs(shape, dtype, cuda)
    before = sa.fwd_launches
    out = sa.short_attention(q, k, v)
    torch.cuda.synchronize()
    assert sa.fwd_launches == before + 1
    assert out.dtype == dtype and out.shape == q.shape
    ref = sa.short_attention_plain(q, k, v)
    use = ((out.float() - ref.float()).abs() / sa.error_limit(q, k, v, ref)).max().item()
    assert use <= 1.0, use


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", SHORT_SHAPES)
def test_short_backward_kernel_matches_plain(cuda, shape, dtype):
    q, k, v, g = _short_inputs(shape, dtype, cuda, seed=1)
    before = sa.bwd_launches
    grads = sa.short_attention_backward(q, k, v, g)
    torch.cuda.synchronize()
    assert sa.bwd_launches == before + 1
    refs = sa.short_attention_plain_bwd(q, k, v, g)
    limits = sa.backward_error_limit(q, k, v, g, refs)
    for name, got, ref, lim in zip(("dq", "dk", "dv"), grads, refs, limits):
        assert got.dtype == dtype and got.shape == ref.shape, name
        use = ((got.float() - ref.float()).abs() / lim).max().item()
        assert use <= 1.0, (name, use)


def test_short_kernels_read_strided_views(cuda):
    """q/k/v as views into one fused (B, N, 3, H, D) qkv, as TimeSformer
    gives them; the gradient of the fused tensor through autograd."""
    rng = np.random.default_rng(2)
    qkv = torch.from_numpy(rng.standard_normal((4, 197, 3, 4, 64), dtype=np.float32))
    qkv = qkv.to(cuda, torch.bfloat16).requires_grad_()
    g = torch.from_numpy(rng.standard_normal((4, 197, 4, 64), dtype=np.float32)).to(
        cuda, torch.bfloat16)
    before = sa.launch_counts()
    out = sa.short_attention(*qkv.unbind(2))
    (out.float() * g.float()).sum().backward()
    torch.cuda.synchronize()
    after = sa.launch_counts()
    assert {n: after[n] - before[n] for n in after} == {"short_attention_fwd": 1,
                                                        "short_attention_bwd": 1}
    q, k, v = (x.detach() for x in qkv.unbind(2))
    ref = sa.short_attention_plain(q, k, v)
    assert ((out.float() - ref.float()).abs() / sa.error_limit(q, k, v, ref)).max() <= 1.0
    refs = sa.short_attention_plain_bwd(q, k, v, g)
    for got, ref_g, lim in zip(qkv.grad.unbind(2), refs,
                               sa.backward_error_limit(q, k, v, g, refs)):
        assert ((got.float() - ref_g.float()).abs() / lim).max() <= 1.0


@pytest.mark.parametrize("d", [32, 64, 128])
@pytest.mark.parametrize("layout", ["fused", "bhnd"])
def test_short_forward_reads_fused_and_transposed_views(cuda, d, layout):
    """Kernel 6 at N = 197 on q, k, v as views of a fused (B, N, 3, H, D)
    qkv (TimeSformer's) and as (B, H, N, D) tensors transposed to
    (B, N, H, D) (the sequence stride below the head stride)."""
    rng = np.random.default_rng(d)
    if layout == "fused":
        x = torch.from_numpy(rng.standard_normal((3, 197, 3, 5, d), dtype=np.float32))
        q, k, v = x.to(cuda, torch.bfloat16).unbind(2)
    else:
        q, k, v = (torch.from_numpy(rng.standard_normal((3, 5, 197, d), dtype=np.float32))
                   .to(cuda, torch.bfloat16).transpose(1, 2) for _ in range(3))
    out = sa.short_attention(q, k, v)
    ref = sa.short_attention_plain(q, k, v)
    assert ((out.float() - ref.float()).abs() / sa.error_limit(q, k, v, ref)).max() <= 1.0


@pytest.mark.parametrize("shape", [(1, 65, 3, 64), (2, 197, 3, 64), (1, 256, 3, 128),
                                   (3, 150, 1, 32), (1, 32, 3, 64), (1, 300, 3, 64)])
def test_short_forward_designs_both_match_plain(cuda, shape):
    """The production entry (wgmma at 64 < N <= 256, mma.sync elsewhere) and
    the kept mma.sync design (``short_attention_fwd_mma``) each stay within
    ``error_limit`` of the twin; only the production entry counts a launch."""
    q, k, v, _ = _short_inputs(shape, torch.bfloat16, cuda, seed=3)
    ref = sa.short_attention_plain(q, k, v)
    limit = sa.error_limit(q, k, v, ref)
    before = sa.launch_counts()
    for fn in (sa.short_attention_fwd_cuda, sa.short_attention_fwd_mma_cuda):
        out = fn(q, k, v)
        torch.cuda.synchronize()
        assert out.dtype == torch.bfloat16 and out.shape == q.shape
        assert ((out.float() - ref.float()).abs() / limit).max().item() <= 1.0, fn.__name__
    after = sa.launch_counts()
    assert {n: after[n] - before[n] for n in after} == {"short_attention_fwd": 1,
                                                        "short_attention_bwd": 0}


def test_short_forward_counts_one_launch_per_call(cuda):
    """Each production call of kernel 6 adds exactly one to ``fwd_launches``,
    at the wgmma design's N and at the mma.sync design's."""
    for shape in ((2, 197, 3, 64), (4, 32, 3, 64), (1, 400, 1, 32)):
        q, k, v, _ = _short_inputs(shape, torch.bfloat16, cuda)
        for i in range(1, 4):
            before = sa.fwd_launches
            sa.short_attention(q, k, v)
            torch.cuda.synchronize()
            assert sa.fwd_launches == before + 1, (shape, i)


def test_router_sends_short_self_attention_to_kernel_6(cuda):
    """N < 512 self-attention launches kernel 6; N = 513, Nq != Nk and
    kv_valid launch kernel 1 (the JAX router's split)."""
    from laryngeal_tpu_torch.ops import attention as att

    def counts(fn):
        b6, b1 = sa.fwd_launches, fa.launches
        fn()
        torch.cuda.synchronize()
        return sa.fwd_launches - b6, fa.launches - b1

    q, k, v, _ = _short_inputs((2, 511, 2, 64), torch.bfloat16, cuda)
    assert counts(lambda: att.dot_product_attention(q, k, v)) == (1, 0)
    q2, k2, v2, _ = _short_inputs((2, 512, 2, 64), torch.bfloat16, cuda)
    assert counts(lambda: att.dot_product_attention(q2, k2, v2)) == (0, 1)
    assert counts(lambda: att.dot_product_attention(q, k, v, kv_valid=300)) == (0, 1)
    assert counts(lambda: att.dot_product_attention(q[:, :100], k, v)) == (0, 1)


def test_short_kernel_rejects_bad_input(cuda):
    q, k, v, _ = _short_inputs((1, 8, 1, 16), torch.float16, cuda)
    with pytest.raises(ValueError):
        sa.short_attention(q, k, v)
    q, k, v, _ = _short_inputs((1, 512, 1, 16), torch.bfloat16, cuda)
    with pytest.raises(ValueError):
        sa.short_attention(q, k, v)


def _short_bwd_uses(grads, q, k, v, g):
    """Largest |err| / backward_error_limit of (dq, dk, dv) against the twin."""
    refs = sa.short_attention_plain_bwd(q, k, v, g)
    return [((x.float() - r.float()).abs() / lim).max().item()
            for x, r, lim in zip(grads, refs, sa.backward_error_limit(q, k, v, g, refs))]


@pytest.mark.parametrize("d", [32, 64])
@pytest.mark.parametrize("n", [65, 128, 197, 256])
def test_short_backward_designs_both_match_plain(cuda, n, d):
    """bf16 at the edges of kernel 7's wgmma domain: the entry (which
    reports ``wgmma``) and the kept mma.sync design
    (``short_attention_bwd_mma``, which reports ``mma.sync``) each stay
    within ``backward_error_limit`` of the twin."""
    q, k, v, g = _short_inputs((3, n, 5, d), torch.bfloat16, cuda, seed=n + d)
    for fn, design in ((sa.short_attention_bwd_cuda, "wgmma"),
                       (sa.short_attention_bwd_mma_cuda, "mma.sync")):
        grads = fn(q, k, v, g)
        torch.cuda.synchronize()
        assert sa.last_designs()[1] == design, fn.__name__
        assert all(x.dtype == torch.bfloat16 and x.shape == q.shape for x in grads)
        uses = _short_bwd_uses(grads, q, k, v, g)
        assert max(uses) <= 1.0, (fn.__name__, uses)


@pytest.mark.parametrize("case", ["d128", "n32", "n257", "expand", "f32"])
def test_short_backward_outside_the_wgmma_domain_runs_mma_sync(cuda, case):
    """Kernel 7 takes mma.sync at D = 128, N = 32 (the temporal shape),
    N = 257 and on a stride-0 (``expand``) view, the FMA kernel in f32 at
    the temporal N with D = 72 (f32 at D <= 64 runs mma.tf32x3 there and
    wgmma.tf32x3 at N = 197); the Python mirror of the C gate agrees, and
    the result holds its limit."""
    shape = {"d128": (2, 197, 3, 128), "n32": (4, 32, 3, 64), "n257": (2, 257, 3, 64),
             "f32": (4, 32, 3, 72)}.get(case, (2, 197, 3, 64))
    dtype = torch.float32 if case == "f32" else torch.bfloat16
    q, k, v, g = _short_inputs(shape, dtype, cuda, seed=11)
    if case == "expand":  # one sequence broadcast over the batch: batch stride 0
        q, k, v = (x[:1].expand(shape) for x in (q, k, v))
    grads = sa.short_attention_bwd_cuda(q, k, v, g)
    torch.cuda.synchronize()
    want = "fma" if case == "f32" else "mma.sync"
    assert sa.last_designs()[1] == want
    strides = [s for x in (q, k, v, g, *grads) for s in sa._prepare(x, shape[3]).stride()[:3]]
    assert sa.design_takes(1, shape[1], shape[3], dtype, strides) == want
    assert max(_short_bwd_uses(grads, q, k, v, g)) <= 1.0


def test_short_forward_reports_the_design_it_ran(cuda):
    """``last_designs()[0]`` is kernel 6's design as the C side chose it:
    wgmma at N = 197 (bf16), mma.sync at N = 32 and through the _mma entry;
    in f32 wgmma.tf32x3 at N = 197, mma.tf32x3 at N = 32, the FMA kernel
    through the _mma entry."""
    for shape, dtype, fn, want in (
            ((2, 197, 3, 64), torch.bfloat16, sa.short_attention_fwd_cuda, "wgmma"),
            ((2, 32, 3, 64), torch.bfloat16, sa.short_attention_fwd_cuda, "mma.sync"),
            ((2, 197, 3, 64), torch.bfloat16, sa.short_attention_fwd_mma_cuda, "mma.sync"),
            ((2, 197, 3, 64), torch.float32, sa.short_attention_fwd_cuda, "wgmma.tf32x3"),
            ((2, 32, 3, 64), torch.float32, sa.short_attention_fwd_cuda, "mma.tf32x3"),
            ((2, 197, 3, 64), torch.float32, sa.short_attention_fwd_mma_cuda, "fma")):
        q, k, v, _ = _short_inputs(shape, dtype, cuda, seed=16)
        fn(q, k, v)
        assert sa.last_designs()[0] == want, (shape, dtype, fn.__name__)


def test_short_backward_gate_mirror_agrees_with_the_c_side(cuda):
    """``design_takes`` names the design kernel 7's C entry reports, across the
    domain's edges and outside it."""
    for shape in ((2, 64, 3, 64), (2, 65, 3, 64), (1, 256, 3, 64), (1, 257, 3, 64),
                  (2, 197, 3, 32), (2, 197, 3, 72), (2, 197, 3, 40), (2, 100, 3, 16)):
        q, k, v, g = _short_inputs(shape, torch.bfloat16, cuda, seed=12)
        grads = sa.short_attention_bwd_cuda(q, k, v, g)
        d_pad = -(-shape[3] // 8) * 8
        strides = [s for x in (q, k, v, g, *grads) for s in sa._prepare(x, d_pad).stride()[:3]]
        want = sa.design_takes(1, shape[1], shape[3], torch.bfloat16, strides)
        assert sa.last_designs()[1] == want, shape


@pytest.mark.parametrize("shape", [(8, 197, 12, 64), (3, 65, 5, 32), (2, 256, 3, 64)])
def test_short_backward_wgmma_is_deterministic(cuda, shape):
    """Two calls of the wgmma design give bitwise the same dq, dk and dv:
    a block owns each (sequence, head) pair and no sum uses atomics."""
    q, k, v, g = _short_inputs(shape, torch.bfloat16, cuda, seed=13)
    first = sa.short_attention_bwd_cuda(q, k, v, g)
    second = sa.short_attention_bwd_cuda(q, k, v, g)
    torch.cuda.synchronize()
    assert sa.last_designs()[1] == "wgmma"
    for name, a, b in zip(("dq", "dk", "dv"), first, second):
        assert torch.equal(a, b), name


@pytest.mark.parametrize("d", [32, 64])
@pytest.mark.parametrize("layout", ["fused", "bhnd"])
def test_short_backward_wgmma_reads_views_through_autograd(cuda, d, layout):
    """q, k, v as views of a fused (B, N, 3, H, D) qkv or as (B, H, N, D)
    tensors transposed to (B, N, H, D), through autograd
    (``ShortAttentionFn``): kernel 7 runs its wgmma design once and the
    gradients hold ``backward_error_limit``."""
    rng = np.random.default_rng(14 + d)
    b, n, h = 3, 197, 4
    if layout == "fused":
        base = torch.from_numpy(rng.standard_normal((b, n, 3, h, d), dtype=np.float32))
        base = base.to(cuda, torch.bfloat16).requires_grad_()
        leaves = base.unbind(2)
    else:
        base = torch.from_numpy(rng.standard_normal((3, b, h, n, d), dtype=np.float32))
        base = base.to(cuda, torch.bfloat16).requires_grad_()
        leaves = [x.transpose(1, 2) for x in base.unbind(0)]
    g = torch.from_numpy(rng.standard_normal((b, n, h, d), dtype=np.float32)).to(
        cuda, torch.bfloat16)
    before = dict(sa.bwd_design_launches)
    out = sa.short_attention(*leaves)
    (out.float() * g.float()).sum().backward()
    torch.cuda.synchronize()
    assert sa.bwd_design_launches["wgmma"] - before["wgmma"] == 1
    q, k, v = (x.detach() for x in leaves)
    grads = base.grad.unbind(2) if layout == "fused" else [x.transpose(1, 2)
                                                            for x in base.grad.unbind(0)]
    assert max(_short_bwd_uses(grads, q, k, v, g)) <= 1.0


def test_short_backward_counts_one_launch_per_call_by_design(cuda):
    """Each call of kernel 7's entry adds one to ``bwd_launches`` and one to
    the count of the design it ran; the mma.sync wrapper counts none;
    ``reset_launches`` sets the per-design counts to 0."""
    for shape, design in (((2, 197, 3, 64), "wgmma"), ((4, 32, 3, 64), "mma.sync")):
        q, k, v, g = _short_inputs(shape, torch.bfloat16, cuda, seed=15)
        before, by_design = sa.bwd_launches, dict(sa.bwd_design_launches)
        sa.short_attention_bwd_cuda(q, k, v, g)
        assert sa.bwd_launches == before + 1
        assert {x: sa.bwd_design_launches[x] - by_design[x] for x in sa.DESIGNS} == {
            x: int(x == design) for x in sa.DESIGNS}, shape
        sa.short_attention_bwd_mma_cuda(q, k, v, g)
        assert sa.bwd_launches == before + 1 and sa.bwd_design_launches[design] == \
            by_design[design] + 1
    sa.reset_launches()
    assert sa.bwd_launches == 0 and set(sa.bwd_design_launches.values()) == {0}


def test_short_backward_wgmma_launch_error_raises(cuda, monkeypatch):
    """No fallback: when the wgmma design cannot launch (here a sequence
    stride of 68 elements, which TMA refuses, reaching the C entry because
    the layout step is bypassed) the wrapper raises with the CUDA error and
    counts no launch; it does not run the mma.sync design instead."""
    b, n, h, d = 2, 197, 1, 64
    base = torch.zeros((4, b, n, h, 68), dtype=torch.bfloat16, device=cuda)
    q, k, v, g = (x[..., :d] for x in base.unbind(0))
    monkeypatch.setattr(sa, "_prepare", lambda x, d_pad: x)
    before, by_design = sa.bwd_launches, dict(sa.bwd_design_launches)
    with pytest.raises(RuntimeError, match="short_attention_bwd launch failed: cudaError"):
        sa.short_attention_bwd_cuda(q, k, v, g)
    assert sa.last_designs()[1] == "wgmma"
    assert sa.bwd_launches == before and sa.bwd_design_launches == by_design


# -- kernels 6-7's f32 design (wgmma.tf32x3: 3xTF32, 64 < N <= 256, D <= 64) --
SHORT_TF32_NS = [65, 128, 129, 192, 197, 200, 256]


def _short_views(shape, layout, device, seed, dtype=torch.float32):
    """q, k, v as views of a fused (B, N, 3, H, D) qkv or as (B, H, N, D)
    tensors transposed to (B, N, H, D), and an output gradient g."""
    b, n, h, d = shape
    rng = np.random.default_rng(seed)
    if layout == "fused":
        x = torch.from_numpy(rng.standard_normal((b, n, 3, h, d), dtype=np.float32))
        q, k, v = x.to(device, dtype).unbind(2)
    else:
        q, k, v = (torch.from_numpy(rng.standard_normal((b, h, n, d), dtype=np.float32))
                   .to(device, dtype).transpose(1, 2) for _ in range(3))
    g = torch.from_numpy(rng.standard_normal((b, n, h, d), dtype=np.float32)).to(device, dtype)
    return q, k, v, g


@pytest.mark.parametrize("layout", ["fused", "bhnd"])
@pytest.mark.parametrize("d", [32, 40, 64])
@pytest.mark.parametrize("n", SHORT_TF32_NS)
def test_short_tf32_edges_match_plain_and_repeat(cuda, n, d, layout):
    """f32 at the wgmma.tf32x3 design's edges (N = 65 .. 256, D = 32, 40
    padded to 40, 64), on fused-qkv and transposed views: both entries run
    it (``design_takes`` names it), give bitwise the same o, dq, dk, dv on a
    second call and stay within the f32 limits (1e-4 on o, F32_REL·A + 1e-6
    on the gradients); the ``_mma`` entries run the FMA kernels, within the
    same limits."""
    shape = (2, n, 3, d)
    q, k, v, g = _short_views(shape, layout, cuda, seed=n + d)
    assert sa.design_takes(0, n, d, torch.float32) == "wgmma.tf32x3"
    assert sa.design_takes(1, n, d, torch.float32) == "wgmma.tf32x3"
    runs = [(sa.short_attention_fwd_cuda(q, k, v), *sa.short_attention_bwd_cuda(q, k, v, g))
            for _ in range(2)]
    torch.cuda.synchronize()
    assert sa.last_designs() == ("wgmma.tf32x3", "wgmma.tf32x3")
    for name, a, b in zip(("o", "dq", "dk", "dv"), *runs):
        assert torch.equal(a, b), name
    ref = sa.short_attention_plain(q, k, v)
    refs = sa.short_attention_plain_bwd(q, k, v, g)
    limits = sa.backward_error_limit(q, k, v, g, refs)
    old = (sa.short_attention_fwd_mma_cuda(q, k, v), *sa.short_attention_bwd_mma_cuda(q, k, v, g))
    torch.cuda.synchronize()
    assert sa.last_designs() == ("fma", "fma")
    for got in (runs[0], old):
        assert (got[0] - ref).abs().max().item() <= 1e-4
        uses = [((x - r).abs() / lim).max().item() for x, r, lim in zip(got[1:], refs, limits)]
        assert max(uses) <= 1.0, uses


def test_short_tf32_gradients_through_autograd_match_plain(cuda):
    """f32 q, k, v as views of a fused qkv through autograd
    (``ShortAttentionFn``) at TimeSformer's spatial N = 197: kernels 6 and 7
    run once each, both on wgmma.tf32x3 (counted by design), and the
    gradients of the fused tensor hold ``backward_error_limit``."""
    rng = np.random.default_rng(31)
    qkv = torch.from_numpy(rng.standard_normal((4, 197, 3, 4, 64), dtype=np.float32))
    qkv = qkv.to(cuda).requires_grad_()
    g = torch.from_numpy(rng.standard_normal((4, 197, 4, 64), dtype=np.float32)).to(cuda)
    fwd_before, bwd_before = dict(sa.fwd_design_launches), dict(sa.bwd_design_launches)
    out = sa.short_attention(*qkv.unbind(2))
    (out * g).sum().backward()
    torch.cuda.synchronize()
    for counts, before in ((sa.fwd_design_launches, fwd_before),
                           (sa.bwd_design_launches, bwd_before)):
        assert {x: counts[x] - before[x] for x in sa.DESIGNS} == {
            x: int(x == "wgmma.tf32x3") for x in sa.DESIGNS}
    q, k, v = (x.detach() for x in qkv.unbind(2))
    assert (out.detach() - sa.short_attention_plain(q, k, v)).abs().max().item() <= 1e-4
    refs = sa.short_attention_plain_bwd(q, k, v, g)
    uses = [((x - r).abs() / lim).max().item() for x, r, lim in
            zip(qkv.grad.unbind(2), refs, sa.backward_error_limit(q, k, v, g, refs))]
    assert max(uses) <= 1.0, uses


def test_short_tf32_counts_one_launch_per_call_by_design(cuda):
    """Each call of either entry in f32 adds one launch, counted under the
    design it ran: wgmma.tf32x3 at N = 197, mma.tf32x3 at the temporal
    N = 32, fma at N = 32 with D = 72; the _mma entries count none."""
    for shape, design in (((2, 197, 3, 64), "wgmma.tf32x3"), ((4, 32, 3, 64), "mma.tf32x3"),
                          ((4, 32, 3, 72), "fma")):
        q, k, v, g = _short_inputs(shape, torch.float32, cuda, seed=32)
        for _ in range(2):
            before = (sa.launch_counts(), dict(sa.fwd_design_launches),
                      dict(sa.bwd_design_launches))
            sa.short_attention_fwd_cuda(q, k, v)
            sa.short_attention_bwd_cuda(q, k, v, g)
            sa.short_attention_fwd_mma_cuda(q, k, v)
            sa.short_attention_bwd_mma_cuda(q, k, v, g)
            torch.cuda.synchronize()
            after = (sa.launch_counts(), sa.fwd_design_launches, sa.bwd_design_launches)
            assert {x: after[0][x] - before[0][x] for x in after[0]} == {
                "short_attention_fwd": 1, "short_attention_bwd": 1}, shape
            for a, b in zip(after[1:], before[1:]):
                assert {x: a[x] - b[x] for x in sa.DESIGNS} == {
                    x: int(x == design) for x in sa.DESIGNS}, shape


def test_short_design_mirror_matches_the_c_choice(cuda):
    """``design_takes`` names the design the C side picks
    (``short_attention_design``) for both kernels in both dtypes, across the
    tensor-core designs' edges (mma.tf32x3 at N <= 64, the wgmma ones
    above), D > 64 and a broadcast stride of 0."""
    for dtype in (torch.float32, torch.bfloat16):
        for n, d, layout in ((64, 64, "fused"), (65, 64, "fused"), (197, 64, "bhnd"),
                             (197, 40, "fused"), (197, 72, "fused"), (197, 128, "fused"),
                             (256, 32, "bhnd"), (257, 64, "fused"), (32, 64, "fused"),
                             (197, 64, "expand"), (1, 16, "fused"), (33, 40, "bhnd"),
                             (64, 64, "bhnd"), (32, 72, "fused"), (32, 64, "expand")):
            q, k, v, g = _short_views((2, n, 3, d), "bhnd" if layout == "bhnd" else "fused",
                                      cuda, seed=33, dtype=dtype)
            if layout == "expand":
                q, k, v = (x[:1].expand(2, n, 3, d) for x in (q, k, v))
            d_pad = -(-d // 8) * 8
            ins = [sa._prepare(x, d_pad) for x in (q, k, v, g)]
            outs = [torch.empty((2, n, 3, d_pad), dtype=dtype, device=cuda) for _ in range(3)]
            for which, tensors in ((0, ins[:3] + outs[:1]), (1, ins + outs)):
                strides = sa._strides(*tensors)
                assert sa.c_design(which, dtype, n, d_pad, strides) == sa.design_takes(
                    which, n, d, dtype, strides), (which, dtype, n, d, layout)
                assert sa.c_design(which, dtype, n, d_pad, strides, mma_only=True) == (
                    "fma" if dtype == torch.float32 else "mma.sync")


def test_short_tf32_launch_error_raises_and_runs_no_other_design(cuda, monkeypatch):
    """No fallback: when the wgmma.tf32x3 design cannot launch (here a
    sequence stride of 66 floats, 264 bytes, which TMA refuses, reaching the
    C entries because the layout step is bypassed) both wrappers raise with
    the CUDA error and count no launch; they do not run the FMA design
    instead."""
    b, n, h, d = 2, 197, 1, 64
    base = torch.zeros((4, b, n, h, 66), dtype=torch.float32, device=cuda)
    q, k, v, g = (x[..., :d] for x in base.unbind(0))
    monkeypatch.setattr(sa, "_prepare", lambda x, d_pad: x)
    before = (sa.launch_counts(), dict(sa.fwd_design_launches), dict(sa.bwd_design_launches))
    with pytest.raises(RuntimeError, match="short_attention_fwd launch failed: cudaError"):
        sa.short_attention_fwd_cuda(q, k, v)
    assert sa.last_designs()[0] == "wgmma.tf32x3"
    with pytest.raises(RuntimeError, match="short_attention_bwd launch failed: cudaError"):
        sa.short_attention_bwd_cuda(q, k, v, g)
    assert sa.last_designs()[1] == "wgmma.tf32x3"
    assert (sa.launch_counts(), sa.fwd_design_launches, sa.bwd_design_launches) == before


# -- kernels 6-7's f32 design at short sequences (mma.tf32x3: 3xTF32 on mma.sync,
# N <= 64, D <= 64) --
SHORT_MMA_TF32_NS = [1, 2, 7, 8, 16, 31, 32, 33, 63, 64]


@pytest.mark.parametrize("layout", ["fused", "bhnd"])
@pytest.mark.parametrize("d", [16, 32, 40, 64])
@pytest.mark.parametrize("n", SHORT_MMA_TF32_NS)
def test_short_mma_tf32_edges_match_plain_and_repeat(cuda, n, d, layout):
    """f32 at the mma.tf32x3 design's edges (N = 1 .. 64 across its 16-row
    tiles, D = 16, 32, 40 padded to 40, 64), on fused-qkv and transposed
    views: both entries run it (``design_takes`` names it), give bitwise the
    same o, dq, dk, dv on a second call and stay within the f32 limits (1e-4
    on o, ``backward_error_limit`` on the gradients); the ``_mma`` entries
    run the FMA kernels, within the same limits."""
    shape = (3, n, 5, d)
    q, k, v, g = _short_views(shape, layout, cuda, seed=100 + n + d)
    assert sa.design_takes(0, n, d, torch.float32) == "mma.tf32x3"
    assert sa.design_takes(1, n, d, torch.float32) == "mma.tf32x3"
    runs = [(sa.short_attention_fwd_cuda(q, k, v), *sa.short_attention_bwd_cuda(q, k, v, g))
            for _ in range(2)]
    torch.cuda.synchronize()
    assert sa.last_designs() == ("mma.tf32x3", "mma.tf32x3")
    for name, a, b in zip(("o", "dq", "dk", "dv"), *runs):
        assert torch.equal(a, b), name
    ref = sa.short_attention_plain(q, k, v)
    refs = sa.short_attention_plain_bwd(q, k, v, g)
    limits = sa.backward_error_limit(q, k, v, g, refs)
    old = (sa.short_attention_fwd_mma_cuda(q, k, v), *sa.short_attention_bwd_mma_cuda(q, k, v, g))
    torch.cuda.synchronize()
    assert sa.last_designs() == ("fma", "fma")
    for got in (runs[0], old):
        assert (got[0] - ref).abs().max().item() <= 1e-4
        uses = [((x - r).abs() / lim).max().item() for x, r, lim in zip(got[1:], refs, limits)]
        assert max(uses) <= 1.0, uses


def test_short_mma_tf32_temporal_shape_matches_plain_and_repeats(cuda):
    """TimeSformer-B's temporal call at B = 8, (1568, 32, 12, 64) on views of
    a fused qkv: mma.tf32x3 holds the f32 limits against the plain twins
    and repeats bitwise (a block owns each pair; no sum uses atomics)."""
    q, k, v, g = _short_views((1568, 32, 12, 64), "fused", cuda, seed=41)
    runs = [(sa.short_attention_fwd_cuda(q, k, v), *sa.short_attention_bwd_cuda(q, k, v, g))
            for _ in range(2)]
    torch.cuda.synchronize()
    assert sa.last_designs() == ("mma.tf32x3", "mma.tf32x3")
    for name, a, b in zip(("o", "dq", "dk", "dv"), *runs):
        assert torch.equal(a, b), name
    assert (runs[0][0] - sa.short_attention_plain(q, k, v)).abs().max().item() <= 1e-4
    refs = sa.short_attention_plain_bwd(q, k, v, g)
    uses = [((x - r).abs() / lim).max().item() for x, r, lim in
            zip(runs[0][1:], refs, sa.backward_error_limit(q, k, v, g, refs))]
    assert max(uses) <= 1.0, uses


def test_short_mma_tf32_gradients_through_autograd_match_plain(cuda):
    """f32 q, k, v as views of a fused qkv through autograd
    (``ShortAttentionFn``) at TimeSformer's temporal N = 32: kernels 6 and 7
    run once each, both on mma.tf32x3 (counted by design), and the
    gradients of the fused tensor hold ``backward_error_limit``."""
    rng = np.random.default_rng(42)
    qkv = torch.from_numpy(rng.standard_normal((24, 32, 3, 4, 64), dtype=np.float32))
    qkv = qkv.to(cuda).requires_grad_()
    g = torch.from_numpy(rng.standard_normal((24, 32, 4, 64), dtype=np.float32)).to(cuda)
    fwd_before, bwd_before = dict(sa.fwd_design_launches), dict(sa.bwd_design_launches)
    out = sa.short_attention(*qkv.unbind(2))
    (out * g).sum().backward()
    torch.cuda.synchronize()
    for counts, before in ((sa.fwd_design_launches, fwd_before),
                           (sa.bwd_design_launches, bwd_before)):
        assert {x: counts[x] - before[x] for x in sa.DESIGNS} == {
            x: int(x == "mma.tf32x3") for x in sa.DESIGNS}
    q, k, v = (x.detach() for x in qkv.unbind(2))
    assert (out.detach() - sa.short_attention_plain(q, k, v)).abs().max().item() <= 1e-4
    refs = sa.short_attention_plain_bwd(q, k, v, g)
    uses = [((x - r).abs() / lim).max().item() for x, r, lim in
            zip(qkv.grad.unbind(2), refs, sa.backward_error_limit(q, k, v, g, refs))]
    assert max(uses) <= 1.0, uses


def test_short_mma_tf32_launch_error_raises_and_runs_no_other_design(cuda, monkeypatch):
    """No fallback: when the mma.tf32x3 design cannot launch (a sequence
    stride of 66 floats, 264 bytes, which TMA refuses, reaching the C
    entries because the layout step is bypassed) both wrappers raise with
    the CUDA error and count no launch; they do not run the FMA design
    instead."""
    b, n, h, d = 2, 32, 1, 64
    base = torch.zeros((4, b, n, h, 66), dtype=torch.float32, device=cuda)
    q, k, v, g = (x[..., :d] for x in base.unbind(0))
    monkeypatch.setattr(sa, "_prepare", lambda x, d_pad: x)
    before = (sa.launch_counts(), dict(sa.fwd_design_launches), dict(sa.bwd_design_launches))
    with pytest.raises(RuntimeError, match="short_attention_fwd launch failed: cudaError"):
        sa.short_attention_fwd_cuda(q, k, v)
    assert sa.last_designs()[0] == "mma.tf32x3"
    with pytest.raises(RuntimeError, match="short_attention_bwd launch failed: cudaError"):
        sa.short_attention_bwd_cuda(q, k, v, g)
    assert sa.last_designs()[1] == "mma.tf32x3"
    assert (sa.launch_counts(), sa.fwd_design_launches, sa.bwd_design_launches) == before


def _tiny_timesformer(dtype):
    from laryngeal_tpu_torch.models.timesformer import create_timesformer

    return create_timesformer(num_frames=8, image_size=64, hidden_size=64, num_layers=2,
                              num_heads=4, intermediate_size=128, dtype=dtype, seed=0)


@pytest.mark.parametrize("dtype,atol", [(torch.float32, 1e-4), (torch.bfloat16, 3e-2)])
def test_timesformer_kernel_matches_plain_attention(cuda, dtype, atol):
    """Each layer launches kernel 6 twice (temporal, spatial) and kernel 1
    never; the logits agree with the same model on the plain attention."""
    from laryngeal_tpu_torch.ops import attention as att

    model = _tiny_timesformer(dtype).to(cuda)
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (2, 8, 64, 64, 3), dtype=np.float32)).to(cuda)
    with torch.inference_mode():
        before, before_fa = sa.fwd_launches, fa.launches
        out = model(x)
        assert (sa.fwd_launches - before, fa.launches - before_fa) == (4, 0)
        att.set_attention_impl("plain")
        try:
            ref = model(x)
        finally:
            att.set_attention_impl(None)
    assert out.dtype == torch.float32
    err = (out - ref).abs().max().item()
    assert err <= atol, err


def test_timesformer_train_step_on_card_matches_cpu(cuda):
    """A tiny TimeSformer train step on the card: 4 launches each of kernels
    6 and 7 and none of kernels 1-4 (2 layers, 2 attention calls each); the
    eval step launches kernel 6 four times. Loss and updated weights agree
    with the same step on the CPU (f32)."""
    from laryngeal_tpu_torch.train.state import create_train_state
    from laryngeal_tpu_torch.train.steps import make_eval_step, make_train_step

    rng = np.random.default_rng(5)
    pix = torch.from_numpy(rng.integers(0, 256, (2, 8, 64, 64, 3), dtype=np.uint8))
    labels, mask = torch.tensor([0, 1]), torch.tensor([True, True])
    counts = lambda: {**fa.launch_counts(), **sa.launch_counts()}
    results = {}
    for dev in ("cpu", cuda):
        model = _tiny_timesformer(torch.float32).to(dev)
        state = create_train_state(model, "adamw", 1e-3, 0.01)
        step = make_train_step(model, "timesformer", "ce", crop=64)
        before = counts()
        state, m = step(state, pix.to(dev), labels.to(dev), mask.to(dev))
        if dev == cuda:
            torch.cuda.synchronize()
            after = counts()
            assert {k: after[k] - before[k] for k in after} == {
                "flash_attention_fwd": 0, "flash_attention_fwd_lse": 0,
                "flash_attention_bwd_dq": 0, "flash_attention_bwd_dkv": 0,
                "flash_attention_fwd_bias": 0,
                "short_attention_fwd": 4, "short_attention_bwd": 4}
            before = after
            make_eval_step(model, "timesformer", "ce", crop=64)(
                state, pix.to(dev), labels.to(dev), mask.to(dev))
            torch.cuda.synchronize()
            after = counts()
            assert after["short_attention_fwd"] - before["short_attention_fwd"] == 4
            assert after["short_attention_bwd"] == before["short_attention_bwd"]
        results[str(dev)] = (m["loss"].item(), {n: p.detach().cpu() for n, p in
                                                model.state_dict().items()})
    (loss_c, w_c), (loss_g, w_g) = results["cpu"], results[str(cuda)]
    assert abs(loss_c - loss_g) <= 1e-4 * max(1.0, abs(loss_c))
    hidden = 64
    for n, w in w_c.items():
        if n.endswith("attention.attention.qkv.bias"):
            # The key slice's gradient is round-off (softmax is shift-invariant).
            keep = torch.ones_like(w, dtype=torch.bool)
            keep[hidden:2 * hidden] = False
            w, wg = w[keep], w_g[n][keep]
        else:
            wg = w_g[n]
        assert ((wg - w).norm() / w.norm()).item() <= 1e-4, n


# -- kernels 8-9, 11-12: shifted-window attention (Swin3D) -----------------
# (B·nW, N, H, D, nW): nW = None is an unshifted block (no region ids). The
# Swin3D-T stage shapes at small batch, then N in 1..448 (multiples of 8 or
# not, clamped and padded windows), D in 16..128, a single-window region id.
WINDOW_SHAPES = [
    (4, 392, 3, 32, 2),
    (4, 392, 3, 32, None),
    (2, 392, 24, 32, 2),
    (1, 1, 2, 16, None),
    (3, 7, 2, 32, 3),
    (2, 49, 5, 40, 1),      # D padded to 48 inside the wrapper
    (4, 100, 3, 64, 2),
    (2, 196, 2, 128, None),
    (8, 245, 3, 32, 4),
    (2, 333, 2, 64, 1),
    (1, 448, 1, 32, 1),
    (2, 392, 2, 128, 2),
]


def _window_inputs(shape, dtype, device, seed=0):
    bw, n, h, d, nw = shape
    rng = np.random.default_rng(seed)
    q, k, v, g = (torch.from_numpy(rng.standard_normal((bw, n, h, d), dtype=np.float32))
                  .to(device=device, dtype=dtype) for _ in range(4))
    bias = torch.from_numpy(rng.standard_normal((h, n, n), dtype=np.float32)).to(device)
    rid = None if nw is None else torch.from_numpy(
        rng.integers(0, 4, (nw, n)).astype(np.int32)).to(device)
    return q, k, v, bias, rid, g


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", WINDOW_SHAPES, ids=str)
def test_window_forward_kernel_matches_plain(cuda, shape, dtype):
    q, k, v, bias, rid, _ = _window_inputs(shape, dtype, cuda)
    before = wa.fwd_launches
    out = wa.window_attention_forward(q, k, v, bias, rid)
    torch.cuda.synchronize()
    assert wa.fwd_launches == before + 1
    assert out.dtype == dtype and out.shape == q.shape
    ref = wa.window_attention_plain(q, k, v, bias, rid)
    use = ((out.float() - ref.float()).abs()
           / wa.error_limit(q, k, v, bias, rid, ref)).max().item()
    assert use <= 1.0, use


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", WINDOW_SHAPES, ids=str)
def test_window_backward_kernel_matches_plain(cuda, shape, dtype):
    q, k, v, bias, rid, g = _window_inputs(shape, dtype, cuda, seed=1)
    before = wa.bwd_launches
    grads = wa.window_attention_backward(q, k, v, bias, rid, g)
    torch.cuda.synchronize()
    assert wa.bwd_launches == before + 1
    refs = wa.window_attention_plain_bwd(q, k, v, bias, rid, g)
    limits = wa.backward_error_limit(q, k, v, bias, rid, g, refs)
    for name, got, ref, lim in zip(("dq", "dk", "dv", "dbias"), grads, refs, limits):
        assert got.dtype == ref.dtype and got.shape == ref.shape, name
        use = ((got.float() - ref.float()).abs() / lim).max().item()
        assert use <= 1.0, (name, use)


@pytest.mark.parametrize("kind", wa.VARIANTS)
@pytest.mark.parametrize("shape", [(4, 392, 3, 32, 2), (2, 392, 6, 32, None),
                                   (2, 392, 12, 32, 2), (2, 392, 24, 32, 1),
                                   (3, 77, 5, 64, 3), (2, 30, 9, 16, None)], ids=str)
def test_window_variant_kernels_match_plain(cuda, shape, kind):
    q, k, v, bias, rid, _ = _window_inputs(shape, torch.bfloat16, cuda, seed=2)
    before = dict(wa.variant_launches)
    out = wa.window_attention_variant(q, k, v, bias, rid, kind)
    torch.cuda.synchronize()
    assert wa.variant_launches[kind] == before[kind] + 1
    ref = wa.window_attention_plain(q, k, v, bias, rid, kind)
    use = ((out.float() - ref.float()).abs()
           / wa.error_limit(q, k, v, bias, rid, ref, kind)).max().item()
    assert use <= 1.0, use


def test_window_kernels_read_strided_views_and_carry_gradients(cuda):
    """q/k/v as views of one fused (B·nW, N, 3, H, D) qkv, as Swin3D gives
    them; under autograd the router runs kernel 8 then kernel 9, and the
    fused tensor and the bias get the plain backward's gradients."""
    from laryngeal_tpu_torch.ops import attention as att

    rng = np.random.default_rng(3)
    qkv = torch.from_numpy(rng.standard_normal((8, 392, 3, 3, 32), dtype=np.float32))
    qkv = qkv.to(cuda, torch.bfloat16).requires_grad_()
    bias = torch.from_numpy(rng.standard_normal((3, 392, 392), dtype=np.float32)).to(cuda)
    bias.requires_grad_()
    rid = torch.from_numpy(rng.integers(0, 3, (4, 392)).astype(np.int32)).to(cuda)
    g = torch.from_numpy(rng.standard_normal((8, 392, 3, 32), dtype=np.float32)).to(
        cuda, torch.bfloat16)
    before = wa.launch_counts()
    out = att.window_attention(*qkv.unbind(2), bias, rid)
    (out.float() * g.float()).sum().backward()
    torch.cuda.synchronize()
    after = wa.launch_counts()
    assert {n: after[n] - before[n] for n in after} == {
        "window_attention_fwd": 1, "window_attention_bwd": 1, "window_attention_fwd_bf16sm": 0,
        "window_attention_fwd_exp2": 0, "window_attention_fwd_h2": 0}
    q, k, v = (x.detach() for x in qkv.unbind(2))
    b = bias.detach()
    ref = wa.window_attention_plain(q, k, v, b, rid)
    assert ((out.float() - ref.float()).abs()
            / wa.error_limit(q, k, v, b, rid, ref)).max() <= 1.0
    refs = wa.window_attention_plain_bwd(q, k, v, b, rid, g)
    limits = wa.backward_error_limit(q, k, v, b, rid, g, refs)
    for got, ref_g, lim in zip((*qkv.grad.unbind(2), bias.grad), refs, limits):
        assert ((got.float() - ref_g.float()).abs() / lim).max() <= 1.0


def test_window_router_and_bad_input(cuda):
    """The router's kernel impl launches kernel 8 on CUDA at every N up to
    448. Beyond it at N % 8 != 0 (449) the JAX package takes XLA and so does
    the router (the rounded bias, no launch); at D = 136, N = 8, JAX runs
    its Pallas kernel and so does the router (kernel 8's wide path). The
    kernels refuse float16 and D > 256, and the variants refuse f32, D > 64
    and N > 448."""
    from laryngeal_tpu_torch.ops import attention as att

    q, k, v, bias, rid, _ = _window_inputs((2, 7, 2, 32, 1), torch.bfloat16, cuda)
    before = wa.fwd_launches
    att.window_attention(q, k, v, bias, rid)
    torch.cuda.synchronize()
    assert wa.fwd_launches == before + 1
    q, k, v, bias, rid, _ = _window_inputs((1, 449, 1, 32, None), torch.bfloat16, cuda)
    before = wa.launch_counts()
    out = att.window_attention(q, k, v, bias, rid)
    assert wa.launch_counts() == before
    assert torch.equal(out, wa.window_attention_xla(q, k, v, bias, rid))
    with pytest.raises(ValueError):
        wa.window_attention_kernel(q, k, v, bias, rid)
    q, k, v, bias, rid, _ = _window_inputs((1, 8, 1, 16, None), torch.float16, cuda)
    with pytest.raises(ValueError):
        wa.window_attention_forward(q, k, v, bias, rid)
    q, k, v, bias, rid, _ = _window_inputs((1, 8, 1, 136, None), torch.bfloat16, cuda)
    before = wa.fwd_launches
    out = att.window_attention(q, k, v, bias, rid)
    torch.cuda.synchronize()
    assert wa.fwd_launches == before + 1 and wa.last_designs()[0] == "wide"
    ref = wa.window_attention_plain(q, k, v, bias, rid)
    assert ((out.float() - ref.float()).abs() / wa.error_limit(q, k, v, bias, rid, ref)).max() <= 1
    q, k, v, bias, rid, _ = _window_inputs((1, 8, 1, 264, None), torch.bfloat16, cuda)
    with pytest.raises(ValueError):
        wa.window_attention_forward(q, k, v, bias, rid)
    q, k, v, bias, rid, _ = _window_inputs((1, 8, 2, 32, None), torch.float32, cuda)
    with pytest.raises(ValueError):
        wa.window_attention_variant(q, k, v, bias, rid, "h2")
    q, k, v, bias, rid, _ = _window_inputs((1, 8, 2, 128, None), torch.bfloat16, cuda)
    with pytest.raises(ValueError):
        wa.window_attention_variant(q, k, v, bias, rid, "exp2")
    q, k, v, bias, rid, _ = _window_inputs((1, 456, 1, 32, None), torch.bfloat16, cuda)
    with pytest.raises(ValueError):
        wa.window_attention_variant(q, k, v, bias, rid, "bf16sm")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(2, 456, 1, 32, 2), (2, 453, 1, 32, 1), (4, 64, 2, 160, 2)],
                         ids=str)
def test_window_router_outside_the_kernels_domain_follows_jax(cuda, shape, dtype):
    """Outside the held designs' domain (N <= 448, D <= 128), where the JAX
    package takes XLA (N % 8 != 0: 453) the router computes
    window_attention_xla (the bias rounded to q's dtype) on the card with no
    launch; where JAX runs its Pallas kernel (N % 8 == 0, D <= 256: 456, and
    64 at D = 160) the router launches kernel 8 (its wide path), held
    against its plain twin."""
    from laryngeal_tpu_torch.ops import attention as att

    q, k, v, bias, rid, _ = _window_inputs(shape, dtype, cuda)
    _, n, _, d, _ = shape
    before = wa.launch_counts()
    out = att.window_attention(q, k, v, bias, rid)
    torch.cuda.synchronize()
    assert out.dtype == dtype and out.shape == q.shape
    after = wa.launch_counts()
    if wa.jax_takes_pallas(n, d):
        assert after["window_attention_fwd"] == before["window_attention_fwd"] + 1
        assert wa.last_designs()[0] == "wide"
        ref = wa.window_attention_plain(q, k, v, bias, rid)
        limit = wa.error_limit(q, k, v, bias, rid, ref)
        assert ((out.float() - ref.float()).abs() / limit).max().item() <= 1.0
    else:
        assert after == before
        assert torch.equal(out, wa.window_attention_xla(q, k, v, bias, rid))


# The wide path of kernels 8-9 (B·nW, N, H, D, nW): N % 8 == 0 beyond 448,
# and 128 < D <= 256 (150 padded to 152 inside the wrapper), with and without
# region ids.
WIDE_WINDOW_SHAPES = [
    (4, 512, 3, 32, 2),
    (2, 784, 2, 32, None),
    (2, 392, 2, 192, 2),
    (2, 392, 1, 256, None),
    (3, 520, 2, 64, 3),
    (2, 96, 3, 150, 1),
    (1, 1024, 1, 128, None),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", WIDE_WINDOW_SHAPES, ids=str)
def test_window_wide_path_matches_plain(cuda, shape, dtype):
    """Kernels 8 and 9 at shapes only JAX's Pallas kernel took before: the
    wide path runs (the C side says so), one launch each, forward and every
    gradient (dbias summed over the windows) within their limits."""
    q, k, v, bias, rid, g = _window_inputs(shape, dtype, cuda, seed=5)
    before = wa.launch_counts()
    out = wa.window_attention_forward(q, k, v, bias, rid)
    grads = wa.window_attention_backward(q, k, v, bias, rid, g)
    torch.cuda.synchronize()
    after = wa.launch_counts()
    assert after["window_attention_fwd"] == before["window_attention_fwd"] + 1
    assert after["window_attention_bwd"] == before["window_attention_bwd"] + 1
    assert wa.last_designs() == ("wide", "wide")
    ref = wa.window_attention_plain(q, k, v, bias, rid)
    assert ((out.float() - ref.float()).abs()
            / wa.error_limit(q, k, v, bias, rid, ref)).max().item() <= 1.0
    refs = wa.window_attention_plain_bwd(q, k, v, bias, rid, g)
    limits = wa.backward_error_limit(q, k, v, bias, rid, g, refs)
    for name, got, ref_g, lim in zip(("dq", "dk", "dv", "dbias"), grads, refs, limits):
        assert got.dtype == ref_g.dtype and got.shape == ref_g.shape, name
        assert ((got.float() - ref_g.float()).abs() / lim).max().item() <= 1.0, name


def test_window_wide_path_is_deterministic_and_reads_views(cuda):
    """The wide path gives bitwise the same results over two calls, and on
    views of a fused (B·nW, N, 3, H, D) qkv the bits of contiguous copies."""
    rng = np.random.default_rng(6)
    qkv = torch.from_numpy(rng.standard_normal((4, 512, 3, 2, 32), dtype=np.float32))
    q, k, v = qkv.to(cuda, torch.bfloat16).unbind(2)
    g = torch.from_numpy(rng.standard_normal(q.shape, dtype=np.float32)).to(cuda, torch.bfloat16)
    bias = torch.from_numpy(rng.standard_normal((2, 512, 512), dtype=np.float32)).to(cuda)
    rid = torch.from_numpy(rng.integers(0, 3, (2, 512)).astype(np.int32)).to(cuda)
    runs = [(wa.window_attention_forward(*xs, bias, rid),
             *wa.window_attention_backward(*xs, bias, rid, g))
            for xs in ((q, k, v), (q, k, v), tuple(x.contiguous() for x in (q, k, v)))]
    torch.cuda.synchronize()
    for i, name in enumerate(("o", "dq", "dk", "dv", "dbias")):
        assert torch.equal(runs[0][i], runs[1][i]) and torch.equal(runs[0][i], runs[2][i]), name


def _tiny_swin(dtype, stochastic_depth=0.0):
    from laryngeal_tpu_torch.models.swin3d import create_swin3d

    return create_swin3d("tiny", embed_dim=32, depths=(2, 2), num_heads=(2, 4),
                         window=(4, 7, 7), stochastic_depth=stochastic_depth, dtype=dtype,
                         seed=0)


@pytest.mark.parametrize("dtype,atol", [(torch.float32, 1e-4), (torch.bfloat16, 3e-2)])
def test_swin3d_kernel_matches_plain_attention_and_cpu(cuda, dtype, atol):
    """A tiny Swin3D (windows of 4x7x7 = 196, padded and shifted; stage 2
    clamps to 4x7x7 of a 4x7x7 grid): each block launches kernel 8 once and
    no other kernel; the logits agree with the same model on the plain
    attention, and in f32 with the model on the CPU."""
    from laryngeal_tpu_torch.ops import attention as att

    model = _tiny_swin(dtype).to(cuda)
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (2, 8, 52, 56, 3), dtype=np.float32))
    counts = lambda: {**fa.launch_counts(), **sa.launch_counts(), **wa.launch_counts()}
    with torch.inference_mode():
        before = counts()
        out = model(x.to(cuda))
        torch.cuda.synchronize()
        after = counts()
        assert {k: after[k] - before[k] for k in after if after[k] != before[k]} == {
            "window_attention_fwd": 4}
        att.set_attention_impl("plain")
        try:
            ref = model(x.to(cuda))
        finally:
            att.set_attention_impl(None)
        cpu = _tiny_swin(dtype)(x) if dtype == torch.float32 else None
    assert out.dtype == torch.float32
    assert (out - ref).abs().max().item() <= atol
    if cpu is not None:
        assert (out.cpu() - cpu).abs().max().item() <= atol


def test_swin3d_train_step_on_card_matches_cpu(cuda, monkeypatch):
    """A tiny Swin3D train step on the card (LARYNGEAL_NO_AUGMENT=1,
    stochastic depth 0): 4 launches each of kernels 8 and 9 and none of any
    other kernel; the eval step launches kernel 8 four times. Loss and
    updated weights (the relative-position tables included) agree with the
    same step on the CPU (f32)."""
    from laryngeal_tpu_torch.train.state import create_train_state
    from laryngeal_tpu_torch.train.steps import make_eval_step, make_train_step

    monkeypatch.setenv("LARYNGEAL_NO_AUGMENT", "1")
    rng = np.random.default_rng(5)
    pix = torch.from_numpy(rng.integers(0, 256, (2, 8, 60, 64, 3), dtype=np.uint8))
    labels, mask = torch.tensor([0, 1]), torch.tensor([True, True])
    counts = lambda: {**fa.launch_counts(), **sa.launch_counts(), **wa.launch_counts()}
    results = {}
    for dev in ("cpu", cuda):
        model = _tiny_swin(torch.float32).to(dev)
        state = create_train_state(model, "adamw", 1e-3, 0.05)
        step = make_train_step(model, "pytorchvideo", "ce", crop=56)
        before = counts()
        state, m = step(state, pix.to(dev), labels.to(dev), mask.to(dev))
        if dev == cuda:
            torch.cuda.synchronize()
            after = counts()
            assert {k: after[k] - before[k] for k in after if after[k] != before[k]} == {
                "window_attention_fwd": 4, "window_attention_bwd": 4}
            before = after
            make_eval_step(model, "pytorchvideo", "ce", crop=56)(
                state, pix.to(dev), labels.to(dev), mask.to(dev))
            torch.cuda.synchronize()
            after = counts()
            assert {k: after[k] - before[k] for k in after if after[k] != before[k]} == {
                "window_attention_fwd": 4}
        results[str(dev)] = (m["loss"].item(), {n: p.detach().cpu() for n, p in
                                                model.state_dict().items()})
    (loss_c, w_c), (loss_g, w_g) = results["cpu"], results[str(cuda)]
    assert abs(loss_c - loss_g) <= 1e-4 * max(1.0, abs(loss_c))
    for n, w in w_c.items():
        wg = w_g[n]
        if n.endswith("attn.qkv.bias"):
            # The key slice's gradient is round-off (softmax is shift-invariant).
            keep = torch.ones_like(w, dtype=torch.bool)
            keep[w.shape[0] // 3:2 * w.shape[0] // 3] = False
            w, wg = w[keep], wg[keep]
        assert ((wg - w).norm() / w.norm()).item() <= 1e-4, n


# -- kernel 5: the biased flash forward -------------------------------------
# (B, Nq, Nk, H, D, kv_valid, bias layout): the four broadcast forms, N from
# 1 to 3137, kv_valid, Nq != Nk, D from 16 to 128 (40 is padded to 48).
BIAS_SHAPES = [
    (2, 1, 1, 2, 16, None, "bhqk"),
    (2, 63, 63, 3, 32, None, "1hqk"),
    (2, 300, 300, 3, 64, 250, "hqk"),
    (1, 520, 520, 2, 128, None, "111k"),
    (1, 3137, 3137, 2, 64, 3073, "1hqk"),
    (1, 100, 333, 2, 64, None, "bhqk"),
    (2, 520, 200, 2, 40, 150, "hqk"),
]


def _bias(layout, b, h, nq, nk, dtype, device, seed=7):
    shape = {"bhqk": (b, h, nq, nk), "1hqk": (1, h, nq, nk), "hqk": (h, nq, nk),
             "111k": (1, 1, 1, nk)}[layout]
    x = 2.0 * np.random.default_rng(seed).standard_normal(shape, dtype=np.float32)
    return torch.from_numpy(x).to(device=device, dtype=dtype)


@pytest.mark.parametrize("bias_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", BIAS_SHAPES, ids=str)
def test_bias_kernel_matches_plain(cuda, shape, dtype, bias_dtype):
    b, nq, nk, h, d, kv_valid, layout = shape
    q, k, v = _qkv((b, nq, h, d), (b, nk, h, d), dtype, cuda)
    bias = _bias(layout, b, h, nq, nk, bias_dtype, cuda)
    before = fa.bias_launches
    out = fa.flash_attention(q, k, v, kv_valid, bias)
    torch.cuda.synchronize()
    assert fa.bias_launches == before + 1
    assert out.dtype == dtype and out.shape == (b, nq, h, d)
    ref = fa.attention_plain_bias(q, k, v, bias, kv_valid)
    limit = fa.error_limit(q, k, v, kv_valid, ref, bias=bias.to(dtype))
    use = ((out.float() - ref.float()).abs() / limit).max().item()
    assert use <= 1.0, use


def test_bias_kernel_rounds_the_bias_to_q_dtype(cuda):
    """In bf16 the kernel adds the bias rounded to bf16, as the TPU wrapper
    does: against the unrounded bias it is off by more than its limit."""
    q, k, v = _qkv((1, 600, 2, 64), (1, 600, 2, 64), torch.bfloat16, cuda, seed=3)
    bias = 16.0 * _bias("1hqk", 1, 2, 600, 600, torch.float32, cuda, seed=4)
    out = fa.flash_attention(q, k, v, bias=bias)
    rounded = fa.attention_plain_bias(q, k, v, bias)
    unrounded = fa.attention_plain(q, k, v, None, bias)
    limit = fa.error_limit(q, k, v, None, rounded, bias=bias.to(torch.bfloat16))
    assert ((out.float() - rounded.float()).abs() / limit).max().item() <= 1.0
    assert ((out.float() - unrounded.float()).abs() / limit).max().item() > 1.0


def test_router_sends_a_biased_call_to_kernel_5(cuda):
    """With a bias, N >= 512 launches kernel 5 (also at Nq != Nk); N < 512
    takes the plain attention with the f32 bias and launches nothing; head
    dim > 128 takes the plain attention too (no kernel has it)."""
    from laryngeal_tpu_torch.ops import attention as att

    def counts(fn):
        before = {**fa.launch_counts(), **sa.launch_counts()}
        out = fn()
        torch.cuda.synchronize()
        after = {**fa.launch_counts(), **sa.launch_counts()}
        return out, {n: after[n] - before[n] for n in after if after[n] != before[n]}

    q, k, v = _qkv((2, 512, 2, 64), (2, 512, 2, 64), torch.bfloat16, cuda)
    bias = _bias("1hqk", 2, 2, 512, 512, torch.float32, cuda)
    assert counts(lambda: att.dot_product_attention(q, k, v, bias=bias))[1] == {
        "flash_attention_fwd_bias": 1}
    assert counts(lambda: att.dot_product_attention(
        q[:, :100], k, v, bias=bias[:, :, :100], kv_valid=400))[1] == {
        "flash_attention_fwd_bias": 1}
    small = bias[..., :511, :511]
    out, launched = counts(lambda: att.dot_product_attention(
        q[:, :511], k[:, :511], v[:, :511], bias=small))
    assert launched == {}
    assert torch.equal(out, fa.attention_plain(q[:, :511], k[:, :511], v[:, :511], None, small))
    qb, kb, vb = _qkv((1, 600, 1, 160), (1, 600, 1, 160), torch.bfloat16, cuda)
    wide = _bias("111k", 1, 1, 600, 600, torch.float32, cuda)
    out, launched = counts(lambda: att.dot_product_attention(qb, kb, vb, bias=wide))
    assert launched == {}
    assert torch.equal(out, fa.attention_plain(qb, kb, vb, None, wide))


@pytest.mark.parametrize("shape", [(2, 197, 3, 160), (1, 600, 2, 256)])
def test_head_dim_above_128_takes_plain_attention(cuda, shape):
    """No kernel takes D > 128: the router sends such a call to
    ``attention_plain`` on the card, as the JAX router sends it to XLA, and
    launches nothing."""
    from laryngeal_tpu_torch.ops import attention as att

    b, n, h, d = shape
    q, k, v = _qkv((b, n, h, d), (b, n, h, d), torch.bfloat16, cuda)
    before = {**fa.launch_counts(), **sa.launch_counts()}
    out = att.dot_product_attention(q, k, v)
    torch.cuda.synchronize()
    assert {**fa.launch_counts(), **sa.launch_counts()} == before
    assert torch.equal(out, fa.attention_plain(q, k, v, None, None))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("layout,kv_valid", [("1hqk", None), ("hqk", 480), ("111k", 500)])
def test_bias_autograd_matches_plain(cuda, dtype, layout, kv_valid):
    """FlashAttentionBiasFn: kernel 5 forward, the f32 recompute backward;
    dq, dk, dv and dbias (in the bias's own shape) as plain attention's."""
    q, k, v, g = _grad_inputs((1, 520, 520, 2, 32, kv_valid), dtype, cuda, seed=6)
    bias = _bias(layout, 1, 2, 520, 520, torch.float32, cuda)
    leaves = [x.clone().requires_grad_() for x in (q, k, v, bias)]
    before = fa.launch_counts()
    out = fa.flash_attention(*leaves[:3], kv_valid, leaves[3])
    (out.float() * g.float()).sum().backward()
    torch.cuda.synchronize()
    after = fa.launch_counts()
    assert {n: after[n] - before[n] for n in after if after[n] != before[n]} == {
        "flash_attention_fwd_bias": 1}
    plain = [x.clone().requires_grad_() for x in (q, k, v, bias)]
    (fa.attention_plain(*plain[:3], kv_valid, plain[3]).float() * g.float()).sum().backward()
    assert leaves[3].grad.shape == bias.shape
    for x, p in zip(leaves, plain):
        assert x.grad.dtype == p.grad.dtype
        # The backward is the same plain function of the same inputs.
        assert torch.allclose(x.grad.float(), p.grad.float(), atol=1e-5, rtol=1e-5)


# -- kernel 10: the tubelet embedding ---------------------------------------
# (video (B, T, H, W, C), tubelet, D): M = B*T'*H'*W' = 24, 45, 196, 280, 32,
# 8; kw*C = 48, 48, 48, 48, 32, 64.
TUBELET_SHAPES = [
    ((2, 4, 32, 48, 3), (2, 16, 16), 48),
    ((3, 2, 48, 80, 3), (2, 16, 16), 96),
    ((1, 2, 224, 224, 3), (2, 16, 16), 768),
    ((5, 4, 64, 112, 3), (2, 16, 16), 768),
    ((1, 4, 16, 32, 4), (2, 4, 8), 32),
    ((2, 2, 32, 32, 4), (2, 16, 16), 96),
]


def _tubelet_inputs(shape, tubelet, d, dtype, device, seed=0):
    rng = np.random.default_rng(seed)
    k = tubelet[0] * tubelet[1] * tubelet[2] * shape[-1]
    video = rng.standard_normal(shape, dtype=np.float32)
    kernel = rng.standard_normal((*tubelet, shape[-1], d), dtype=np.float32) / np.sqrt(k)
    bias = 0.1 * rng.standard_normal((d,), dtype=np.float32)
    return (torch.from_numpy(video).to(device=device, dtype=dtype),
            torch.from_numpy(kernel).to(device), torch.from_numpy(bias).to(device))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,tubelet,d", TUBELET_SHAPES, ids=str)
def test_tubelet_kernel_matches_plain(cuda, shape, tubelet, d, dtype):
    video, kernel, bias = _tubelet_inputs(shape, tubelet, d, dtype, cuda)
    before = tt.launches
    out = tt.tubelet_embed(video, kernel, bias, tubelet, impl="kernel")
    torch.cuda.synchronize()
    assert tt.launches == before + 1
    ref = tt.tubelet_embed_plain(video, kernel, bias, tubelet)
    assert out.dtype == dtype and out.shape == ref.shape
    use = ((out.float() - ref.float()).abs() / tt.error_limit(video, kernel, ref, tubelet)).max()
    assert use.item() <= 1.0, use.item()


def test_tubelet_kernel_reads_a_strided_video_and_refuses_bad_input(cuda):
    video, kernel, bias = _tubelet_inputs((2, 4, 32, 48, 3), (2, 16, 16), 48,
                                          torch.bfloat16, cuda)
    wide = torch.cat([video, video], dim=-1)[..., :3]  # a strided view
    out = tt.tubelet_embed(wide, kernel, bias, impl="kernel")
    assert torch.equal(out, tt.tubelet_embed(video, kernel, bias, impl="kernel"))
    with pytest.raises(ValueError):  # float16
        tt.tubelet_embed_cuda(video.half(), kernel, bias)
    with pytest.raises(ValueError):  # a kernel of another tubelet
        tt.tubelet_embed_cuda(video, kernel[:, :8], bias)
    with pytest.raises(ValueError):  # a bias of another width
        tt.tubelet_embed_cuda(video, kernel, bias[:44])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("tubelet,d", [((2, 8, 8), 48), ((2, 16, 16), 20)], ids=str)
def test_tubelet_kernel_route_outside_its_shapes_raises(cuda, tubelet, d, dtype):
    """kw·C = 24 and D = 20, shapes no run-length instance of kernel 10 takes
    (the JAX Pallas kernel takes any): the kernel route launches kernel 10's
    general path once, held against its plain twin (this test raised before
    the kernel took every shape; it keeps its name)."""
    video, kernel, bias = _tubelet_inputs((2, 4, 32, 48, 3), tubelet, d, dtype, cuda)
    assert tt.kernel_takes(video, kernel, tubelet)
    assert not tt.run_length_takes(video, kernel, tubelet)
    before = tt.launches
    out = tt.tubelet_embed(video, kernel, bias, tubelet, impl="kernel")
    torch.cuda.synchronize()
    assert tt.launches == before + 1 and tt.last_design() == "general"
    ref = tt.tubelet_embed_plain(video, kernel, bias, tubelet)
    assert out.dtype == dtype and out.shape == ref.shape
    assert ((out.float() - ref.float()).abs()
            / tt.error_limit(video, kernel, ref, tubelet)).max().item() <= 1.0


# The general path at other shapes: (video (B, T, H, W, C), tubelet, D): an
# odd W·C (147) with kw·C = 21, kw·C = 42, kw·C = 80 (C = 5), D = 100 at the
# ViViT tubelet, one channel, and kw·C = 96 beyond the largest run length.
GENERAL_TUBELET_SHAPES = [
    ((2, 4, 21, 49, 3), (2, 7, 7), 64),
    ((2, 4, 56, 56, 3), (2, 14, 14), 96),
    ((1, 2, 16, 16, 5), (2, 16, 16), 8),
    ((2, 4, 32, 48, 3), (2, 16, 16), 100),
    ((1, 4, 32, 32, 1), (2, 16, 16), 44),
    ((1, 2, 32, 64, 3), (2, 16, 32), 72),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,tubelet,d", GENERAL_TUBELET_SHAPES, ids=str)
def test_tubelet_general_path_matches_plain(cuda, shape, tubelet, d, dtype):
    video, kernel, bias = _tubelet_inputs(shape, tubelet, d, dtype, cuda, seed=3)
    before = tt.launches
    out = tt.tubelet_embed_cuda(video, kernel, bias, tubelet)
    torch.cuda.synchronize()
    assert tt.launches == before + 1 and tt.last_design() == "general"
    ref = tt.tubelet_embed_plain(video, kernel, bias, tubelet)
    assert out.dtype == dtype and out.shape == ref.shape
    assert ((out.float() - ref.float()).abs()
            / tt.error_limit(video, kernel, ref, tubelet)).max().item() <= 1.0


def test_tubelet_kernel_reports_the_design_it_ran(cuda):
    """The ViViT-B stem's run length (kw·C = 48) runs the wgmma design in
    bf16 and the wgmma.tf32x3 one in f32; kw·C = 24 the general path."""
    for tubelet, dtype, want in (((2, 16, 16), torch.bfloat16, "wgmma"),
                                 ((2, 16, 16), torch.float32, "wgmma.tf32x3"),
                                 ((2, 8, 8), torch.bfloat16, "general")):
        video, kernel, bias = _tubelet_inputs((1, 2, 32, 32, 3), tubelet, 48, dtype, cuda)
        tt.tubelet_embed_cuda(video, kernel, bias, tubelet)
        assert tt.last_design() == want, (tubelet, dtype)


def test_tubelet_kernel_refuses_autograd(cuda):
    video, kernel, bias = _tubelet_inputs((1, 2, 32, 32, 3), (2, 16, 16), 48,
                                          torch.float32, cuda)
    kernel.requires_grad_()
    before = tt.launches
    with pytest.raises(RuntimeError, match="no gradient"):
        tt.tubelet_embed(video, kernel, bias, impl="kernel")
    assert tt.launches == before
    out = tt.tubelet_embed(video, kernel, bias, impl="conv")
    out.sum().backward()
    assert kernel.grad is not None



# -- kernels 8-9's wgmma design (bf16, N <= 400, D <= 32, positive strides) --
# (B·nW, N, H, D, nW): the four Swin3D-T 32f 224^2 B=8 stage shapes (shifted),
# then the design's edges: N = 8, 56, 200, 392 with one id row, 448 (past the
# design: mma.sync) at D = 32, and N = 392 at D = 64 (mma.sync); then the
# points where its key width KW switches (N = 144/145, 272/273, the last at
# D = 24, padded to 32) and its largest window, N = 400 (the dQ launch's
# shared memory nearest the card's limit).
WINDOW_STAGES = [(1024, 392, 3, 32, 128), (256, 392, 6, 32, 32), (64, 392, 12, 32, 8),
                 (16, 392, 24, 32, 2)]
WINDOW_WGMMA_EDGES = [(6, 144, 3, 32, 3), (6, 145, 3, 32, 3), (4, 272, 3, 32, 2),
                      (4, 273, 3, 24, 1), (4, 400, 3, 32, 2)]
WINDOW_EDGES = [(6, 8, 3, 32, 2), (6, 56, 3, 32, 3), (6, 200, 3, 32, None), (4, 392, 3, 32, 1),
                (4, 448, 3, 32, 2), (4, 392, 3, 64, 2)] + WINDOW_WGMMA_EDGES


def _window_uses(q, k, v, bias, rid, g, out, grads):
    """Largest |err| / limit of the forward and of (dq, dk, dv, dbias)."""
    ref = wa.window_attention_plain(q, k, v, bias, rid)
    use_f = ((out.float() - ref.float()).abs() / wa.error_limit(q, k, v, bias, rid, ref)).max()
    refs = wa.window_attention_plain_bwd(q, k, v, bias, rid, g)
    limits = wa.backward_error_limit(q, k, v, bias, rid, g, refs)
    return [use_f.item()] + [((x.float() - r.float()).abs() / lim).max().item()
                             for x, r, lim in zip(grads, refs, limits)]


@pytest.mark.parametrize("shape", WINDOW_STAGES + WINDOW_EDGES, ids=str)
def test_window_designs_both_match_plain(cuda, shape):
    """bf16 at the Swin3D-T stages and the wgmma design's edges: the entries
    (in the design ``design_takes`` names) and the kept mma.sync design
    (``window_attention_*_mma_cuda``, which report ``mma.sync``) each stay
    within ``error_limit`` / ``backward_error_limit`` of the twins."""
    q, k, v, bias, rid, g = _window_inputs(shape, torch.bfloat16, cuda, seed=20)
    want = wa.design_takes(shape[1], shape[3], torch.bfloat16)
    assert want == ("wgmma" if shape[1] <= 400 and shape[3] <= 32 else "mma.sync")
    for fwd, bwd, design in ((wa.window_attention_fwd_cuda, wa.window_attention_bwd_cuda, want),
                             (wa.window_attention_fwd_mma_cuda, wa.window_attention_bwd_mma_cuda,
                              "mma.sync")):
        out = fwd(q, k, v, bias, rid)
        grads = bwd(q, k, v, bias, rid, g)
        torch.cuda.synchronize()
        assert wa.last_designs() == (design, design), fwd.__name__
        uses = _window_uses(q, k, v, bias, rid, g, out, grads)
        assert max(uses) <= 1.0, (fwd.__name__, uses)


@pytest.mark.parametrize("shape", [(64, 392, 12, 32, 8), (6, 56, 3, 32, 3), (5, 137, 2, 16, 1)],
                         ids=str)
def test_window_wgmma_is_deterministic(cuda, shape):
    """Two calls of the wgmma design give bitwise the same o, dq, dk, dv and
    dbias: no sum uses atomics, the dbias groups are summed in order."""
    q, k, v, bias, rid, g = _window_inputs(shape, torch.bfloat16, cuda, seed=21)
    runs = [(wa.window_attention_fwd_cuda(q, k, v, bias, rid),
             *wa.window_attention_bwd_cuda(q, k, v, bias, rid, g)) for _ in range(2)]
    torch.cuda.synchronize()
    assert wa.last_designs() == ("wgmma", "wgmma")
    for name, a, b in zip(("o", "dq", "dk", "dv", "dbias"), *runs):
        assert torch.equal(a, b), name


def _window_views(shape, layout, device, seed, dtype=torch.bfloat16):
    """q, k, v, dO (bf16 unless ``dtype``) as views of a fused (B·nW, N, 3,
    H, D) qkv (dO contiguous) or of (B·nW, H, N, D) tensors transposed, an
    f32 bias and region ids in 0..2."""
    bw, n, h, d, nw = shape
    rng = np.random.default_rng(seed)
    if layout == "fused":
        qkv = torch.from_numpy(rng.standard_normal((bw, n, 3, h, d), dtype=np.float32))
        q, k, v = qkv.to(device, dtype).unbind(2)
        g = torch.from_numpy(rng.standard_normal((bw, n, h, d), dtype=np.float32)).to(
            device, dtype)
    else:
        q, k, v, g = (torch.from_numpy(rng.standard_normal((bw, h, n, d), dtype=np.float32))
                      .to(device, dtype).transpose(1, 2) for _ in range(4))
    bias = torch.from_numpy(rng.standard_normal((h, n, n), dtype=np.float32)).to(device)
    rid = torch.from_numpy(rng.integers(0, 3, (nw, n)).astype(np.int32)).to(device)
    return q, k, v, g, bias, rid


@pytest.mark.parametrize("layout", ["fused", "bhnd"])
@pytest.mark.parametrize("shape", [(16, 392, 6, 32, 4)] + WINDOW_WGMMA_EDGES, ids=str)
def test_window_wgmma_reads_views_as_contiguous_copies(cuda, shape, layout):
    """q, k, v (and dO) as views of a fused (B·nW, N, 3, H, D) qkv or of
    (B·nW, H, N, D) tensors transposed, at a stage-3-like shape and at the
    wgmma design's edges: the design runs, reads the views through their
    strides and gives bitwise the results of contiguous copies, and both
    designs stay within the unchanged limits."""
    q, k, v, g, bias, rid = _window_views(shape, layout, cuda, seed=22)
    runs = [(wa.window_attention_fwd_cuda(*xs[:3], bias, rid),
             *wa.window_attention_bwd_cuda(*xs[:3], bias, rid, xs[3]))
            for xs in ((q, k, v, g), tuple(x.contiguous() for x in (q, k, v, g)))]
    torch.cuda.synchronize()
    assert wa.last_designs() == ("wgmma", "wgmma")
    for name, a, b in zip(("o", "dq", "dk", "dv", "dbias"), *runs):
        assert torch.equal(a, b), name
    uses = _window_uses(q, k, v, bias, rid, g, runs[0][0], runs[0][1:])
    assert max(uses) <= 1.0, uses
    old = (wa.window_attention_fwd_mma_cuda(q, k, v, bias, rid),
           wa.window_attention_bwd_mma_cuda(q, k, v, bias, rid, g))
    torch.cuda.synchronize()
    assert wa.last_designs() == ("mma.sync", "mma.sync")
    uses_old = _window_uses(q, k, v, bias, rid, g, *old)
    assert max(uses_old) <= 1.0, uses_old


@pytest.mark.parametrize("which", [0, 1])
def test_window_design_mirror_matches_the_c_choice(cuda, which):
    """``design_takes``, the Python mirror the CPU tests and the checks use,
    names the design the C entries choose (``window_attention_design``) for
    kernel 8 (``which`` 0) and 9 (1): at the wgmma design's edges and past
    them, in both dtypes, with every stride positive and with a stride of 0;
    the ``_mma`` entries' choice is mma.sync (bf16) or FMA (f32) wherever a
    wgmma design would run."""
    n_st = 12 if which == 0 else 21
    for n in (1, 8, 56, 144, 145, 272, 273, 392, 400, 401, 448, 449, 512):
        for d in (8, 16, 24, 32, 40, 64, 128, 136, 256):
            for dtype in (torch.float32, torch.bfloat16):
                for strides in ([96] * n_st, [96] * (n_st - 1) + [0]):
                    want = wa.design_takes(n, d, dtype, strides)
                    assert wa.c_design(which, dtype, n, d, strides) == want, (n, d, dtype)
                    assert wa.c_design(which, dtype, n, d, strides, mma_only=True) == {
                        "wgmma": "mma.sync", "wgmma.tf32x3": "fma"}.get(want, want), (
                            n, d, dtype)


def test_window_wgmma_counts_one_launch_a_call_by_design(cuda):
    """Each entry call counts one launch, under the design the C side ran
    (``design_launches``); the kept mma.sync entries count none."""
    q, k, v, bias, rid, g = _window_inputs((8, 392, 3, 32, 2), torch.bfloat16, cuda, seed=23)
    before = wa.launch_counts()
    designs = {e: dict(c) for e, c in wa.design_launches.items()}
    wa.window_attention_fwd_cuda(q, k, v, bias, rid)
    wa.window_attention_bwd_cuda(q, k, v, bias, rid, g)
    wa.window_attention_fwd_mma_cuda(q, k, v, bias, rid)
    wa.window_attention_bwd_mma_cuda(q, k, v, bias, rid, g)
    torch.cuda.synchronize()
    after = wa.launch_counts()
    assert {e: after[e] - before[e] for e in after} == {
        "window_attention_fwd": 1, "window_attention_bwd": 1, "window_attention_fwd_bf16sm": 0,
        "window_attention_fwd_exp2": 0, "window_attention_fwd_h2": 0}
    for e in designs:
        assert {d: wa.design_launches[e][d] - designs[e][d] for d in wa.DESIGNS} == {
            "fma": 0, "mma.sync": 0, "wide": 0, "wgmma": 1, "wgmma.tf32x3": 0}, e


def test_window_wgmma_failure_raises_and_runs_no_other_design(cuda, monkeypatch):
    """A refused dtype or shape raises ValueError before any launch, and a
    launch the C side refuses raises RuntimeError: the wrapper counts no
    launch and runs no other design in its place."""
    q, k, v, bias, rid, g = _window_inputs((4, 392, 3, 32, 2), torch.float16, cuda, seed=24)
    with pytest.raises(ValueError):
        wa.window_attention_fwd_cuda(q, k, v, bias, rid)
    q, k, v, bias, rid, g = _window_inputs((4, 392, 3, 32, 2), torch.bfloat16, cuda, seed=24)
    with pytest.raises(ValueError):
        wa.window_attention_bwd_cuda(q, k, v, bias[:, :8], rid, g)
    before = wa.launch_counts()
    monkeypatch.setitem(wa._fns, "window_attention_fwd", lambda *a: 1)
    monkeypatch.setitem(wa._fns, "window_attention_bwd", lambda *a: 1)
    with pytest.raises(RuntimeError):
        wa.window_attention_fwd_cuda(q, k, v, bias, rid)
    with pytest.raises(RuntimeError):
        wa.window_attention_bwd_cuda(q, k, v, bias, rid, g)
    assert wa.launch_counts() == before

# -- kernels 8-9's f32 design (wgmma.tf32x3: 3xTF32, N <= 400, D <= 32) -----
# (B·nW, N, H, D, nW): its smallest window, the points past which its key
# width KW switches (N = 145, and 273 at D = 24, padded to 32), Swin3D's
# N = 392 and its largest window, N = 400.
WINDOW_TF32_EDGES = [(6, 8, 3, 32, 2), (6, 145, 3, 32, 3), (4, 273, 3, 24, 1),
                     (4, 392, 3, 32, 2), (4, 400, 3, 32, 2)]


@pytest.mark.parametrize("layout", ["fused", "bhnd"])
@pytest.mark.parametrize("shape", WINDOW_TF32_EDGES, ids=str)
def test_window_tf32_edges_match_plain_and_repeat(cuda, shape, layout):
    """f32 q, k, v, dO as views of a fused qkv or of (B·nW, H, N, D) tensors
    transposed, at the f32 design's edges: the entries run wgmma.tf32x3
    (``design_takes`` names it), give bitwise the same o, dq, dk, dv and
    dbias on a second call and stay within the f32 limits (1e-4 on o,
    F32_REL·A + 1e-6 on the gradients); the ``_mma`` entries run the FMA
    kernels, within the same limits."""
    q, k, v, g, bias, rid = _window_views(shape, layout, cuda, seed=30, dtype=torch.float32)
    assert wa.design_takes(shape[1], shape[3], torch.float32) == "wgmma.tf32x3"
    runs = [(wa.window_attention_fwd_cuda(q, k, v, bias, rid),
             *wa.window_attention_bwd_cuda(q, k, v, bias, rid, g)) for _ in range(2)]
    torch.cuda.synchronize()
    assert wa.last_designs() == ("wgmma.tf32x3", "wgmma.tf32x3")
    for name, a, b in zip(("o", "dq", "dk", "dv", "dbias"), *runs):
        assert torch.equal(a, b), name
    uses = _window_uses(q, k, v, bias, rid, g, runs[0][0], runs[0][1:])
    assert max(uses) <= 1.0, uses
    old = (wa.window_attention_fwd_mma_cuda(q, k, v, bias, rid),
           wa.window_attention_bwd_mma_cuda(q, k, v, bias, rid, g))
    torch.cuda.synchronize()
    assert wa.last_designs() == ("fma", "fma")
    uses_old = _window_uses(q, k, v, bias, rid, g, *old)
    assert max(uses_old) <= 1.0, uses_old


def test_window_tf32_gradients_through_autograd_match_plain(cuda):
    """f32 q/k/v as views of one fused qkv under autograd at Swin3D's window:
    the router runs kernel 8 and kernel 9 once each, both on wgmma.tf32x3,
    and the fused tensor and the bias get the plain twin's gradients within
    the f32 limits."""
    from laryngeal_tpu_torch.ops import attention as att

    rng = np.random.default_rng(31)
    qkv = torch.from_numpy(rng.standard_normal((8, 392, 3, 3, 32), dtype=np.float32))
    qkv = qkv.to(cuda).requires_grad_()
    bias = torch.from_numpy(rng.standard_normal((3, 392, 392), dtype=np.float32)).to(cuda)
    bias.requires_grad_()
    rid = torch.from_numpy(rng.integers(0, 3, (4, 392)).astype(np.int32)).to(cuda)
    g = torch.from_numpy(rng.standard_normal((8, 392, 3, 32), dtype=np.float32)).to(cuda)
    before = {e: dict(c) for e, c in wa.design_launches.items()}
    out = att.window_attention(*qkv.unbind(2), bias, rid)
    (out * g).sum().backward()
    torch.cuda.synchronize()
    for e, counts in wa.design_launches.items():
        assert {d: n - before[e][d] for d, n in counts.items()} == {
            "fma": 0, "mma.sync": 0, "wide": 0, "wgmma": 0, "wgmma.tf32x3": 1}, e
    q, k, v = (x.detach() for x in qkv.unbind(2))
    b = bias.detach()
    ref = wa.window_attention_plain(q, k, v, b, rid)
    assert (out.detach() - ref).abs().max().item() <= 1e-4
    refs = wa.window_attention_plain_bwd(q, k, v, b, rid, g)
    limits = wa.backward_error_limit(q, k, v, b, rid, g, refs)
    for name, got, ref_g, lim in zip(("dq", "dk", "dv", "dbias"),
                                     (*qkv.grad.unbind(2), bias.grad), refs, limits):
        assert ((got - ref_g).abs() / lim).max().item() <= 1.0, name


# -- kernel 5's designs: bf16 on wgmma, f32 at D <= 64 on wgmma.tf32x3 ------
# (B, Nq, Nk, H, D, kv_valid, bias layout): N < 64, Nq != Nk, kv_valid, a
# key-padding bias with wholly padded key tiles, a full bf16 bias, a 1-D bias,
# D padded (40 -> 40, 20 -> 24), D = 128 (bf16 wgmma, f32 FMA).
BIAS_DESIGN_CASES = [
    (2, 40, 40, 3, 64, None, "1hqk"),
    (2, 300, 170, 2, 64, None, "keys"),
    (1, 333, 520, 2, 32, 400, "bhqk16"),
    (2, 257, 257, 3, 40, 200, "k"),
    (1, 600, 600, 2, 128, None, "1hqk"),
    (2, 130, 700, 2, 20, 650, "hqk"),
    (1, 1, 3, 1, 8, None, "keys"),
]


def _design_bias(layout, b, h, nq, nk, device, seed=9):
    """A kernel-5 bias in one of the broadcast forms (``keys``: (B, 1, 1, Nk)
    zeros with its keys from 64 on at -1e9, ``k``: a 1-D (Nk,) bias,
    ``bhqk16``: a full (B, H, Nq, Nk) bias in bf16)."""
    if layout == "keys":
        bias = torch.zeros((b, 1, 1, nk), device=device)
        bias[..., min(64, nk - 1):] = -1e9
        return bias
    if layout == "k":
        return 2.0 * torch.from_numpy(
            np.random.default_rng(seed).standard_normal(nk, dtype=np.float32)).to(device)
    if layout == "bhqk16":
        return _bias("bhqk", b, h, nq, nk, torch.bfloat16, device, seed)
    return _bias(layout, b, h, nq, nk, torch.float32, device, seed)


def _bias_use(q, k, v, bias, kv_valid, out):
    ref = fa.attention_plain_bias(q, k, v, bias, kv_valid)
    limit = fa.error_limit(q, k, v, kv_valid, ref, bias=bias.to(q.dtype))
    return ((out.float() - ref.float()).abs() / limit).max().item()


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=str)
@pytest.mark.parametrize("case", BIAS_DESIGN_CASES, ids=str)
def test_bias_designs_both_match_plain_and_repeat(cuda, case, dtype):
    """Kernel 5's entry runs the design ``forward_design`` names (wgmma in
    bf16, wgmma.tf32x3 in f32 at D <= 64, FMA at D = 128), bitwise the same
    on a second call, within its limit of ``attention_plain_bias``; the
    ``_mma`` entry runs mma.sync / FMA and holds the same limit."""
    b, nq, nk, h, d, kv_valid, layout = case
    q, k, v = _qkv((b, nq, h, d), (b, nk, h, d), dtype, cuda, seed=10)
    bias = _design_bias(layout, b, h, nq, nk, cuda)
    out = fa.flash_attention_bias_cuda(q, k, v, bias, kv_valid)
    again = fa.flash_attention_bias_cuda(q, k, v, bias, kv_valid)
    torch.cuda.synchronize()
    design = fa.forward_design(dtype, d)
    assert fa.last_bias_design() == design
    assert torch.equal(out, again)
    assert out.dtype == dtype and out.shape == (b, nq, h, d)
    use = _bias_use(q, k, v, bias, kv_valid, out)
    assert use <= 1.0, use
    old = fa.flash_attention_bias_mma_cuda(q, k, v, bias, kv_valid)
    torch.cuda.synchronize()
    assert fa.last_bias_design() == {"wgmma": "mma.sync", "wgmma.tf32x3": "fma"}.get(design,
                                                                                     design)
    use_old = _bias_use(q, k, v, bias, kv_valid, old)
    assert use_old <= 1.0, use_old


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=str)
@pytest.mark.parametrize("which", ["q", "k", "v"])
def test_bias_kernel_with_a_stride_of_0_runs_the_mma_design(cuda, which, dtype):
    """A broadcast (stride 0) head axis in q, k or v, which TMA cannot
    describe, takes the mma.sync / FMA template, within its limit."""
    q, k, v = _qkv((2, 300, 3, 64), (2, 300, 3, 64), dtype, cuda, seed=11)
    x = {"q": q, "k": k, "v": v}
    x[which] = x[which][:, :, :1].expand(2, 300, 3, 64)
    bias = _design_bias("1hqk", 2, 3, 300, 300, cuda)
    out = fa.flash_attention_bias_cuda(x["q"], x["k"], x["v"], bias)
    torch.cuda.synchronize()
    assert fa.last_bias_design() == ("fma" if dtype == torch.float32 else "mma.sync")
    use = _bias_use(x["q"], x["k"], x["v"], bias, None, out)
    assert use <= 1.0, use


def test_forward_design_mirror_matches_the_c_choice(cuda):
    """``forward_design``, the Python mirror of kernels 1, 2 and 5's design
    choice, names the design the C side picks (``flash_attention_fwd_design``)
    at every D, in both dtypes, with every stride positive and with a stride
    of 0 in each of q, k, v and o; the ``_mma`` entries' choice is mma.sync
    (bf16) or FMA (f32)."""
    for d in range(8, 129, 8):
        for dtype in (torch.float32, torch.bfloat16):
            for zero in (None, 0, 4, 8, 10):
                strides = [96] * 12
                if zero is not None:
                    strides[zero] = 0
                want = fa.forward_design(dtype, d, strides)
                assert fa.c_forward_design(dtype, d, strides) == want, (d, dtype, zero)
                assert fa.c_forward_design(dtype, d, strides, mma_only=True) == (
                    "fma" if dtype == torch.float32 else "mma.sync")


def test_bias_kernel_counts_one_launch_a_call_by_design(cuda):
    """Each kernel-5 call counts one launch under the design the C side ran
    (``bias_design_launches``); the ``_mma`` entry counts none."""
    q, k, v = _qkv((2, 520, 2, 64), (2, 520, 2, 64), torch.bfloat16, cuda, seed=12)
    bias = _design_bias("1hqk", 2, 2, 520, 520, cuda)
    before, designs = fa.bias_launches, dict(fa.bias_design_launches)
    fa.flash_attention_bias_cuda(q, k, v, bias)
    fa.flash_attention_bias_cuda(*(x.float() for x in (q, k, v)), bias)
    fa.flash_attention_bias_mma_cuda(q, k, v, bias)
    torch.cuda.synchronize()
    assert fa.bias_launches == before + 2
    assert {d: fa.bias_design_launches[d] - designs[d] for d in fa.DESIGNS} == {
        "fma": 0, "mma.sync": 0, "wgmma": 1, "wgmma.tf32x3": 1}


def test_bias_launch_error_raises_and_runs_no_other_design(cuda, monkeypatch):
    """A launch the C side refuses raises RuntimeError: no launch is counted
    and no other design runs in its place."""
    q, k, v = _qkv((1, 520, 2, 64), (1, 520, 2, 64), torch.float32, cuda, seed=13)
    bias = _design_bias("1hqk", 1, 2, 520, 520, cuda)
    before = dict(fa.bias_design_launches)
    monkeypatch.setitem(fa._fns, "flash_attention_fwd_bias", lambda *a: 1)
    with pytest.raises(RuntimeError):
        fa.flash_attention_bias_cuda(q, k, v, bias)
    assert fa.bias_design_launches == before


# -- kernel 12's design: wgmma + TMA, hb heads of a window a block ----------
# (B·nW, N, H, D, nW): the Swin3D-T stage shapes' N = 392 with hb = 3 and 2,
# N = 100 with hb = 2 and 3, the smallest window, D below 32 (padded).
H2_SHAPES = [(4, 392, 3, 32, 2), (2, 392, 6, 32, None), (2, 392, 24, 32, 1),
             (4, 100, 2, 32, 2), (3, 100, 3, 32, None), (6, 8, 3, 16, 3), (2, 200, 6, 24, 2)]


@pytest.mark.parametrize("shape", H2_SHAPES, ids=str)
def test_window_h2_designs_both_match_plain_and_repeat(cuda, shape):
    """Kernel 12 runs its wgmma design (bitwise the same on a second call)
    within the variant's limit of its plain twin; the held mma.sync design
    (``window_attention_variant_mma_cuda``) holds it too."""
    q, k, v, bias, rid, _ = _window_inputs(shape, torch.bfloat16, cuda, seed=14)
    out = wa.window_attention_variant_cuda(q, k, v, bias, rid, "h2")
    again = wa.window_attention_variant_cuda(q, k, v, bias, rid, "h2")
    torch.cuda.synchronize()
    assert wa.last_designs()[0] == "wgmma"
    assert torch.equal(out, again)
    ref = wa.window_attention_plain(q, k, v, bias, rid, "h2")
    limit = wa.error_limit(q, k, v, bias, rid, ref, "h2")
    use = ((out.float() - ref.float()).abs() / limit).max().item()
    assert use <= 1.0, use
    old = wa.window_attention_variant_mma_cuda(q, k, v, bias, rid, "h2")
    torch.cuda.synchronize()
    assert wa.last_designs()[0] == "mma.sync"
    use_old = ((old.float() - ref.float()).abs() / limit).max().item()
    assert use_old <= 1.0, use_old


def test_window_h2_reads_fused_views(cuda):
    """q, k, v as views of one fused (B·nW, N, 3, H, D) qkv, as Swin3D gives
    them: the wgmma design reads them through their strides."""
    bw, n, h, d = 4, 392, 6, 32
    rng = np.random.default_rng(15)
    qkv = torch.from_numpy(rng.standard_normal((bw, n, 3, h, d), dtype=np.float32)).to(
        cuda, torch.bfloat16)
    q, k, v = qkv.unbind(2)
    bias = torch.from_numpy(rng.standard_normal((h, n, n), dtype=np.float32)).to(cuda)
    rid = torch.from_numpy(rng.integers(0, 4, (2, n)).astype(np.int32)).to(cuda)
    out = wa.window_attention_variant_cuda(q, k, v, bias, rid, "h2")
    torch.cuda.synchronize()
    assert wa.last_designs()[0] == "wgmma"
    ref = wa.window_attention_variant_cuda(*(x.contiguous() for x in (q, k, v)), bias, rid, "h2")
    assert torch.equal(out, ref)


def test_window_h2_design_mirror_matches_the_c_choice(cuda):
    """``design_takes(..., kind="h2")`` names kernel 12's design as the C
    entry chooses it (``window_attention_design``, which = 2) at the wgmma
    design's edges and past them, with every stride positive and with a
    stride of 0; the ``_mma`` entry's choice is mma.sync."""
    for n in (1, 4, 8, 30, 100, 144, 145, 148, 272, 276, 392, 398, 400, 401, 404, 448):
        for d in (8, 16, 24, 32, 40, 64):
            for strides in ([96] * 12, [96] * 11 + [0], [96] * 4 + [0] + [96] * 7):
                want = wa.design_takes(n, d, torch.bfloat16, strides, kind="h2")
                assert wa.c_design(2, torch.bfloat16, n, d, strides) == want, (n, d, strides)
                assert wa.c_design(2, torch.bfloat16, n, d, strides, mma_only=True) == "mma.sync"


def test_window_h2_counts_one_launch_a_call_by_design(cuda):
    """Each kernel-12 call counts one launch under the design that ran
    (``variant_design_launches``); the held-design entry counts none."""
    q, k, v, bias, rid, _ = _window_inputs((4, 392, 3, 32, 2), torch.bfloat16, cuda, seed=16)
    before = dict(wa.variant_launches)
    designs = dict(wa.variant_design_launches["h2"])
    wa.window_attention_variant_cuda(q, k, v, bias, rid, "h2")
    wa.window_attention_variant_cuda(q[:, :30], k[:, :30], v[:, :30], bias[:, :30, :30],
                                     rid[:, :30], "h2")
    wa.window_attention_variant_mma_cuda(q, k, v, bias, rid, "h2")
    torch.cuda.synchronize()
    assert wa.variant_launches["h2"] == before["h2"] + 2
    assert {d: wa.variant_design_launches["h2"][d] - designs[d] for d in wa.DESIGNS} == {
        "fma": 0, "mma.sync": 1, "wide": 0, "wgmma": 1, "wgmma.tf32x3": 0}


def test_window_h2_failure_raises_and_runs_no_other_design(cuda, monkeypatch):
    """A refused dtype raises ValueError before any launch, and a launch the
    C side refuses raises RuntimeError: no launch is counted and no other
    design runs in its place."""
    q, k, v, bias, rid, _ = _window_inputs((4, 392, 3, 32, 2), torch.float32, cuda, seed=17)
    with pytest.raises(ValueError):
        wa.window_attention_variant_cuda(q, k, v, bias, rid, "h2")
    q, k, v = (x.to(torch.bfloat16) for x in (q, k, v))
    before = dict(wa.variant_launches)
    monkeypatch.setitem(wa._fns, "window_attention_fwd", lambda *a: 1)
    with pytest.raises(RuntimeError):
        wa.window_attention_variant_cuda(q, k, v, bias, rid, "h2")
    assert wa.variant_launches == before


# -- kernel 11's design: kernel 8's wgmma + TMA with its softmax modes --------
# (B·nW, N, H, D, nW): the four Swin3D-T stage shapes with region ids, N = 100
# and 30 (no N % 4 rule), D below 32 (padded), an unshifted stage.
SM_SHAPES = [(1024, 392, 3, 32, 2), (256, 392, 6, 32, 2), (64, 392, 12, 32, 8),
             (16, 392, 24, 32, 2), (64, 392, 3, 32, None), (6, 100, 2, 32, 3),
             (4, 30, 2, 16, 2), (2, 200, 6, 24, 2)]


@pytest.mark.parametrize("kind", ["bf16sm", "exp2"])
@pytest.mark.parametrize("shape", SM_SHAPES, ids=str)
def test_window_sm_designs_both_match_plain_and_repeat(cuda, shape, kind):
    """Kernel 11 runs kernel 8's wgmma design in the mode of its softmax
    (bitwise the same on a second call) within the variant's limit of its
    plain twin, in the design ``design_takes`` names; the held mma.sync
    design (``window_attention_variant_mma_cuda``) holds it too."""
    q, k, v, bias, rid, _ = _window_inputs(shape, torch.bfloat16, cuda, seed=18)
    out = wa.window_attention_variant_cuda(q, k, v, bias, rid, kind)
    again = wa.window_attention_variant_cuda(q, k, v, bias, rid, kind)
    torch.cuda.synchronize()
    assert wa.last_designs()[0] == wa.design_takes(shape[1], shape[3], torch.bfloat16,
                                                   kind=kind) == "wgmma"
    assert torch.equal(out, again)
    ref = wa.window_attention_plain(q, k, v, bias, rid, kind)
    limit = wa.error_limit(q, k, v, bias, rid, ref, kind)
    use = ((out.float() - ref.float()).abs() / limit).max().item()
    assert use <= 1.0, use
    old = wa.window_attention_variant_mma_cuda(q, k, v, bias, rid, kind)
    torch.cuda.synchronize()
    assert wa.last_designs()[0] == "mma.sync"
    use_old = ((old.float() - ref.float()).abs() / limit).max().item()
    assert use_old <= 1.0, use_old


def test_window_sm_design_mirror_matches_the_c_choice(cuda):
    """``design_takes(..., kind="bf16sm" | "exp2")`` names kernel 11's design
    as the C entry chooses it (``window_attention_design``, which = 3) at the
    wgmma design's edges and past them, with every stride positive and with
    a stride of 0; the ``_mma`` entry's choice is mma.sync."""
    for n in (1, 8, 30, 100, 144, 145, 272, 273, 392, 400, 401, 448):
        for d in (8, 16, 24, 32, 40, 64):
            for strides in ([96] * 12, [96] * 11 + [0], [96] * 4 + [0] + [96] * 7):
                for kind in ("bf16sm", "exp2"):
                    want = wa.design_takes(n, d, torch.bfloat16, strides, kind=kind)
                    assert wa.c_design(3, torch.bfloat16, n, d, strides) == want, (n, d, strides)
                assert wa.c_design(3, torch.bfloat16, n, d, strides, mma_only=True) == "mma.sync"


def test_window_sm_counts_one_launch_a_call_by_design(cuda):
    """Each kernel-11 call counts one launch under the design that ran; the
    held-design entry counts none; a launch the C side refuses raises and
    runs no other design."""
    q, k, v, bias, rid, _ = _window_inputs((4, 392, 3, 32, 2), torch.bfloat16, cuda, seed=19)
    wide = _window_inputs((2, 408, 2, 32, 2), torch.bfloat16, cuda, seed=21)[:5]  # N > 400
    for kind in ("bf16sm", "exp2"):
        before = dict(wa.variant_launches)
        designs = dict(wa.variant_design_launches[kind])
        wa.window_attention_variant_cuda(q, k, v, bias, rid, kind)
        wa.window_attention_variant_cuda(*wide, kind)
        wa.window_attention_variant_mma_cuda(q, k, v, bias, rid, kind)
        torch.cuda.synchronize()
        assert wa.variant_launches[kind] == before[kind] + 2
        assert {d: wa.variant_design_launches[kind][d] - designs[d] for d in wa.DESIGNS} == {
            "fma": 0, "mma.sync": 1, "wide": 0, "wgmma": 1, "wgmma.tf32x3": 0}
    before = dict(wa.variant_launches)
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(wa._fns, "window_attention_fwd", lambda *a: 1)
        with pytest.raises(RuntimeError):
            wa.window_attention_variant_cuda(q, k, v, bias, rid, "exp2")
    assert wa.variant_launches == before


def _mode0_digests(device):
    """sha256 (first 16 hex digits) of kernel 8's bf16 output (mode 0, the
    wgmma design) on seeded inputs: the digests the kernel gave before its
    softmax mode became a template parameter are pinned below."""
    import hashlib

    out = {}
    for shape in ((64, 392, 3, 32, 2), (16, 392, 24, 32, None), (6, 100, 2, 32, 3),
                  (4, 30, 2, 16, 2), (2, 200, 6, 24, 2)):
        q, k, v, bias, rid, _ = _window_inputs(shape, torch.bfloat16, device, seed=20)
        o = wa.window_attention_fwd_cuda(q, k, v, bias, rid)
        out[str(shape)] = hashlib.sha256(
            o.contiguous().view(torch.uint8).cpu().numpy().tobytes()).hexdigest()[:16]
    return out


MODE0_DIGESTS = {"(64, 392, 3, 32, 2)": "4c4278380bfc1253",
                 "(16, 392, 24, 32, None)": "13b94c2ea612a52a",
                 "(6, 100, 2, 32, 3)": "927d1d0ab97d78d7",
                 "(4, 30, 2, 16, 2)": "2db6c2b5c0cf0130",
                 "(2, 200, 6, 24, 2)": "4cd7a90b76dcb6d7"}


def test_window_mode0_is_bitwise_unchanged(cuda):
    """Kernel 8 (mode 0) gives bitwise the output it gave before kernel 11
    took its design (``MODE0_DIGESTS``, read on an H100 from the earlier
    kernel)."""
    assert _mode0_digests(cuda) == MODE0_DIGESTS


# -- kernel 10's designs: wgmma + TMA (bf16), wgmma.tf32x3 (f32) -------------
# chip_smoke.py phase 15's shapes: (video (B, T, H, W, C), D, tubelet).
PHASE15_TUBELET_SHAPES = [((8, 32, 224, 224, 3), 768, (2, 16, 16)),
                          ((5, 4, 64, 112, 3), 768, (2, 16, 16)),
                          ((2, 6, 48, 64, 3), 48, (2, 16, 16)),
                          ((2, 4, 64, 64, 3), 96, (2, 8, 8)),
                          ((2, 4, 56, 56, 3), 768, (2, 14, 14)),
                          ((2, 4, 32, 48, 3), 100, (2, 16, 16)),
                          ((2, 4, 21, 49, 3), 64, (2, 7, 7)),
                          ((1, 4, 48, 288, 3), 200, (2, 16, 16)),   # W' = 18: two slots a row
                          ((1, 8, 16, 64, 1), 16, (4, 4, 16))]      # kw·C = 16, kt = 4


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=str)
@pytest.mark.parametrize("shape,d,tubelet", PHASE15_TUBELET_SHAPES, ids=str)
def test_tubelet_designs_match_plain_at_phase15_shapes(cuda, shape, d, tubelet, dtype):
    """Kernel 10 runs the design ``design_takes`` names (wgmma / wgmma.tf32x3
    at the run-length shapes), bitwise repeatable, within ``error_limit`` of
    its plain twin; the earlier design (``tubelet_embed_mma_cuda``) holds it
    too and counts no launch."""
    video, kernel, bias = _tubelet_inputs(shape, tubelet, d, dtype, cuda, seed=5)
    before = tt.launches
    out = tt.tubelet_embed_cuda(video, kernel, bias, tubelet)
    again = tt.tubelet_embed_cuda(video, kernel, bias, tubelet)
    torch.cuda.synchronize()
    assert tt.launches == before + 2
    assert tt.last_design() == tt.design_takes(shape, d, tubelet, dtype)
    assert torch.equal(out, again)
    ref = tt.tubelet_embed_plain(video, kernel, bias, tubelet)
    limit = tt.error_limit(video, kernel, ref, tubelet)
    assert out.dtype == dtype and out.shape == ref.shape
    assert ((out.float() - ref.float()).abs() / limit).max().item() <= 1.0
    old = tt.tubelet_embed_mma_cuda(video, kernel, bias, tubelet)
    torch.cuda.synchronize()
    assert tt.launches == before + 2
    assert tt.last_design() in ("mma.sync", "fma", "general")
    assert ((old.float() - ref.float()).abs() / limit).max().item() <= 1.0


def test_tubelet_design_mirror_matches_the_c_choice(cuda):
    """``design_takes`` names the design the C entry chooses
    (``tubelet_embed_design``) across run lengths, tubelets, widths, D and
    both dtypes; the ``_mma`` entry keeps the earlier designs."""
    for c, kw, w in ((3, 16, 224), (3, 8, 64), (4, 4, 32), (1, 16, 64), (3, 7, 49), (5, 16, 32),
                     (4, 16, 32), (3, 14, 56)):
        for kt in (1, 2, 4, 5):
            for d in (8, 48, 100, 768):
                for dtype in (torch.bfloat16, torch.float32):
                    shape = (1, kt, 16, w, c)
                    tubelet = (kt, 16, kw)
                    want = tt.design_takes(shape, d, tubelet, dtype)
                    assert tt.c_design(shape, d, tubelet, dtype) == want, (shape, d, tubelet)
                    old = tt.c_design(shape, d, tubelet, dtype, mma_only=True)
                    assert old == {"wgmma": "mma.sync", "wgmma.tf32x3": "fma"}.get(want, want)


def test_tubelet_wgmma_launch_error_raises_and_runs_no_other_design(cuda, monkeypatch):
    """A launch the C side refuses raises RuntimeError: no launch is counted
    and no other design runs in its place."""
    video, kernel, bias = _tubelet_inputs((1, 2, 32, 32, 3), (2, 16, 16), 48, torch.bfloat16,
                                          cuda)
    before = tt.launches
    monkeypatch.setitem(tt._fns, "tubelet_embed", lambda *a: 1)
    with pytest.raises(RuntimeError):
        tt.tubelet_embed_cuda(video, kernel, bias)
    assert tt.launches == before


# -- the CNN families: no kernel of the port lies on their path -------------

def _all_launches():
    return {**fa.launch_counts(), **sa.launch_counts(), **wa.launch_counts(),
            **tt.launch_counts()}


def _cnn(name, dtype, seed=0, dropout=0.5):
    from laryngeal_tpu_torch.models.registry import create_model

    kwargs = {"hidden_size": 16} if name == "resnet50_lstm" else {}
    return create_model(name, num_classes=2, dtype=dtype, seed=seed, dropout=dropout, **kwargs)


@pytest.mark.parametrize("name", ["resnet3d", "resnet50_lstm"])
def test_cnn_f32_logits_match_float64_on_card(cuda, name):
    """Eval logits at full width and depth (4 frames of 64^2, B=2) in f32
    with TF32 off against the same weights in float64 on the card, within
    1e-4 x max(1, max |logit|); bf16 within 3e-2 of f32; no kernel of the
    port launches."""
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (2, 4, 64, 64, 3)).astype(np.float32)).to(cuda)
    before = _all_launches()
    with torch.inference_mode():
        out = _cnn(name, torch.float32).to(cuda).eval()(x)
        ref = _cnn(name, torch.float64).double().to(cuda).eval()(x.double())
        half = _cnn(name, torch.bfloat16).to(cuda).eval()(x)
    torch.cuda.synchronize()
    assert _all_launches() == before
    scale = max(1.0, ref.abs().max().item())
    assert (out.double() - ref).abs().max().item() <= 1e-4 * scale
    assert (half.double() - out.double()).abs().max().item() <= 3e-2 * max(
        1.0, out.abs().max().item())


@pytest.mark.parametrize("name", ["resnet3d", "resnet50_lstm"])
def test_cnn_train_step_on_card(cuda, name, monkeypatch):
    """The train step on the card (Adam; CE, or BCE with pos_weight and the
    trunk frozen; no augmentation or dropout, so both devices see the same
    clips): the loss and every BN running statistic agree with the same step
    on the CPU (f32); the last BatchNorm's running variance moved by the
    biased rule on both; for resnet50_lstm the trunk's parameters bitwise
    unchanged and every other parameter moved; no kernel of the port
    launches. The updated weights are not compared: at this size the f32
    gradients are ill-conditioned (tests/test_torch_resnet3d.py)."""
    from laryngeal_tpu_torch.models.registry import get_model_spec
    from laryngeal_tpu_torch.models.resnet import backbone_param_mask
    from laryngeal_tpu_torch.train.state import create_train_state
    from laryngeal_tpu_torch.train.steps import make_train_step

    monkeypatch.setenv("LARYNGEAL_NO_AUGMENT", "1")
    spec = get_model_spec(name)
    rng = np.random.default_rng(5)
    pix = torch.from_numpy(rng.integers(0, 256, (2, 4, 72, 80, 3), dtype=np.uint8))
    labels, mask = torch.tensor([1, 0]), torch.tensor([True, True])
    bn_name = ("blocks.4.res_blocks.2.branch2.norm_c" if name == "resnet3d"
               else "resnet50.7.2.bn3")
    results = {}
    for dev in ("cpu", cuda):
        model = _cnn(name, torch.float32, dropout=0.0).to(dev)
        start = {k: v.clone() for k, v in model.state_dict().items()}
        trainable = backbone_param_mask(model) if name == "resnet50_lstm" else None
        state = create_train_state(model, "adam", 1e-3, trainable_mask=trainable)
        step = make_train_step(model, "pytorchvideo", spec.loss, 1.5, crop=64, seed=0)
        bn = model.get_submodule(bn_name)
        seen = {}
        hook = bn.register_forward_pre_hook(lambda m, a: seen.update(x=a[0].detach()))
        before = _all_launches()
        state, m = step(state, pix.to(dev), labels.to(dev), mask.to(dev))
        hook.remove()
        if dev == cuda:
            torch.cuda.synchronize()
            assert _all_launches() == before
        x = seen["x"].double()
        dims = (0,) + tuple(range(2, x.ndim))
        want = 0.9 * start[f"{bn_name}.running_var"].double() + 0.1 * x.var(dims,
                                                                            unbiased=False)
        assert (bn.running_var.double() - want).abs().max().item() <= 1e-6
        after = model.state_dict()
        if trainable is not None:
            for n, t in trainable.items():
                assert torch.equal(after[n], start[n]) != t, n
        results[str(dev)] = (m["loss"].item(), {n: v.detach().cpu() for n, v in after.items()})
    (loss_c, w_c), (loss_g, w_g) = results["cpu"], results[str(cuda)]
    assert math.isfinite(loss_g) and abs(loss_c - loss_g) <= 1e-4 * max(1.0, abs(loss_c))
    for n, w in w_c.items():
        if "running_" in n:
            assert (w_g[n] - w).abs().max().item() <= 1e-4 * max(1.0, w.abs().max().item()), n


@pytest.mark.parametrize("name", ["resnet3d", "resnet50_lstm"])
def test_cnn_bf16_train_step_on_card(cuda, name):
    """The train step in bf16 compute (``--bf16``) on the card: cuDNN's
    BatchNorm takes a bf16 input with f32 parameters and statistics; the
    loss is finite, the parameters and statistics stay f32 and finite, and
    the statistics moved."""
    from laryngeal_tpu_torch.models.registry import get_model_spec
    from laryngeal_tpu_torch.train.state import create_train_state
    from laryngeal_tpu_torch.train.steps import make_train_step

    spec = get_model_spec(name)
    model = _cnn(name, torch.bfloat16).to(cuda)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    state = create_train_state(model, "adam", 1e-3)
    step = make_train_step(model, "pytorchvideo", spec.loss, 1.5, crop=64, seed=0)
    pix = torch.from_numpy(np.random.default_rng(6).integers(0, 256, (2, 4, 72, 80, 3),
                                                             dtype=np.uint8)).to(cuda)
    state, m = step(state, pix, torch.tensor([1, 0], device=cuda),
                    torch.tensor([True, True], device=cuda))
    assert math.isfinite(m["loss"].item())
    for k, v in model.state_dict().items():
        if v.is_floating_point():
            assert v.dtype == torch.float32 and torch.isfinite(v).all(), k
            if "running_" in k:
                assert not torch.equal(v, before[k]), k


# ---------- remat, accumulation, the nt layout, the profiler (on the card) ----------

REMAT_MODELS = {
    # N = 513 ViViT tokens: kernels 2-4; TimeSformer: kernels 6-7 (both layouts);
    # Swin3D with drop path on its device generator: kernels 8-9.
    "vivit": ("vivit", dict(num_frames=16, image_size=128, hidden_size=64, num_layers=2,
                            num_heads=4, intermediate_size=128), (2, 16, 128, 128, 3)),
    "timesformer_flat": ("timesformer", dict(num_frames=8, image_size=64, hidden_size=64,
                                             num_layers=2, num_heads=2, intermediate_size=128),
                         (2, 8, 64, 64, 3)),
    "timesformer_nt": ("timesformer", dict(num_frames=8, image_size=64, hidden_size=64,
                                           num_layers=2, num_heads=2, intermediate_size=128,
                                           layout="nt"), (2, 8, 64, 64, 3)),
    "swin3d": ("swin3d", dict(embed_dim=48, depths=(2, 2), num_heads=(2, 4), window=(4, 7, 7),
                              stochastic_depth=0.3), (2, 8, 56, 56, 3)),
}


def _all_launches():
    return {**fa.launch_counts(), **sa.launch_counts(), **wa.launch_counts()}


def _remat_run(cuda, family, remat, dtype):
    from laryngeal_tpu_torch.models.registry import create_model

    name, kw, shape = REMAT_MODELS[family]
    model = create_model(name, seed=0, dtype=dtype, remat=remat, **kw).to(cuda).train()
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(shape).astype(
        np.float32)).to(cuda)
    gen = torch.Generator(device=cuda).manual_seed(9)
    before = _all_launches()
    loss = (model(x, generator=gen).float() ** 2).mean()
    loss.backward()
    torch.cuda.synchronize()
    after = _all_launches()
    counts = {k: after[k] - before[k] for k in after if after[k] != before[k]}
    return loss.item(), {n: p.grad for n, p in model.named_parameters()}, counts


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("family", sorted(REMAT_MODELS))
def test_remat_on_card_launches_each_forward_kernel_once(cuda, family, dtype):
    """Remat on CUDA tensors: every kernel launches as often as without it
    (the forward kernels 2, 6 and 8 are not relaunched by the recompute),
    and the loss and gradients are those without remat."""
    l0, g0, c0 = _remat_run(cuda, family, False, dtype)
    l1, g1, c1 = _remat_run(cuda, family, True, dtype)
    assert c0 == c1 and c1, (c0, c1)
    assert l1 == pytest.approx(l0, rel=1e-6)
    for n in g0:
        torch.testing.assert_close(g1[n], g0[n], rtol=1e-5, atol=1e-6, msg=n)


def test_grad_accum_on_card_matches_the_full_batch(cuda):
    from laryngeal_tpu_torch.models.vivit import create_vivit
    from laryngeal_tpu_torch.train.state import create_train_state
    from laryngeal_tpu_torch.train.steps import make_train_step

    rng = np.random.default_rng(4)
    pix = torch.from_numpy(rng.integers(0, 256, (4, 16, 136, 136, 3), dtype=np.uint8)).to(cuda)
    labels = torch.tensor([0, 1, 1, 0], device=cuda)
    mask = torch.tensor([True, True, True, False], device=cuda)
    grads = {}
    for accum in (1, 2):
        model = create_vivit(num_frames=16, image_size=128, hidden_size=64, num_layers=2,
                             num_heads=4, intermediate_size=128, seed=0).to(cuda)
        state = create_train_state(model, "adamw", 1e-3, 0.01)
        before = fa.lse_launches
        state, m = make_train_step(model, "vivit", "ce", crop=128, grad_accum=accum)(
            state, pix, labels, mask)
        assert state.step == 1 and fa.lse_launches - before == 2 * accum
        grads[accum] = ({n: p.grad.clone() for n, p in model.named_parameters()},
                        m["loss"].item(), m["probs"])
    (g1, l1, p1), (g2, l2, p2) = grads[1], grads[2]
    assert l2 == pytest.approx(l1, rel=2e-5)
    torch.testing.assert_close(p2, p1, atol=2e-5, rtol=0)
    for n, b in g1.items():
        atol = max(1e-4 * b.abs().max().item(), 3e-8)
        torch.testing.assert_close(g2[n], b, atol=atol, rtol=0, msg=n)


def test_profiler_trace_on_card_names_the_kernels(cuda, tmp_path):
    import json

    from laryngeal_tpu_torch.utils.profiling import trace

    model = _tiny_vivit(torch.float32).to(cuda).train()
    x = torch.randn((1, 16, 128, 128, 3), device=cuda)
    with trace(tmp_path, cuda=True):
        model(x).sum().backward()
        torch.cuda.synchronize()
    (path,) = tmp_path.glob("*.pt.trace.json")
    names = {e.get("name", "") for e in json.loads(path.read_text())["traceEvents"]}
    # Kernel 2 (any design of flash_attention_fwd.cu), kernels 3 and 4.
    for symbols in (("fwd_tf32_kernel", "fwd_wgmma_kernel", "flash_fwd_"),
                    ("dq_tf32_kernel", "dq_wgmma_kernel", "dq_f32_kernel", "dq_bf16_kernel"),
                    ("dkv_tf32_kernel", "dkv_wgmma_kernel", "dkv_f32_kernel", "dkv_bf16_kernel")):
        assert any(s in n for n in names for s in symbols), symbols


# ---------- the wires: decode heads, the predictor and the train step on the card ----------

WIRE_DCT_LEVELS, WIRE_DCT_FRACTION = 2.0, 1e-3


def _wire_payload(wire, clips_rgb, keep_ac=31, pack_from=14):
    """The wire's batched host payload (quality 75) of RGB clips."""
    from laryngeal_tpu_torch.data.video import rgb_to_yuv420
    from laryngeal_tpu_torch.preprocess import dct_wire
    from laryngeal_tpu_torch.preprocess.transforms import temporal_delta_encode

    i420 = [rgb_to_yuv420(c) for c in clips_rgb]
    if wire == "i420":
        return np.stack(i420)
    if wire == "delta":
        return np.stack([temporal_delta_encode(c) for c in i420])
    if wire == "dct":
        parts = [dct_wire.encode_clip(c, 75, keep_ac) for c in i420]
    else:
        parts = [dct_wire.encode_clip_packed(c, 75, keep_ac, pack_from) for c in i420]
    return tuple(np.stack([p[i] for p in parts]) for i in range(len(parts[0])))


def _on(payload, device):
    if isinstance(payload, tuple):
        return tuple(torch.from_numpy(x).to(device) for x in payload)
    return torch.from_numpy(payload).to(device)


def _wire_clips(b, t, h, w, seed):
    from laryngeal_tpu_torch.data.synthetic import synth_video

    rng = np.random.default_rng(seed)
    return [synth_video(rng, t, h, w, referral=bool(i % 2)) for i in range(b)]


@pytest.mark.parametrize("wire,keep_ac,pack_from", [("i420", 31, 14), ("delta", 31, 14),
                                                    ("dct", 31, 14), ("dctp", 31, 14),
                                                    ("dctp", 15, 8)])
def test_wire_decode_heads_on_card_match_the_cpu(cuda, wire, keep_ac, pack_from):
    """Each wire's decode head on the card against the CPU's on the same
    payload: i420 / delta within 1e-3, dct / dctp every element within 2
    levels and all but 1e-3 within 1e-3; float32 on the payload's device."""
    from laryngeal_tpu_torch.preprocess.transforms import decode_wire_batch

    payload = _wire_payload(wire, _wire_clips(3, 4, 64, 96, seed=keep_ac), keep_ac, pack_from)
    got = decode_wire_batch(_on(payload, cuda), wire, (64, 96), 75, keep_ac)
    want = decode_wire_batch(_on(payload, "cpu"), wire, (64, 96), 75, keep_ac)
    assert got.is_cuda and got.dtype == torch.float32 and got.shape == (3, 4, 64, 96, 3)
    diff = (got.cpu() - want).abs()
    if wire in ("i420", "delta"):
        assert diff.max().item() <= 1e-3
    else:
        assert diff.max().item() <= WIRE_DCT_LEVELS
        assert (diff > 1e-3).float().mean().item() <= WIRE_DCT_FRACTION


def test_wire_native_library_builds_where_libav_is_present(cuda, tmp_path):
    """Where g++ and the libav development files are present the port's
    native library builds and decodes; elsewhere this skips with the reason
    (the port then decodes with cv2)."""
    from laryngeal_tpu_torch.data import native, video

    ok, detail = native.toolchain()
    if not ok:
        pytest.skip(f"no native toolchain on this host: {detail}")
    assert native.available(), native.unavailable_reason()
    path = tmp_path / "clip.mp4"
    video.write_video(path, _wire_clips(1, 8, 64, 96, seed=1)[0])
    i420 = native.decode_frames(path, [0, 2, 4, 6], (64, 64), "i420", lowres=1)
    assert i420.shape == (4, 96, 64)
    rgb = native.decode_frames(path, [0, 2, 4, 6])
    assert np.abs(rgb.astype(int) - video.decode_frames(path, [0, 2, 4, 6])).mean() <= 1.0


@pytest.mark.parametrize("wire", ["i420", "delta", "dct", "dctp"])
def test_wire_predictor_on_card_launches_kernel_1(cuda, wire):
    """A tiny ViViT served over each wire on the card: one launch of kernel 1
    a layer, probabilities within 1e-4 of the same predictor on the CPU
    (f32, the plain twins there)."""
    from laryngeal_tpu_torch.infer.predictor import Predictor
    from laryngeal_tpu_torch.models.registry import get_model_spec

    clips = np.stack(_wire_clips(2, 16, 128, 128, seed=3))
    probs = {}
    for dev in ("cpu", cuda):
        pred = Predictor(_tiny_vivit(torch.float32), get_model_spec("vivit"), num_frames=16,
                         crop_size=128, device=dev, wire=wire)
        before = fa.launches
        probs[str(dev)] = pred.predict_clip(clips)
        if dev == cuda:
            assert fa.launches - before == 2
    np.testing.assert_allclose(probs[str(cuda)], probs["cpu"], atol=1e-4, rtol=0)


@pytest.mark.parametrize("grad_accum", [1, 2])
def test_wire_dctp_train_step_on_card(cuda, grad_accum):
    """A tiny ViViT train step on a dctp payload on the card: kernels 2-4 a
    layer a micro-batch, the loss within 1e-4 of the CPU step's."""
    from laryngeal_tpu_torch.train.state import create_train_state
    from laryngeal_tpu_torch.train.steps import make_train_step

    payload = _wire_payload("dctp", _wire_clips(2, 16, 128, 128, seed=4), 15, 8)
    labels, mask = torch.tensor([0, 1]), torch.tensor([True, True])
    losses = {}
    for dev in ("cpu", cuda):
        model = _tiny_vivit(torch.float32).to(dev)
        state = create_train_state(model, "adamw", 1e-3, 0.01)
        step = make_train_step(model, "vivit", "ce", crop=128, grad_accum=grad_accum,
                               wire="dctp", wire_hw=(128, 128), wire_keep_ac=15)
        before = fa.launch_counts()
        state, m = step(state, _on(payload, dev), labels.to(dev), mask.to(dev))
        if dev == cuda:
            torch.cuda.synchronize()
            after = fa.launch_counts()
            for k in ("flash_attention_fwd_lse", "flash_attention_bwd_dq",
                      "flash_attention_bwd_dkv"):
                assert after[k] - before[k] == 2 * grad_accum, k
        losses[str(dev)] = m["loss"].item()
    assert np.isfinite(losses[str(cuda)])
    assert abs(losses[str(cuda)] - losses["cpu"]) <= 1e-4 * max(1.0, abs(losses["cpu"]))


def test_wire_pil_exact_route_on_card_matches_the_cpu(cuda, monkeypatch):
    """``LARYNGEAL_PIL_EXACT=1`` on the card: the Pillow resample's integer
    sums are exact in float64, so the card equals the CPU bit for bit."""
    from laryngeal_tpu_torch.preprocess.transforms import batch_preprocess

    monkeypatch.setenv("LARYNGEAL_PIL_EXACT", "1")
    clips = torch.from_numpy(np.stack(_wire_clips(2, 3, 120, 160, seed=5)))
    for regime in ("vivit", "timesformer"):
        got = batch_preprocess(clips.to(cuda), regime, crop=112)
        torch.testing.assert_close(got.cpu(), batch_preprocess(clips, regime, crop=112),
                                   rtol=0, atol=0)
