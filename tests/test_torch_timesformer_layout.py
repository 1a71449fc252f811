"""TimeSformer's transpose-free nt layout in the port
(``create_timesformer(layout="nt")``) against the port's flat layout and
against the JAX nt model (``TimesformerLayerNT``), from the same weights:
logits and every parameter's gradient of a sum-of-squares loss.

Tiny config: width 64, 2 layers, 4 heads, 4 frames of 32^2 (N = 4 patches,
temporal T = 4). Weights are the port's seeded init carried to Flax by the
JAX package's ``port_timesformer``, perturbed so every weight matters.
Tolerances: logits 1e-4 absolute (f32, another summation order, as
``tests/test_torch_timesformer.py``); gradients per tensor within
1e-4 x max |gradient| (floor 3e-8, ``tests/test_grad_accum.py``'s rule);
bf16 logits of the two layouts within 0.1, the bf16 limit
``tests/test_torch_timesformer.py`` holds the bf16 model to.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from laryngeal_tpu.compat.torch_port import port_timesformer
from laryngeal_tpu.models.timesformer import create_timesformer as jax_create_timesformer
from laryngeal_tpu_torch.compat.flax_weights import timesformer_state_dict_from_flax
from laryngeal_tpu_torch.models import timesformer as ts
from laryngeal_tpu_torch.models.registry import create_model
from laryngeal_tpu_torch.ops import attention as att
from laryngeal_tpu_torch.ops import short_attention as sa

TINY = dict(hidden_size=64, num_layers=2, num_heads=4, intermediate_size=128)
FRAMES, SIZE = 4, 32


@pytest.fixture(scope="module")
def flax_params():
    weights = ts.create_timesformer(num_frames=FRAMES, image_size=SIZE, seed=0,
                                    **TINY).state_dict()
    rng = np.random.default_rng(1)
    return jax.tree_util.tree_map(
        lambda p: p + 0.02 * rng.standard_normal(p.shape).astype(np.float32),
        port_timesformer(weights, num_layers=TINY["num_layers"]))


@pytest.fixture(scope="module")
def pixels():
    return np.random.default_rng(2).standard_normal((2, FRAMES, SIZE, SIZE, 3)).astype(np.float32)


def _port(params, layout, dtype=torch.float32):
    model = create_model("timesformer", num_frames=FRAMES, image_size=SIZE, seed=None,
                         layout=layout, dtype=dtype, **TINY)
    model.load_state_dict(timesformer_state_dict_from_flax(params))
    return model


def _port_grads(model, x):
    model.zero_grad(set_to_none=True)
    logits = model(torch.from_numpy(x))
    (logits ** 2).sum().backward()
    return logits.detach().numpy(), {n: p.grad.numpy() for n, p in model.named_parameters()}


def _assert_grads_close(got, want):
    assert set(got) == set(want)
    for name, b in want.items():
        atol = max(1e-4 * float(np.abs(b).max()), 3e-8)
        np.testing.assert_allclose(got[name], b, atol=atol, rtol=0, err_msg=name)


def test_nt_has_the_flat_parameter_tree():
    flat = ts.create_timesformer(num_frames=FRAMES, image_size=SIZE, **TINY)
    nt = ts.create_timesformer(num_frames=FRAMES, image_size=SIZE, layout="nt", **TINY)
    a, b = flat.state_dict(), nt.state_dict()
    assert list(a) == list(b)  # same names, same order: the seeded init is the same too
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert isinstance(nt.timesformer.encoder.layer[0], ts.TimesformerLayerNT)


@pytest.mark.parametrize("impl", ["plain", "kernel"])
def test_nt_matches_flat_in_logits_and_gradients(flax_params, pixels, impl):
    att.set_attention_impl(impl)
    try:
        flat_logits, flat_grads = _port_grads(_port(flax_params, "flat"), pixels)
        nt_logits, nt_grads = _port_grads(_port(flax_params, "nt"), pixels)
    finally:
        att.set_attention_impl(None)
    np.testing.assert_allclose(nt_logits, flat_logits, atol=1e-4, rtol=0)
    _assert_grads_close(nt_grads, flat_grads)


def test_nt_matches_the_jax_nt_model(flax_params, pixels):
    jmodel = jax_create_timesformer(num_frames=FRAMES, image_size=SIZE, layout="nt", **TINY)
    params = jax.tree_util.tree_map(jnp.asarray, flax_params)
    x = jnp.asarray(pixels)

    def loss(p):
        out = jmodel.apply({"params": p}, x)
        return (out ** 2).sum(), out

    (_, jlogits), jgrads = jax.value_and_grad(loss, has_aux=True)(params)
    want = {k: v.numpy() for k, v in timesformer_state_dict_from_flax(
        jax.tree_util.tree_map(np.asarray, jgrads)).items()}
    logits, grads = _port_grads(_port(flax_params, "nt"), pixels)
    np.testing.assert_allclose(logits, np.asarray(jlogits), atol=1e-4, rtol=0)
    _assert_grads_close(grads, want)


def test_nt_temporal_attention_takes_the_short_route(flax_params, pixels, monkeypatch):
    """With the kernel impl, each nt layer's temporal attention goes to
    ``short_attention`` (kernels 6-7 on the card) at the (B·N, T) shape; the
    spatial attention is the plain einsum function."""
    shapes, spatial = [], []
    real_short, real_spatial = sa.short_attention, ts.divided_spatial_attention

    def short(q, k, v):
        shapes.append(tuple(q.shape))
        return real_short(q, k, v)

    def spy_spatial(*args):
        spatial.append(tuple(args[0].shape))
        return real_spatial(*args)

    monkeypatch.setattr(att, "short_attention", short)
    monkeypatch.setattr(ts, "divided_spatial_attention", spy_spatial)
    att.set_attention_impl("kernel")
    try:
        _port_grads(_port(flax_params, "nt"), pixels)
    finally:
        att.set_attention_impl(None)
    n = (SIZE // 16) ** 2
    assert shapes == [(2 * n, FRAMES, 4, 16)] * TINY["num_layers"]
    assert spatial == [(2, n, FRAMES, 4, 16)] * TINY["num_layers"]


def test_nt_bf16_logits_match_flat(flax_params, pixels):
    with torch.no_grad():
        a = _port(flax_params, "flat", torch.bfloat16)(torch.from_numpy(pixels))
        b = _port(flax_params, "nt", torch.bfloat16)(torch.from_numpy(pixels))
    assert a.dtype == b.dtype == torch.float32
    np.testing.assert_allclose(b.numpy(), a.numpy(), atol=0.1)


def test_nt_spatial_backward_recomputes_and_keeps_no_probabilities(pixels):
    """The spatial Function's backward (recompute + autograd) equals autograd
    through the plain einsums."""
    rng = np.random.default_rng(5)
    shapes = [(2, 3, 4, 2, 8)] * 3 + [(2, 2, 8)] * 3
    leaves = [torch.from_numpy(rng.standard_normal(s).astype(np.float32)).requires_grad_()
              for s in shapes]
    plain = [x.detach().clone().requires_grad_() for x in leaves]
    d_c, d_p = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
                for s in ((2, 4, 2, 8), (2, 3, 4, 2, 8)))
    torch.autograd.backward(ts.DividedSpatialAttentionFn.apply(*leaves), (d_c, d_p))
    torch.autograd.backward(ts.divided_spatial_attention_plain(*plain), (d_c, d_p))
    for a, b in zip(leaves, plain):
        np.testing.assert_allclose(a.grad.numpy(), b.grad.numpy(), atol=1e-6, rtol=1e-6)


def test_layout_is_checked():
    with pytest.raises(ValueError, match="layout"):
        create_model("timesformer", layout="tn")
