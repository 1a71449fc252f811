"""Selective remat in the port (``remat=True``, ``ops/remat.py``) must be a
pure memory / compute trade, as the JAX ``tests/test_remat_policy.py`` holds
it: loss and every gradient as without remat (loss rtol 1e-6, gradients
rtol 1e-5 / atol 1e-6, its tolerances) for ViViT, TimeSformer in both
layouts and Swin3D with drop path on and the same generator seed; and the
remat backward runs no attention forward (the counterpart of
``test_attn_out_actually_saved``): the attention Functions' forward entries,
spied on, are called as often with remat as without, while the backward
entries (kernels 3-4, 7 and 9 on the card) are called as without remat.
Tiny models (2 layers, width 64, 32^2 frames) in float32 on the CPU, through
the ``kernel`` impl, whose plain twins run on CPU tensors.
"""

import numpy as np
import pytest
import torch

from laryngeal_tpu_torch.models.registry import create_model
from laryngeal_tpu_torch.ops import attention as att
from laryngeal_tpu_torch.ops import flash_attention as fa
from laryngeal_tpu_torch.ops import short_attention as sa
from laryngeal_tpu_torch.ops import window_attention as wa
from laryngeal_tpu_torch.models import timesformer as ts

VIT = dict(num_frames=4, image_size=32, hidden_size=64, num_layers=2, num_heads=4,
           intermediate_size=128)
SWIN = dict(embed_dim=24, depths=(2, 2), num_heads=(2, 2), window=(2, 4, 4))
FAMILIES = {
    "vivit": ("vivit", VIT, (2, 4, 32, 32, 3)),
    # N = 8 x 8 x 8 + 1 = 513 tokens: the flash route (kernels 2-4's Function).
    "vivit_flash": ("vivit", dict(VIT, num_frames=16, image_size=128), (1, 16, 128, 128, 3)),
    "timesformer_flat": ("timesformer", VIT, (2, 4, 32, 32, 3)),
    "timesformer_nt": ("timesformer", dict(VIT, layout="nt"), (2, 4, 32, 32, 3)),
    "swin3d": ("swin3d", dict(SWIN, stochastic_depth=0.1), (1, 8, 32, 32, 3)),
    "swin3d_drop_half": ("swin3d", dict(SWIN, stochastic_depth=0.5), (2, 8, 32, 32, 3)),
}
# (module, forward entry, backward entry) of each attention Function.
ENTRIES = ((fa, "flash_attention_lse", "flash_attention_bwd"),
           (sa, "short_attention_forward", "short_attention_backward"),
           (wa, "window_attention_forward", "window_attention_backward"),
           (ts, "divided_spatial_attention_plain", "divided_spatial_attention_bwd"))


@pytest.fixture(autouse=True)
def kernel_impl():
    att.set_attention_impl("kernel")
    yield
    att.set_attention_impl(None)


class Spy:
    """Counts calls of every attention entry, split by phase."""

    def __init__(self, monkeypatch):
        self.calls = {}
        self.phase = "forward"
        for mod, fwd, bwd in ENTRIES:
            for name in (fwd, bwd):
                if name:
                    monkeypatch.setattr(mod, name, self._wrap(name, getattr(mod, name)))

    def _wrap(self, name, fn):
        def spy(*args):
            key = (self.phase, name)
            self.calls[key] = self.calls.get(key, 0) + 1
            return fn(*args)
        return spy

    def count(self, phase, names):
        return sum(self.calls.get((phase, n), 0) for n in names)


FWD = [f for _, f, _ in ENTRIES]
BWD = [b for _, _, b in ENTRIES if b]


def _pair(family, dtype=torch.float32):
    name, kw, shape = FAMILIES[family]
    m0 = create_model(name, dtype=dtype, seed=0, **kw)
    m1 = create_model(name, dtype=dtype, seed=None, remat=True, **kw)
    m1.load_state_dict(m0.state_dict())
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(shape).astype(np.float32))
    return m0.train(), m1.train(), x


def _loss_and_grads(model, x, spy=None):
    model.zero_grad(set_to_none=True)
    gen = torch.Generator().manual_seed(7)
    if spy:
        spy.phase = "forward"
    loss = (model(x, generator=gen).float() ** 2).sum()
    if spy:
        spy.phase = "backward"
    loss.backward()
    return loss.item(), {n: p.grad.clone() for n, p in model.named_parameters()}, gen.get_state()


def _assert_equivalent(a, b):
    (l0, g0, s0), (l1, g1, s1) = a, b
    np.testing.assert_allclose(l1, l0, rtol=1e-6)
    assert set(g0) == set(g1)
    for n in g0:
        np.testing.assert_allclose(g1[n].float().numpy(), g0[n].float().numpy(), rtol=1e-5,
                                   atol=1e-6, err_msg=n)
    assert torch.equal(s0, s1)  # the generator ends where it ended without remat


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_remat_changes_no_loss_or_gradient(family, monkeypatch):
    m0, m1, x = _pair(family)
    spy = Spy(monkeypatch)
    plain = _loss_and_grads(m0, x, spy)
    plain_calls = dict(spy.calls)
    spy.calls.clear()
    remat = _loss_and_grads(m1, x, spy)
    _assert_equivalent(plain, remat)
    # The remat backward runs no attention forward; the backward entries run
    # as without remat; the forward ran each attention once.
    assert spy.count("backward", FWD) == 0
    assert spy.count("forward", FWD) == sum(plain_calls.get(("forward", n), 0) for n in FWD) > 0
    assert spy.count("backward", BWD) == sum(plain_calls.get(("backward", n), 0)
                                             for n in BWD) > 0


def test_spy_sees_a_recompute_without_the_tape(monkeypatch):
    """The control: ``torch.utils.checkpoint`` alone reruns the attention
    forward in the backward, and the spy counts it."""
    m0, _, x = _pair("vivit")
    spy = Spy(monkeypatch)
    block = m0.vivit.encoder.layer[0]
    h = m0.vivit.embeddings(x)
    spy.phase = "forward"
    out = torch.utils.checkpoint.checkpoint(block, h, use_reentrant=False)
    spy.phase = "backward"
    out.sum().backward()
    assert spy.count("backward", FWD) == 1


def test_drop_path_draws_the_same_masks_in_the_recompute():
    """At rate 0.5 the masks change the loss, and the remat model's
    gradients still equal the plain one's (checked above): the recompute
    drew the forward's masks. Drawing from another generator state gives
    other gradients."""
    m0, m1, x = _pair("swin3d_drop_half")
    l_drop, _, _ = _loss_and_grads(m0, x)
    m0.zero_grad(set_to_none=True)
    l_none = (m0(x).float() ** 2).sum().item()
    assert l_drop != l_none
    g = torch.Generator().manual_seed(8)
    loss = (m1(x, generator=g).float() ** 2).sum()
    loss.backward()
    other = {n: p.grad.clone() for n, p in m1.named_parameters()}
    _, same, _ = _loss_and_grads(m1, x)
    assert any(not torch.allclose(other[n], same[n]) for n in same)


@pytest.mark.parametrize("family", ["vivit", "timesformer_nt", "swin3d"])
def test_remat_in_bf16(family):
    m0, m1, x = _pair(family, torch.bfloat16)
    _assert_equivalent(_loss_and_grads(m0, x), _loss_and_grads(m1, x))


@pytest.mark.parametrize("family", ["vivit", "timesformer_flat"])
def test_remat_with_the_plain_impl_recomputes_and_agrees(family):
    """With the ``plain`` impl there is no Function to take the outputs
    off the tape: the recompute runs the plain attention again, and the
    gradients still agree."""
    att.set_attention_impl("plain")
    m0, m1, x = _pair(family)
    _assert_equivalent(_loss_and_grads(m0, x), _loss_and_grads(m1, x))


def test_remat_is_off_without_grad():
    m0, m1, x = _pair("timesformer_nt")
    with torch.no_grad():
        assert torch.equal(m0.eval()(x), m1.eval()(x))
    with torch.inference_mode():
        assert torch.equal(m0(x), m1(x))
