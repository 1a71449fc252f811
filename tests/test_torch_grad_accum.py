"""The port's gradient accumulation (``make_train_step(grad_accum=k)``)
against the JAX step at the same ``k`` and against the port at 1.

A tiny ViViT (2 layers, width 64, 4 frames of 32^2) from the port's seeded
init, carried to Flax by the JAX package's converter, on uint8 batches from
a numpy seed. Gradients, not post-AdamW parameters, are compared (the JAX
``tests/test_grad_accum.py`` says why), with its tolerances: loss 2e-5
relative, probabilities 2e-5, every gradient tensor within
1e-4 x max |gradient| (floor 3e-8). slow_r50 (BatchNorm) runs in float64 on
both sides, as the port's CNN training tests run, with its statistics
threaded through the micro-batches: loss, gradients and running statistics
within 1e-6 of JAX (relative L2 per tensor).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from laryngeal_tpu.compat.torch_port import port_resnet3d, port_vivit
from laryngeal_tpu.models.resnet3d import create_resnet3d as jax_create_resnet3d
from laryngeal_tpu.models.vivit import create_vivit as jax_create_vivit
from laryngeal_tpu.train.state import TrainState as JaxTrainState
from laryngeal_tpu.train.state import make_optimizer as jax_make_optimizer
from laryngeal_tpu.train.steps import make_train_step as jax_make_train_step
from laryngeal_tpu_torch.compat.flax_weights import (resnet3d_state_dict_from_flax,
                                                     vivit_state_dict_from_flax)
from laryngeal_tpu_torch.models.resnet3d import create_resnet3d
from laryngeal_tpu_torch.models.vivit import create_vivit
from laryngeal_tpu_torch.train import state as st
from laryngeal_tpu_torch.train import steps

TINY = dict(hidden_size=64, num_layers=2, num_heads=2, intermediate_size=128)
FRAMES, SIZE = 4, 32


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def vivit_params():
    weights = create_vivit(num_frames=FRAMES, image_size=SIZE, seed=0, **TINY).state_dict()
    rng = np.random.default_rng(1)
    return jax.tree_util.tree_map(
        lambda p: p + 0.02 * rng.standard_normal(p.shape).astype(np.float32),
        port_vivit(weights, num_layers=TINY["num_layers"]))


def _batch(n_pad=0, batch=8):
    rng = np.random.default_rng(7)
    mask = np.ones(batch, np.bool_)
    if n_pad:
        mask[-n_pad:] = False
    return (rng.integers(0, 256, (batch, FRAMES, 40, 48, 3), dtype=np.uint8),
            rng.integers(0, 2, batch).astype(np.int32), mask)


def _jax_step(params, accum, batch):
    model = jax_create_vivit(num_frames=FRAMES, image_size=SIZE, **TINY)
    tx = jax_make_optimizer("adamw", 1e-3, 0.01)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    state = JaxTrainState(step=jnp.zeros((), jnp.int32), params=jp, opt_state=tx.init(jp),
                          batch_stats={}, tx=tx)
    step = jax_make_train_step(model, "vivit", "ce", crop=SIZE, grad_accum=accum,
                               return_grads=True)
    state, m = step(state, *(jnp.asarray(x) for x in batch), jax.random.PRNGKey(3))
    grads = vivit_state_dict_from_flax(jax.tree_util.tree_map(np.asarray, m["grads"]))
    return int(state.step), m, {k: v.numpy() for k, v in grads.items()}


def _port_step(params, accum, batch):
    model = create_vivit(num_frames=FRAMES, image_size=SIZE, seed=None, **TINY)
    model.load_state_dict(vivit_state_dict_from_flax(params))
    state = st.create_train_state(model, "adamw", 1e-3, 0.01)
    pix, lab, mask = batch
    state, m = steps.make_train_step(model, "vivit", "ce", crop=SIZE, grad_accum=accum)(
        state, torch.from_numpy(pix), torch.from_numpy(lab.astype(np.int64)),
        torch.from_numpy(mask))
    return state.step, m, {n: p.grad.numpy().copy() for n, p in model.named_parameters()}


def _assert_grads_close(got, want):
    assert set(got) == set(want)
    for name, b in want.items():
        atol = max(1e-4 * float(np.abs(b).max()), 3e-8)
        np.testing.assert_allclose(got[name], b, atol=atol, rtol=0, err_msg=name)


@pytest.mark.parametrize("accum", [2, 4])
def test_accum_matches_jax_and_the_full_batch(vivit_params, accum):
    batch = _batch()
    j_steps, jm, jgrads = _jax_step(vivit_params, accum, batch)
    p_steps, pm, pgrads = _port_step(vivit_params, accum, batch)
    _, pm1, pgrads1 = _port_step(vivit_params, 1, batch)
    assert p_steps == j_steps == 1  # one optimizer update a batch
    for other in (float(jm["loss"]), pm1["loss"].item()):
        np.testing.assert_allclose(pm["loss"].item(), other, rtol=2e-5)
    np.testing.assert_allclose(pm["probs"].numpy(), np.asarray(jm["probs"]), atol=2e-5)
    np.testing.assert_allclose(pm["probs"].numpy(), pm1["probs"].numpy(), atol=2e-5)
    assert pm["count"].item() == 8.0 and pm["correct"].item() == float(jm["correct"])
    _assert_grads_close(pgrads, jgrads)
    _assert_grads_close(pgrads, pgrads1)


def test_all_padding_micro_batch_adds_zero(vivit_params):
    """At accum 2, rows 1, 3, 5, 7 are micro-batch 2: all padding."""
    pix, lab, _ = _batch()
    mask = np.array([True, False] * 4)
    batch = (pix, lab, mask)
    _, jm, jgrads = _jax_step(vivit_params, 2, batch)
    _, pm, pgrads = _port_step(vivit_params, 2, batch)
    _, pm1, pgrads1 = _port_step(vivit_params, 1, batch)
    assert np.isfinite(pm["loss"].item()) and pm["count"].item() == 4.0
    np.testing.assert_allclose(pm["loss"].item(), pm1["loss"].item(), rtol=2e-5)
    np.testing.assert_allclose(pm["loss"].item(), float(jm["loss"]), rtol=2e-5)
    _assert_grads_close(pgrads, pgrads1)
    _assert_grads_close(pgrads, jgrads)


def test_batch_must_split_evenly(vivit_params):
    with pytest.raises(ValueError, match="not divisible"):
        _port_step(vivit_params, 3, _batch())


def test_micro_batch_generators_are_seeded_by_seed_step_and_index():
    """grad_accum 1 keeps the (seed, step) streams; micro-batch i draws from
    (seed, step, i)."""
    def draws(gens):
        return [torch.rand(4, generator=g).tolist() for g in gens]

    whole = draws(steps.step_generators(5, 3, "cpu"))
    ss = np.random.SeedSequence([5, 3]).generate_state(2)
    assert whole == draws([torch.Generator().manual_seed(int(s)) for s in ss])
    micro = [draws(steps.step_generators(5, 3, "cpu", micro=i)) for i in range(2)]
    ss0 = np.random.SeedSequence([5, 3, 0]).generate_state(2)
    assert micro[0] == draws([torch.Generator().manual_seed(int(s)) for s in ss0])
    assert micro[0] != micro[1]
    # SeedSequence reads entropy [s, t] as [s, t, 0]: micro-batch 0 draws the
    # streams the whole batch draws at grad_accum 1.
    assert micro[0] == whole


def _rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-300))


def test_resnet3d_accumulation_matches_jax_in_float64(monkeypatch):
    """slow_r50 in float64 on both sides (dropout 0), batch 4 at accum 2:
    the loss, every gradient and every BatchNorm running statistic, which
    both sides move once per micro-batch, in order; and the statistics
    against two train-mode forwards of the port over the strided
    micro-batches.

    Both steps preprocess with the same float64 map of the uint8 pixels:
    the two packages' float32 pytorchvideo transforms differ by up to 7e-7,
    and train-mode BatchNorm over a micro-batch of 2 clips at 32^2 amplifies
    that to 2e-5 of the loss (the ViViT tests above hold the preprocessing
    per micro-batch)."""
    import laryngeal_tpu.train.steps as jax_steps

    def pre64_jax(x, regime, **kwargs):
        return x.astype(jnp.float64) / 127.5 - 1.0

    def pre64_port(x, regime, **kwargs):
        return x.double() / 127.5 - 1.0

    monkeypatch.setattr(jax_steps, "batch_preprocess", pre64_jax)
    monkeypatch.setattr(steps, "batch_preprocess", pre64_port)
    rng = np.random.default_rng(11)
    pixel = rng.integers(0, 256, (4, FRAMES, SIZE, SIZE, 3), dtype=np.uint8)
    labels, mask = np.array([0, 1, 1, 0], np.int32), np.array([True, True, True, False])
    port = create_resnet3d(seed=0, dropout=0.0, dtype=torch.float64).double()
    start = {k: v.clone() for k, v in port.state_dict().items()}
    variables = port_resnet3d(dict(start))

    with jax.enable_x64(True):
        jmodel = jax_create_resnet3d(dropout=0.0, dtype=jnp.float64, stem_s2d=False)
        tx = jax_make_optimizer("adam", 1e-3)
        params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
        jstate = JaxTrainState(step=jnp.zeros((), jnp.int32), params=params,
                               opt_state=tx.init(params),
                               batch_stats=jax.tree_util.tree_map(jnp.asarray,
                                                                  variables["batch_stats"]),
                               tx=tx)
        jstate, jm = jax_make_train_step(jmodel, "pytorchvideo", "ce", crop=SIZE, grad_accum=2,
                                         return_grads=True)(
            jstate, jnp.asarray(pixel), jnp.asarray(labels), jnp.asarray(mask),
            jax.random.PRNGKey(0))
        jgrads = jax.tree_util.tree_map(np.asarray, jm["grads"])
        jstats = jax.tree_util.tree_map(np.asarray, jstate.batch_stats)
        jloss = float(jm["loss"])

    state = st.create_train_state(port, "adam", 1e-3)
    state, m = steps.make_train_step(port, "pytorchvideo", "ce", crop=SIZE, grad_accum=2)(
        state, torch.from_numpy(pixel), torch.from_numpy(labels.astype(np.int64)),
        torch.from_numpy(mask))
    assert state.step == 1
    assert abs(m["loss"].item() - jloss) <= 1e-6 * max(1.0, abs(jloss))

    want = resnet3d_state_dict_from_flax({"params": jgrads, "batch_stats": jstats})
    got = port.state_dict()
    grads = {n: p.grad for n, p in port.named_parameters()}
    n_stats = 0
    for name, w in want.items():
        if name in grads:
            assert _rel_l2(grads[name].numpy(), w.numpy()) <= 1e-6, name
        elif name.endswith(("running_mean", "running_var")):
            assert _rel_l2(got[name].numpy(), w.numpy()) <= 1e-6, name
            n_stats += 1
    assert n_stats == 2 * 53

    # The same statistics from two train-mode forwards over rows (0, 2), (1, 3).
    twin = create_resnet3d(seed=None, dropout=0.0, dtype=torch.float64).double()
    twin.load_state_dict(start)
    twin.train()
    with torch.no_grad():
        for rows in (slice(0, None, 2), slice(1, None, 2)):
            twin(pre64_port(torch.from_numpy(pixel[rows]), "pytorchvideo"))
    twin_sd = twin.state_dict()
    for name in want:
        if name.endswith(("running_mean", "running_var", "num_batches_tracked")):
            assert torch.allclose(twin_sd[name], got[name], rtol=1e-12, atol=1e-12), name
