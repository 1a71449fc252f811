"""The port's training pieces against the JAX package's: losses, model
selection / early stopping / plateau, the optimizer, and 3 AdamW train steps
of a tiny ViViT and of a tiny Swin3D from shared weights on the same uint8
batches (Swin3D with ``LARYNGEAL_NO_AUGMENT=1`` and stochastic depth 0 on
both sides, so no random stream has to be aligned); Swin3D's ``DropPath``
and the step's seeded generators. Inputs are numpy arrays from a seed;
everything runs in float32 on the CPU.

Tolerances: losses 1e-6 absolute (one f32 log-softmax per sample); the train
steps 1e-5 relative (per-step loss, and per parameter tensor in L2, see
``_assert_params_match``): the same f32 arithmetic, summed in another order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from laryngeal_tpu.compat.torch_port import port_swin3d, port_vivit
from laryngeal_tpu.models.swin3d import Swin3DConfig as JaxSwin3DConfig
from laryngeal_tpu.models.swin3d import SwinTransformer3D as JaxSwinTransformer3D
from laryngeal_tpu.models.vivit import create_vivit as jax_create_vivit
from laryngeal_tpu.train import losses as jax_losses
from laryngeal_tpu.train import selection as jax_selection
from laryngeal_tpu.train.state import TrainState as JaxTrainState
from laryngeal_tpu.train.state import make_optimizer as jax_make_optimizer
from laryngeal_tpu.train.state import set_learning_rate as jax_set_learning_rate
from laryngeal_tpu.train.steps import make_eval_step as jax_make_eval_step
from laryngeal_tpu.train.steps import make_train_step as jax_make_train_step
from laryngeal_tpu_torch.compat.flax_weights import (swin3d_state_dict_from_flax,
                                                     vivit_state_dict_from_flax)
from laryngeal_tpu_torch.models import swin3d
from laryngeal_tpu_torch.models.vivit import create_vivit
from laryngeal_tpu_torch.train import losses, selection, state as st, steps

TINY = dict(hidden_size=32, num_layers=2, num_heads=2, intermediate_size=64)
FRAMES, SIZE = 4, 64


# ---------- losses ----------

def _logits_labels(seed, width):
    rng = np.random.default_rng(seed)
    return (rng.normal(0, 2, (8, width)).astype(np.float32), rng.integers(0, 2, 8),
            rng.random(8) > 0.3)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("kind", ["ce", "bce_pos_weight"])
def test_loss_fn_matches_jax(kind, masked):
    logits, labels, mask = _logits_labels(1, 2 if kind == "ce" else 1)
    pw = losses.reference_pos_weight(3, 5)
    assert pw == jax_losses.reference_pos_weight(3, 5)
    m = mask if masked else None
    want = jax_losses.make_loss_fn(kind, pw)(jnp.asarray(logits), jnp.asarray(labels),
                                             None if m is None else jnp.asarray(m))
    got = losses.make_loss_fn(kind, pw)(torch.from_numpy(logits), torch.from_numpy(labels),
                                        None if m is None else torch.from_numpy(m))
    assert got.dtype == torch.float32
    assert abs(got.item() - float(want)) <= 1e-6


def test_masked_mean_ignores_padding_and_empty_mask():
    x = torch.tensor([1.0, 2.0, 100.0])
    assert losses._masked_mean(x, torch.tensor([True, True, False])).item() == 1.5
    assert losses._masked_mean(x, torch.zeros(3, dtype=torch.bool)).item() == 0.0
    assert float(jax_losses._masked_mean(jnp.asarray(x.numpy()), jnp.zeros(3, bool))) == 0.0


@pytest.mark.parametrize("kind", ["ce", "bce_pos_weight"])
def test_probs_match_jax(kind):
    logits, _, _ = _logits_labels(2, 2 if kind == "ce" else 1)
    want = np.asarray(jax_losses.probs_fn(kind)(jnp.asarray(logits)))
    got = losses.probs_fn(kind)(torch.from_numpy(logits)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6)


def test_unknown_loss_raises():
    with pytest.raises(ValueError):
        losses.make_loss_fn("hinge")


# ---------- selection, early stopping, plateau ----------

SEQUENCES = {
    "falling": [(1.0, 0.5, 0.6), (0.9, 0.6, 0.62), (0.8, 0.7, 0.7), (0.7, 0.72, 0.75)],
    "plateau": [(1.0, 0.5, 0.8), (1.0, 0.5, 0.8), (1.01, 0.52, 0.7), (0.99, 0.9, 0.79),
                (1.2, 0.4, 0.81), (0.98, 0.55, 0.6), (1.0, 0.5, 0.8), (1.3, 0.2, 0.5)],
    "noisy": [(0.69, 0.51, 0.5), (0.71, 0.6, 0.55), (0.65, 0.58, 0.5), (0.66, 0.7, 0.6),
              (0.64, 0.69, 0.58), (0.7, 0.3, 0.5), (0.63, 0.71, 0.61), (0.62, 0.72, 0.5)],
}


@pytest.mark.parametrize("seq", sorted(SEQUENCES))
@pytest.mark.parametrize("policy", ["min_loss", "composite", "loss_acc_threshold"])
def test_selection_matches_jax(policy, seq):
    kw = dict(loss_weight=0.3, acc_threshold=0.02)
    a, b = selection.make_selection(policy, **kw), jax_selection.make_selection(policy, **kw)
    for loss, auroc, acc in SEQUENCES[seq]:
        assert a(val_loss=loss, val_auroc=auroc, val_acc=acc) == \
            b(val_loss=loss, val_auroc=auroc, val_acc=acc)


@pytest.mark.parametrize("seq", sorted(SEQUENCES))
def test_early_stopping_and_plateau_match_jax(seq):
    es, jes = selection.EarlyStopping(2, 0.001), jax_selection.EarlyStopping(2, 0.001)
    pl = selection.ReduceLROnPlateau(1e-3, mode="max", factor=0.5, patience=1)
    jpl = jax_selection.ReduceLROnPlateau(1e-3, mode="max", factor=0.5, patience=1)
    for loss, auroc, _ in SEQUENCES[seq]:
        assert es(loss) == jes(loss) and es.should_stop == jes.should_stop
        assert pl.step(auroc) == jpl.step(auroc)


def test_plateau_rejects_bad_mode():
    with pytest.raises(ValueError):
        selection.ReduceLROnPlateau(1.0, mode="up")


# ---------- optimizer ----------

@pytest.mark.parametrize("name", ["adam", "adamw"])
def test_optimizer_matches_optax(name):
    """Three updates on the same gradients: torch.optim with the port's
    settings against the optax transform the JAX package builds."""
    rng = np.random.default_rng(3)
    p0 = {"w": rng.standard_normal((5, 4)).astype(np.float32),
          "b": rng.standard_normal(4).astype(np.float32)}
    grads = [{k: rng.standard_normal(v.shape).astype(np.float32) for k, v in p0.items()}
             for _ in range(3)]
    tx = jax_make_optimizer(name, 1e-2, 0.1)
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    opt_state = tx.init(jp)
    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in p0.items()}
    opt = st.make_optimizer(name, tp.values(), 1e-2, 0.1)
    for g in grads:
        upd, opt_state = tx.update({k: jnp.asarray(v) for k, v in g.items()}, opt_state, jp)
        jp = optax.apply_updates(jp, upd)
        for k, v in tp.items():
            v.grad = torch.from_numpy(g[k])
        opt.step()
    for k in p0:
        np.testing.assert_allclose(tp[k].detach().numpy(), np.asarray(jp[k]), atol=1e-6)


def test_learning_rate_get_set():
    model = torch.nn.Linear(2, 2)
    state = st.create_train_state(model, "adamw", 1e-3, 0.01)
    assert st.get_learning_rate(state) == pytest.approx(1e-3)
    assert st.set_learning_rate(state, 5e-4) is state
    assert st.get_learning_rate(state) == pytest.approx(5e-4)
    with pytest.raises(ValueError):
        st.make_optimizer("sgd", model.parameters(), 1e-3)


# ---------- train steps against the JAX train step ----------

@pytest.fixture(scope="module")
def shared():
    """Tiny ViViT params (the port's seeded init carried to Flax by the JAX
    package's converter, perturbed so every weight matters) and
    three uint8 batches of 3 clips, the last row of each masked as padding."""
    model = jax_create_vivit(num_frames=FRAMES, image_size=SIZE, **TINY)
    weights = create_vivit(num_frames=FRAMES, image_size=SIZE, seed=0, **TINY).state_dict()
    rng = np.random.default_rng(1)
    params = jax.tree_util.tree_map(
        lambda p: p + 0.02 * rng.standard_normal(p.shape).astype(np.float32),
        port_vivit(weights, num_layers=TINY["num_layers"]))
    batches = [(rng.integers(0, 256, (3, FRAMES, 72, 80, 3), dtype=np.uint8),
                rng.integers(0, 2, 3).astype(np.int32), np.array([True, True, False]))
               for _ in range(3)]
    jstep = jax_make_train_step(model, "vivit", "ce", crop=SIZE)
    return model, params, batches, jstep


def _jax_state(params, lr=1e-3, wd=0.01):
    tx = jax_make_optimizer("adamw", lr, wd)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    return JaxTrainState(step=jnp.zeros((), jnp.int32), params=jp, opt_state=tx.init(jp),
                         batch_stats={}, tx=tx)


def _port_state(params, lr=1e-3, wd=0.01):
    model = create_vivit(num_frames=FRAMES, image_size=SIZE, seed=None, **TINY)
    model.load_state_dict(vivit_state_dict_from_flax(params))
    return model, st.create_train_state(model, "adamw", lr, wd)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)


def _rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


def _assert_params_match(model, jstate, n_steps, lr):
    """Every parameter tensor within 1e-5 relative (L2 over the tensor) of
    the JAX one. Adam scales each gradient element to about lr, so an element
    whose gradient is round-off (a sum that cancels) steps on the sign of
    that round-off, differently on the two sides; the tensor's L2 norm
    absorbs such an element where its largest |difference| would not. The
    key biases are all such elements: softmax is shift-invariant per query
    row, so a key bias gets no gradient in exact arithmetic. They are held
    to 3 lr per step and side. Returns the JAX params as a state_dict."""
    want = vivit_state_dict_from_flax(jax.tree_util.tree_map(np.asarray, jstate.params))
    got = model.state_dict()
    for name, w in want.items():
        if name.endswith("attention.attention.key.bias"):
            assert np.abs(got[name].numpy() - w.numpy()).max() <= 2 * 3 * n_steps * lr, name
        else:
            assert _rel_l2(got[name].numpy(), w.numpy()) <= 1e-5, name
    return want


def _torch_batch(batch):
    pix, lab, mask = batch
    return torch.from_numpy(pix), torch.from_numpy(lab), torch.from_numpy(mask)


def test_three_adamw_steps_match_jax(shared):
    _, params, batches, jstep = shared
    jstate = _jax_state(params)
    model, state = _port_state(params)
    step = steps.make_train_step(model, "vivit", "ce", crop=SIZE)
    for batch in batches:
        jstate, jm = jstep(jstate, *(jnp.asarray(x) for x in batch), jax.random.PRNGKey(0))
        state, m = step(state, *_torch_batch(batch))
        assert _rel(m["loss"].item(), float(jm["loss"])) <= 1e-5
        assert m["count"].item() == float(jm["count"]) == 2.0
        assert m["correct"].item() == float(jm["correct"])
        np.testing.assert_allclose(m["probs"].numpy(), np.asarray(jm["probs"]), atol=1e-5)
    assert state.step == 3 and int(jstate.step) == 3
    want = _assert_params_match(model, jstate, n_steps=3, lr=1e-3)
    start = vivit_state_dict_from_flax(params)
    moved = sum(not torch.equal(model.state_dict()[n], start[n]) for n in want)
    assert moved == len(want)  # decoupled weight decay reaches every parameter


def test_key_bias_gradient_is_round_off(shared):
    """Why the key bias is held to the update bound above: its gradient is
    round-off next to the query bias's."""
    _, params, batches, _ = shared
    model, _ = _port_state(params)
    pix, lab, mask = _torch_batch(batches[0])
    from laryngeal_tpu_torch.preprocess.transforms import batch_preprocess

    model.train()
    losses.cross_entropy(model(batch_preprocess(pix, "vivit", crop=SIZE)), lab, mask).backward()
    att = model.vivit.encoder.layer[0].attention.attention
    assert att.key.bias.grad.abs().max() <= 1e-5 * att.query.bias.grad.abs().max()


def test_eval_step_matches_jax(shared):
    jmodel, params, batches, _ = shared
    jm = jax_make_eval_step(jmodel, "vivit", "ce", crop=SIZE)(
        _jax_state(params), *(jnp.asarray(x) for x in batches[0]))
    model, state = _port_state(params)
    m = steps.make_eval_step(model, "vivit", "ce", crop=SIZE)(state, *_torch_batch(batches[0]))
    assert _rel(m["loss"].item(), float(jm["loss"])) <= 1e-5
    np.testing.assert_allclose(m["probs"].numpy(), np.asarray(jm["probs"]), atol=1e-5)


@pytest.mark.parametrize("lr", [0.0, 5e-4])
def test_set_learning_rate_takes_effect(shared, lr):
    """After set_learning_rate both sides take the same step; at lr 0 the
    parameters do not move (the weight decay is lr-scaled too)."""
    _, params, batches, jstep = shared
    jstate = jax_set_learning_rate(_jax_state(params), lr)
    jstate, _ = jstep(jstate, *(jnp.asarray(x) for x in batches[0]), jax.random.PRNGKey(0))
    model, state = _port_state(params)
    st.set_learning_rate(state, lr)
    steps.make_train_step(model, "vivit", "ce", crop=SIZE)(state, *_torch_batch(batches[0]))
    want = _assert_params_match(model, jstate, n_steps=1, lr=lr)
    start = vivit_state_dict_from_flax(params)
    for name in want:
        assert torch.equal(model.state_dict()[name], start[name]) == (lr == 0.0), name


@pytest.mark.parametrize("kwargs", [dict(grad_accum=0), dict(mesh=object()), dict(tp=True),
                                    dict(wire="i420")],
                         ids=["grad_accum", "mesh", "tp", "wire"])
def test_unported_step_options_raise(kwargs):
    """Gradient accumulation is ported (tests/test_torch_grad_accum.py);
    a grad_accum below 1 raises ValueError, as in the JAX step."""
    error, match = ((ValueError, "grad_accum must be >= 1") if "grad_accum" in kwargs
                    else (NotImplementedError, "not yet ported"))
    with pytest.raises(error, match=match):
        steps.make_train_step(torch.nn.Linear(1, 1), "vivit", "ce", **kwargs)


def test_prepare_batch_moves_to_device():
    pix, lab, mask = steps.prepare_batch(
        {"pixel_values": np.zeros((2, 4, 8, 8, 3), np.uint8), "labels": [0, 1],
         "mask": [True, False]}, "cpu")
    assert pix.dtype == torch.uint8 and lab.dtype == torch.int64 and mask.dtype == torch.bool
    assert mask.tolist() == [True, False]


# ---------- Swin3D: train steps against the JAX train step ----------

SWIN = dict(embed_dim=8, depths=(2, 2), num_heads=(2, 2), window=(2, 2, 2),
            patch_size=(2, 4, 4))


@pytest.fixture(scope="module")
def swin_shared():
    """Tiny Swin3D params (the port's seeded init through ``port_swin3d``,
    perturbed) and three uint8 batches of 3 clips, the last row masked.
    4 frames at 32^2 give a 2x8x8 grid: stage 1 shifts (1, 1, 1), stage 2
    (2x4x4) clamps T and keeps the spatial shift."""
    weights = swin3d.create_swin3d(seed=0, stochastic_depth=0.0, **SWIN).state_dict()
    rng = np.random.default_rng(5)
    params = jax.tree_util.tree_map(
        lambda p: p + 0.02 * rng.standard_normal(p.shape).astype(np.float32),
        port_swin3d(weights, depths=SWIN["depths"]))
    batches = [(rng.integers(0, 256, (3, FRAMES, 40, 48, 3), dtype=np.uint8),
                rng.integers(0, 2, 3).astype(np.int32), np.array([True, True, False]))
               for _ in range(3)]
    model = JaxSwinTransformer3D(JaxSwin3DConfig(num_classes=2, stochastic_depth=0.0, **SWIN))
    return model, params, batches


def _swin_port(params, lr=1e-3, wd=0.05):
    model = swin3d.create_swin3d(seed=None, stochastic_depth=0.0, **SWIN)
    model.load_state_dict(swin3d_state_dict_from_flax(params, SWIN["depths"]))
    return model, st.create_train_state(model, "adamw", lr, wd)


def test_swin_three_adamw_steps_and_an_eval_step_match_jax(swin_shared, monkeypatch):
    """The pytorchvideo regime with LARYNGEAL_NO_AUGMENT=1 (both factories
    read it when the step is made): per-step loss within 1e-5 relative;
    afterwards every parameter tensor within 1e-5 relative (L2), the
    relative-position tables (where dbias lands) included. The key slice of
    each fused qkv bias gets only round-off gradient (softmax is
    shift-invariant per query row) and is held to 3 lr per step and side.
    Then the eval step on the trained weights."""
    monkeypatch.setenv("LARYNGEAL_NO_AUGMENT", "1")
    jmodel, params, batches = swin_shared
    lr = 1e-3
    jstate = _jax_state(params, lr, 0.05)
    jstep = jax_make_train_step(jmodel, "pytorchvideo", "ce", crop=32)
    model, state = _swin_port(params, lr)
    step = steps.make_train_step(model, "pytorchvideo", "ce", crop=32, seed=0)
    for batch in batches:
        jstate, jm = jstep(jstate, *(jnp.asarray(x) for x in batch), jax.random.PRNGKey(0))
        state, m = step(state, *_torch_batch(batch))
        assert _rel(m["loss"].item(), float(jm["loss"])) <= 1e-5
        assert m["correct"].item() == float(jm["correct"]) and m["count"].item() == 2.0
        np.testing.assert_allclose(m["probs"].numpy(), np.asarray(jm["probs"]), atol=1e-5)
    want = swin3d_state_dict_from_flax(jax.tree_util.tree_map(np.asarray, jstate.params),
                                       SWIN["depths"])
    got = model.state_dict()
    start = swin3d_state_dict_from_flax(params, SWIN["depths"])
    tables = 0
    for name, w in want.items():
        a, b = got[name].numpy(), w.numpy()
        if name.endswith("attn.qkv.bias"):
            c = a.shape[0] // 3
            assert np.abs(a[c:2 * c] - b[c:2 * c]).max() <= 2 * 3 * 3 * lr, name
            a, b = np.delete(a, np.s_[c:2 * c]), np.delete(b, np.s_[c:2 * c])
        assert _rel_l2(a, b) <= 1e-5, name
        if name.endswith("relative_position_bias_table"):
            tables += 1
            # The table moved by more than its weight decay: dbias reached it.
            decay_only = start[name].numpy() * (1 - lr * 0.05) ** 3
            assert np.abs(a - decay_only).max() > 10 * np.abs(b - a).max(), name
    assert tables == sum(SWIN["depths"])
    jm = jax_make_eval_step(jmodel, "pytorchvideo", "ce", crop=32)(
        jstate, *(jnp.asarray(x) for x in batches[0]))
    m = steps.make_eval_step(model, "pytorchvideo", "ce", crop=32)(
        state, *_torch_batch(batches[0]))
    assert _rel(m["loss"].item(), float(jm["loss"])) <= 1e-5
    np.testing.assert_allclose(m["probs"].numpy(), np.asarray(jm["probs"]), atol=1e-5)


def test_swin_augmented_step_draws_from_seed_and_step(swin_shared, monkeypatch):
    """Without LARYNGEAL_NO_AUGMENT the step augments and drops paths from
    generators seeded by (seed, state.step) only: two runs from the same
    weights take identical steps (what a resumed run relies on), another
    seed takes another step."""
    monkeypatch.delenv("LARYNGEAL_NO_AUGMENT", raising=False)
    _, params, batches = swin_shared
    losses = {}
    for run, seed in (("a", 0), ("b", 0), ("c", 1)):
        model = swin3d.create_swin3d(seed=None, stochastic_depth=0.3, **SWIN)
        model.load_state_dict(swin3d_state_dict_from_flax(params, SWIN["depths"]))
        state = st.create_train_state(model, "adamw", 1e-3, 0.05)
        step = steps.make_train_step(model, "pytorchvideo", "ce", crop=32, seed=seed)
        losses[run] = [step(state, *_torch_batch(b))[1]["loss"].item() for b in batches]
    assert losses["a"] == losses["b"] and losses["a"] != losses["c"]
    a_gen, d_gen = steps.step_generators(0, 7, "cpu")
    b_gen, e_gen = steps.step_generators(0, 7, "cpu")
    assert torch.equal(torch.rand(4, generator=a_gen), torch.rand(4, generator=b_gen))
    assert torch.equal(torch.rand(4, generator=d_gen), torch.rand(4, generator=e_gen))
    assert not torch.equal(torch.rand(4, generator=steps.step_generators(0, 8, "cpu")[0]),
                           torch.rand(4, generator=steps.step_generators(0, 7, "cpu")[0]))


@pytest.mark.parametrize("rate", [0.0, 0.25, 0.9])
def test_drop_path_zeroes_or_rescales_whole_rows(rate):
    """Each sample's row is either zero or x / (1 - rate); the choice is
    reproducible from the generator's seed and keeps about 1 - rate of the
    rows; without a generator it is the identity."""
    x = torch.from_numpy(np.random.default_rng(6).standard_normal((4000, 3, 5))
                         .astype(np.float32)) + 3.0
    dp = swin3d.DropPath(rate)
    assert dp(x) is x
    out = dp(x, torch.Generator().manual_seed(9))
    again = dp(x, torch.Generator().manual_seed(9))
    assert torch.equal(out, again)
    kept = (out != 0).flatten(1).all(1)
    dropped = (out == 0).flatten(1).all(1)
    assert bool((kept | dropped).all())
    torch.testing.assert_close(out[kept], x[kept] / (1.0 - rate), rtol=0, atol=0)
    assert abs(kept.float().mean().item() - (1.0 - rate)) < 0.03
