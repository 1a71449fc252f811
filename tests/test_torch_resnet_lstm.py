"""Port ResNet50-2D + LSTM against the JAX VideoResNet50LSTM: weights carried
across by the JAX package's ``port_resnet50_lstm`` and the port's
``compat.flax_weights.resnet50_lstm_state_dict_from_flax`` (both
directions), inputs from ``numpy.random.default_rng``. Also the LSTM against
the JAX one and against ``torch.nn.LSTM``, the frozen trunk under masked
Adam with BCE ``pos_weight``, the train step on a padded batch, bf16,
dropout, the checkpoint, the training and inference CLIs and
``Predictor.from_checkpoint``.

The trunk is the full ResNet50 (the JAX converters read stages
(3, 4, 6, 3)); the frames, pixels and the LSTM shrink instead: 4 frames of
32^2 (8 frames in every BatchNorm, the last stage 1x1), B = 2, LSTM width 16.

Training is held in float64 on both sides, for the reason
``tests/test_torch_resnet3d.py`` gives, the BCE loss taken on the
classifier's float64 output: step-0 gradients and three masked Adam steps;
the port's step-0 gradients through its float32 logit and loss are held to
the float64 ones.

Tolerances: f32 eval logits 1e-4 x max(1, max |logit|); the LSTM alone
1e-5 (f32) and 2e-2 (bf16 carry) absolute; float64 step-0 gradients 1e-6
relative L2 per parameter tensor; three float64 steps: losses 1e-6
relative, every parameter tensor and BN running statistic 1e-6 relative L2,
the trunk's parameters bitwise unchanged; bf16 logits 3e-2 x
max(1, max |logit|) of the f32 ones.
"""

import copy
import json

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from laryngeal_tpu.compat.torch_port import port_resnet50_lstm
from laryngeal_tpu.models.registry import get_model_spec as jax_get_model_spec
from laryngeal_tpu.models.resnet import LSTM as JaxLSTM
from laryngeal_tpu.models.resnet import backbone_param_mask as jax_backbone_param_mask
from laryngeal_tpu.models.resnet import create_resnet50_lstm as jax_create_resnet50_lstm
from laryngeal_tpu.train.losses import bce_with_logits as jax_bce_with_logits
from laryngeal_tpu.train.state import TrainState as JaxTrainState
from laryngeal_tpu.train.state import make_optimizer as jax_make_optimizer
from laryngeal_tpu.train.steps import make_train_step as jax_make_train_step
from laryngeal_tpu_torch.cli import inference as cli_inference
from laryngeal_tpu_torch.cli import main as cli
from laryngeal_tpu_torch.cli import serve as cli_serve
from laryngeal_tpu_torch.compat.flax_weights import resnet50_lstm_state_dict_from_flax
from laryngeal_tpu_torch.data.pipeline import create_dataloaders
from laryngeal_tpu_torch.data.synthetic import make_synthetic_dataset
from laryngeal_tpu_torch.infer.predictor import Predictor
from laryngeal_tpu_torch.models import layers
from laryngeal_tpu_torch.models import resnet
from laryngeal_tpu_torch.models.registry import create_model, get_model_spec
from laryngeal_tpu_torch.preprocess.transforms import batch_preprocess
from laryngeal_tpu_torch.train import checkpoint as ckpt
from laryngeal_tpu_torch.train import state as st
from laryngeal_tpu_torch.train import steps
from laryngeal_tpu_torch.train.losses import bce_with_logits
from laryngeal_tpu_torch.train.trainer import Trainer
from tests.test_torch_resnet3d import (_rel_l2, _tree, _zero_stats, head_capture_jax,
                                       head_capture_port)

FRAMES, SIZE, HIDDEN = 4, 32, 16
LR, POS_WEIGHT = 1e-3, 2.25
N_TRUNK = 53 * 3  # convs and BN scales / biases
N_BN = 53


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """The suite runs files in parallel workers: torch's default of one
    thread a core in each of them oversubscribes the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _perturb(model, seed):
    """Move every BN scale, bias and statistic and the classifier's biases
    off their init."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, layers.BatchNorm):
                n = m.num_features
                dt = m.weight.dtype
                m.weight.add_(0.1 * torch.randn(n, generator=g, dtype=dt))
                m.bias.add_(0.1 * torch.randn(n, generator=g, dtype=dt))
                m.running_mean.add_(0.05 * torch.randn(n, generator=g, dtype=dt))
                m.running_var.copy_(0.7 + 0.7 * torch.rand(n, generator=g, dtype=dt))
        for i in (0, 3):
            b = model.classifier[i].bias
            b.add_(0.1 * torch.randn(b.shape, generator=g, dtype=b.dtype))
    return model


def _port(dtype=torch.float32, dropout=0.5, seed=0):
    return resnet.create_resnet50_lstm(hidden_size=HIDDEN, num_layers=2, dropout=dropout,
                                       dtype=dtype, seed=seed)


@pytest.fixture(scope="module")
def port_f32():
    return _perturb(_port(), 1)


@pytest.fixture(scope="module")
def pixels():
    return np.random.default_rng(2).standard_normal((2, FRAMES, SIZE, SIZE, 3)).astype(
        np.float32)


def _trunk(sd):
    return {k: v for k, v in sd.items() if k.startswith("resnet50.")}


# ---------- eval: logits, names, converters, the LSTM ----------

@pytest.mark.parametrize("stem_s2d", [False, True], ids=["direct_stem", "s2d_stem"])
def test_eval_logits_match_jax(port_f32, pixels, stem_s2d):
    """The JAX model's default direct stem and its space-to-depth one."""
    variables = _tree(port_resnet50_lstm(dict(port_f32.state_dict())))
    jmodel = jax_create_resnet50_lstm(hidden_size=HIDDEN, num_layers=2, stem_s2d=stem_s2d)
    ref = np.asarray(jmodel.apply(variables, jnp.asarray(pixels)))
    with torch.inference_mode():
        out = port_f32(torch.from_numpy(pixels))
    assert out.dtype == torch.float32 and out.shape == (2, 1)
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-4 * max(1.0, np.abs(ref).max()),
                               rtol=0)


def test_state_dict_round_trips_through_both_converters(port_f32):
    sd = port_f32.state_dict()
    variables = port_resnet50_lstm(dict(sd))
    back = resnet50_lstm_state_dict_from_flax(variables)
    assert set(back) == set(sd)
    for name, w in sd.items():
        assert torch.equal(back[name], w), name
    again = port_resnet50_lstm(dict(back))
    flat_a = dict(jax.tree_util.tree_flatten_with_path(variables)[0])
    flat_b = jax.tree_util.tree_flatten_with_path(again)[0]
    assert len(flat_a) == len(flat_b) == N_TRUNK + 2 * N_BN + 8 + 4
    for path, b in flat_b:
        np.testing.assert_array_equal(np.asarray(b), np.asarray(flat_a[path]))


def test_reference_names():
    """The reference's ``nn.Sequential(*resnet50.children()[:-1])`` layout
    at full width: conv1 and bn1 at 0 and 1, layer1-4 at 4-7."""
    sd = resnet.create_resnet50_lstm(seed=None).state_dict()
    assert sd["resnet50.0.weight"].shape == (64, 3, 7, 7)
    assert sd["resnet50.1.running_var"].shape == (64,)
    assert sd["resnet50.4.0.downsample.0.weight"].shape == (256, 64, 1, 1)
    assert sd["resnet50.7.2.bn3.num_batches_tracked"].shape == ()
    assert sd["lstm.weight_ih_l0"].shape == (1024, 2048)
    assert sd["lstm.weight_hh_l1"].shape == (1024, 256)
    assert sd["classifier.0.weight"].shape == (64, 256)
    assert sd["classifier.3.weight"].shape == (1, 64)
    assert len(sd) == 53 + 53 * 5 + 8 + 4


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.bfloat16, 2e-2)],
                         ids=["f32", "bf16"])
def test_lstm_matches_jax_and_torch_lstm(dtype, tol):
    """The LSTM alone against the JAX LSTM (the carry in the compute dtype)
    and, in f32, against ``torch.nn.LSTM`` loading the same state."""
    lstm = resnet.LSTM(12, 8, num_layers=2, dtype=dtype)
    lstm.init_weights(torch.Generator().manual_seed(3))
    x = np.random.default_rng(3).standard_normal((3, 5, 12)).astype(np.float32)
    with torch.no_grad():
        out = lstm(torch.from_numpy(x))
    assert out.dtype == dtype
    params = {f"{a}_l{k}": np.asarray(getattr(lstm, f"{b}_l{k}").detach().numpy().T
                                      if a.startswith("w") else
                                      getattr(lstm, f"{b}_l{k}").detach().numpy())
              for k in range(2) for a, b in (("w_ih", "weight_ih"), ("w_hh", "weight_hh"),
                                             ("b_ih", "bias_ih"), ("b_hh", "bias_hh"))}
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    ref = JaxLSTM(8, 2, 0.5, dtype=jdt).apply({"params": _tree(params)}, jnp.asarray(x))
    np.testing.assert_allclose(out.float().numpy(), np.asarray(ref, np.float32), atol=tol,
                               rtol=0)
    if dtype == torch.float32:
        plain = torch.nn.LSTM(12, 8, num_layers=2, batch_first=True)
        plain.load_state_dict(lstm.state_dict())
        with torch.no_grad():
            np.testing.assert_allclose(out.numpy(), plain(torch.from_numpy(x))[0].numpy(),
                                       atol=1e-6, rtol=0)


def test_lstm_init_is_torch_uniform():
    lstm = resnet.LSTM(40, 64, num_layers=2).init_weights(torch.Generator().manual_seed(0))
    for name, p in lstm.named_parameters():
        assert p.abs().max() <= 1 / 8 and p.abs().max() > 0.12, name
        assert abs(p.mean().item()) < 0.01, name


def test_backbone_mask_matches_jax(port_f32):
    """The trainable mask freezes the trunk and nothing else, leaf for leaf
    with the JAX mask over the same weights."""
    mask = resnet.backbone_param_mask(port_f32)
    variables = port_resnet50_lstm(dict(port_f32.state_dict()))
    jmask = jax.tree_util.tree_flatten_with_path(jax_backbone_param_mask(variables["params"]))[0]
    frozen = sorted(n for n, m in mask.items() if not m)
    assert frozen == sorted(n for n, _ in port_f32.named_parameters() if n.startswith("resnet50."))
    assert len(frozen) == N_TRUNK == sum(not m for _, m in jmask)
    assert len(mask) - len(frozen) == sum(bool(m) for _, m in jmask) == 8 + 4
    assert all((path[0].key == "resnet50") != bool(m) for path, m in jmask)


# ---------- training in float64 against JAX ----------

def bce64_port(z, y, mask):
    x, y = z.reshape(-1), y.reshape(-1).to(z.dtype)
    ls = torch.nn.functional.logsigmoid
    loss = -(POS_WEIGHT * y * ls(x) + (1.0 - y) * ls(-x))
    m = mask.to(z.dtype)
    return (loss * m).sum() / m.sum().clamp(min=1.0)


def bce64_jax(z, y, mask):
    x, y = z.reshape(-1), y.reshape(-1).astype(z.dtype)
    loss = -(POS_WEIGHT * y * jax.nn.log_sigmoid(x) + (1.0 - y) * jax.nn.log_sigmoid(-x))
    m = mask.astype(z.dtype)
    return (loss * m).sum() / jnp.maximum(m.sum(), 1.0)


@pytest.fixture(scope="module")
def f64_run():
    """Float64 on both sides, the trunk frozen by the trainable mask, batches
    of 2 clips, the third a padded last batch: three masked Adam steps with
    the BCE (pos_weight 2.25) taken on the classifier's float64 output; every
    parameter's step-0 gradient (the trunk's too: JAX computes them before
    it zeroes them, the port from a twin with nothing frozen); and the
    port's step-0 gradients through its float32 logit and BCE."""
    port = _perturb(_port(torch.float64, dropout=0.0), 1).double()
    start = {k: v.clone() for k, v in port.state_dict().items()}
    variables = port_resnet50_lstm(dict(port.state_dict()))
    rng = np.random.default_rng(4)
    batches = []
    for i in range(3):
        x = rng.standard_normal((2, FRAMES, SIZE, SIZE, 3))
        mask = np.array([True, i < 2])
        if i == 2:
            x[1] = x[0]
        batches.append(tuple(map(torch.from_numpy, (x, np.array([1, 0]), mask))))

    twin = copy.deepcopy(port).train()
    bce_with_logits(twin(batches[0][0]), batches[0][1], POS_WEIGHT, batches[0][2]).backward()
    cast_grads = {n: p.grad.clone() for n, p in twin.named_parameters()}
    twin.zero_grad(set_to_none=True)
    head = head_capture_port(twin.classifier[3])
    twin.load_state_dict(start)
    twin(batches[0][0])
    bce64_port(head["out"], batches[0][1], batches[0][2]).backward()
    port_grads = {n: p.grad for n, p in twin.named_parameters()}
    head = head_capture_port(port.classifier[3])
    state = st.create_train_state(port.train(), "adam", LR,
                                  trainable_mask=resnet.backbone_param_mask(port))
    port_losses = []
    for x, y, mask in batches:
        port(x)
        loss = bce64_port(head["out"], y, mask)
        state.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        state.optimizer.step()
        port_losses.append(loss.item())

    with jax.enable_x64(True):
        model = jax_create_resnet50_lstm(hidden_size=HIDDEN, num_layers=2, dropout=0.0,
                                         dtype=jnp.float64)
        params, stats = _tree(variables["params"]), _tree(variables["batch_stats"])
        tx = jax_make_optimizer("adam", LR, trainable_mask=jax_backbone_param_mask(params))
        opt_state = tx.init(params)

        def loss_fn(p, stats, x, y, mask):
            interceptor, store = head_capture_jax("fc2")
            with fnn.intercept_methods(interceptor):
                _, upd = model.apply({"params": p, "batch_stats": stats}, x, train=True,
                                     mutable=["batch_stats"])
            return bce64_jax(store["out"], y, mask), upd["batch_stats"]

        grad_fn = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))
        update = jax.jit(tx.update)
        jax_losses, jax_grads = [], None
        for batch in batches:
            (loss, stats), grads = grad_fn(params, stats,
                                           *(jnp.asarray(a.numpy()) for a in batch))
            jax_grads = jax_grads or jax.tree_util.tree_map(np.asarray, grads)
            updates, opt_state = update(grads, opt_state, params)
            params = optax.apply_updates(params, updates)
            jax_losses.append(float(loss))
        final = jax.tree_util.tree_map(np.asarray, {"params": params, "batch_stats": stats})
    return dict(port=port, state=state, start=start, port_grads=port_grads,
                cast_grads=cast_grads, port_losses=port_losses, jax_grads=jax_grads,
                jax_losses=jax_losses, jax_final=final)


def test_step0_gradients_match_jax_in_float64(f64_run):
    """Every parameter's step-0 gradient, the trunk's included, against
    JAX's, both through the classifier's float64 output; and the port's
    through its float32 logit and BCE against those."""
    grads = f64_run["jax_grads"]
    want = resnet50_lstm_state_dict_from_flax(
        {"params": grads, "batch_stats": {"resnet50": _zero_stats(grads["resnet50"])}})
    port = f64_run["port_grads"]
    assert len(port) == N_TRUNK + 8 + 4
    for got, name in ((port, "jax"), (f64_run["cast_grads"], "cast")):
        errs = {n: _rel_l2(got[n].numpy(), want[n].numpy()) for n in port}
        worst = max(errs, key=errs.get)
        assert errs[worst] <= 1e-6, (name, worst, errs[worst])


def test_three_masked_adam_steps_match_jax_in_float64(f64_run):
    """Losses; then every parameter tensor and BN statistic within 1e-6 of
    JAX's; the trunk's parameters bitwise where they started on both sides
    while every trunk BN statistic moved; the LSTM and classifier moved; the
    optimizer holds state for those only."""
    for a, b in zip(f64_run["port_losses"], f64_run["jax_losses"]):
        assert abs(a - b) <= 1e-6 * max(1.0, abs(b)), (f64_run["port_losses"],
                                                      f64_run["jax_losses"])
    want = {k: v.numpy() for k, v in resnet50_lstm_state_dict_from_flax(
        f64_run["jax_final"]).items()}
    got, start = f64_run["port"].state_dict(), f64_run["start"]
    trainable = resnet.backbone_param_mask(f64_run["port"])
    moved_stats = 0
    for name, w in want.items():
        if name.endswith("num_batches_tracked"):
            assert got[name].item() == 3, name
            continue
        assert _rel_l2(got[name].numpy(), w) <= 1e-6, (name, _rel_l2(got[name].numpy(), w))
        if name in trainable:
            assert torch.equal(got[name], start[name]) != trainable[name], name
            if not trainable[name]:
                np.testing.assert_array_equal(w, start[name].numpy())
        else:
            moved_stats += not torch.equal(got[name], start[name])
    assert moved_stats == 2 * N_BN
    opt = f64_run["state"].optimizer
    held = {id(p) for group in opt.param_groups for p in group["params"]}
    for name, p in f64_run["port"].named_parameters():
        assert (id(p) in held) == trainable[name] == p.requires_grad, name
        assert (p in opt.state) == trainable[name], name


# ---------- the train step, bf16, dropout ----------

def test_train_step_on_a_padded_batch_matches_jax(port_f32, monkeypatch):
    """The port's train step and the JAX one (pytorchvideo regime,
    LARYNGEAL_NO_AUGMENT=1, dropout 0, BCE with pos_weight, the trunk
    masked) on one uint8 batch of 3 clips whose last row is padding: loss,
    correct / count, probabilities, and every BN statistic (over all 3
    rows' frames, within 1e-4 x max(1, max |statistic|)); the trunk's
    parameters bitwise unchanged on both sides, the LSTM's moved.

    The loss: at 12 frames a channel in the last stage's BatchNorm the
    train-mode forward is ill-conditioned in float32, and Flax's BatchNorm
    takes the variance as E[x^2] - E[x]^2. Against the float64 loss of the
    same model on the same clips (held to JAX's float64 one by ``f64_run``)
    the JAX step's float32 loss sits 2.7e-4 off, the port's 7e-6. So the
    port's step is held to the float64 loss within 1e-5 relative, and to the
    JAX step within 1e-3 (probabilities 1e-3)."""
    monkeypatch.setenv("LARYNGEAL_NO_AUGMENT", "1")
    rng = np.random.default_rng(7)
    pixel = rng.integers(0, 256, (3, FRAMES, 40, 48, 3), dtype=np.uint8)
    pixel[2] = pixel[1]
    labels, mask = np.array([1, 0, 0], np.int32), np.array([True, True, False])

    sd = port_f32.state_dict()
    variables = port_resnet50_lstm(dict(sd))
    jmodel = jax_create_resnet50_lstm(hidden_size=HIDDEN, num_layers=2, dropout=0.0)
    params = _tree(variables["params"])
    tx = jax_make_optimizer("adam", LR, trainable_mask=jax_backbone_param_mask(params))
    jstate = JaxTrainState(step=jnp.zeros((), jnp.int32), params=params,
                           opt_state=tx.init(params),
                           batch_stats=_tree(variables["batch_stats"]), tx=tx)
    jstate, jm = jax_make_train_step(jmodel, "pytorchvideo", "bce_pos_weight", POS_WEIGHT,
                                     crop=SIZE)(
        jstate, jnp.asarray(pixel), jnp.asarray(labels), jnp.asarray(mask),
        jax.random.PRNGKey(0))

    model = _port(dropout=0.0, seed=None)
    model.load_state_dict(sd)
    state = st.create_train_state(model, "adam", LR,
                                  trainable_mask=resnet.backbone_param_mask(model))
    state, m = steps.make_train_step(model, "pytorchvideo", "bce_pos_weight", POS_WEIGHT,
                                     crop=SIZE, seed=0)(
        state, torch.from_numpy(pixel), torch.from_numpy(labels.astype(np.int64)),
        torch.from_numpy(mask))
    wide = _port(torch.float64, dropout=0.0, seed=None)
    wide.load_state_dict(sd)
    clips = batch_preprocess(torch.from_numpy(pixel), "pytorchvideo", crop=SIZE)
    with torch.no_grad():
        ref = bce_with_logits(wide.double().train()(clips.double()),
                              torch.from_numpy(labels), POS_WEIGHT, torch.from_numpy(mask))
    assert abs(m["loss"].item() - ref.item()) <= 1e-5 * ref.item()
    assert abs(m["loss"].item() - float(jm["loss"])) <= 1e-3 * abs(float(jm["loss"]))
    assert m["correct"].item() == float(jm["correct"]) and m["count"].item() == 2.0
    np.testing.assert_allclose(m["probs"].numpy(), np.asarray(jm["probs"]), atol=1e-3)
    want = resnet50_lstm_state_dict_from_flax(jax.tree_util.tree_map(
        np.asarray, {"params": jstate.params, "batch_stats": jstate.batch_stats}))
    got = model.state_dict()
    for name, w in want.items():
        if name.endswith(("running_mean", "running_var")):
            a, b = got[name].numpy(), w.numpy()
            assert np.abs(a - b).max() <= 1e-4 * max(1.0, np.abs(b).max()), name
            assert not torch.equal(got[name], sd[name]), name
    for name, w in _trunk(dict(model.named_parameters())).items():
        assert torch.equal(w, sd[name]) and torch.equal(want[name], sd[name]), name
    assert not torch.equal(got["lstm.weight_hh_l1"], sd["lstm.weight_hh_l1"])


def test_bf16_logits_match_f32(port_f32, pixels):
    model = _port(torch.bfloat16, seed=None)
    model.load_state_dict(port_f32.state_dict())
    assert all(p.dtype == torch.float32 for p in model.parameters())
    x = torch.from_numpy(pixels)
    with torch.inference_mode():
        out, ref = model(x), port_f32(x)
    assert out.dtype == torch.float32
    assert (out - ref).abs().max().item() <= 3e-2 * max(1.0, ref.abs().max().item())


def test_dropout_draws_only_with_a_generator_in_train_mode(port_f32, pixels):
    """The LSTM's inter-layer dropout and the classifier's draw from the
    generator (reproducibly); without one, and in eval mode, none."""
    model = copy.deepcopy(port_f32)
    x = torch.from_numpy(pixels)
    with torch.no_grad():
        assert torch.equal(model(x, generator=torch.Generator().manual_seed(1)), model(x))
        plain = model.train()(x)
        a = model(x, generator=torch.Generator().manual_seed(1))
        b = model(x, generator=torch.Generator().manual_seed(1))
        c = model(x, generator=torch.Generator().manual_seed(2))
        feats = torch.randn(2, FRAMES, 2048, generator=torch.Generator().manual_seed(0))
        seq = model.lstm(feats)
        assert not torch.equal(model.lstm(feats, torch.Generator().manual_seed(1)), seq)
    assert torch.equal(a, b) and not torch.equal(a, plain) and not torch.equal(a, c)


# ---------- registry, checkpoint, CLIs ----------

def test_registry_spec_matches_jax():
    a, b = get_model_spec("resnet50_lstm"), jax_get_model_spec("resnet50_lstm")
    for field in ("preprocess_regime", "loss", "optimizer", "default_num_frames", "default_lr",
                  "default_weight_decay", "label_policy", "selection", "per_video_seed"):
        assert getattr(a, field) == getattr(b, field), field
    model = create_model("resnet50_lstm", num_classes=2, num_frames=4, image_size=32,
                         hidden_size=8, num_layers=1, dropout=0.1, stem_s2d=True, seed=None)
    assert model.config.hidden_size == 8 and model.config.dropout == 0.1
    assert model.lstm.weight_ih_l0.shape == (32, 2048) and model.lstm.num_layers == 1


def test_frozen_trunk_checkpoint_resume_matches_an_uninterrupted_run(port_f32, tmp_path):
    """Masked Adam: two steps straight, against one step, a checkpoint (the
    optimizer's state holds the LSTM and classifier only), a fresh model and
    optimizer resumed from it, and the second step: bitwise the same, the
    trunk bitwise where it started, its BN statistics moved. Then
    ``Predictor.from_checkpoint`` rebuilds the width from the metadata."""
    rng = np.random.default_rng(8)
    batches = [(torch.from_numpy(rng.standard_normal((2, FRAMES, SIZE, SIZE, 3)).astype(
        np.float32)), torch.tensor([1, 0])) for _ in range(2)]
    sd = port_f32.state_dict()

    def fresh():
        model = _port(dropout=0.0, seed=None)
        model.load_state_dict(sd)
        return st.create_train_state(model.train(), "adam", LR,
                                     trainable_mask=resnet.backbone_param_mask(model))

    def one(state, batch):
        loss = bce_with_logits(state.model(batch[0]), batch[1], POS_WEIGHT)
        state.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        state.optimizer.step()
        state.step += 1

    straight = fresh()
    for batch in batches:
        one(straight, batch)
    first = fresh()
    one(first, batches[0])
    ckpt.save_checkpoint(tmp_path / "ck", first, epoch=0, config={
        "model_kwargs": {"num_classes": 2, "hidden_size": HIDDEN, "num_layers": 2}})
    saved = torch.load(tmp_path / "ck" / "optimizer.pt", weights_only=True)
    assert len(saved["optimizer"]["state"]) == 8 + 4
    resumed = fresh()
    ckpt.load_checkpoint(tmp_path / "ck", resumed)
    one(resumed, batches[1])
    final = resumed.model.state_dict()
    for name, w in straight.model.state_dict().items():
        assert torch.equal(final[name], w), name
    for name in _trunk(dict(resumed.model.named_parameters())):
        assert torch.equal(final[name], sd[name]), name
    assert not torch.equal(final["resnet50.7.2.bn3.running_var"],
                           sd["resnet50.7.2.bn3.running_var"])
    predictor = Predictor.from_checkpoint("resnet50_lstm", tmp_path / "ck", num_frames=FRAMES,
                                          crop_size=SIZE, device="cpu")
    assert predictor.model.config.hidden_size == HIDDEN
    clip = np.random.default_rng(1).integers(0, 256, (2, FRAMES, 40, 48, 3), dtype=np.uint8)
    probs = predictor.predict_clip(clip)
    assert probs.shape == (2, 2) and np.allclose(probs.sum(-1), 1.0, atol=1e-6)


@pytest.mark.parametrize("name", ["resnet50_lstm", "resnet3d"])
def test_trainer_takes_the_spec_s_loss_freeze_and_plateau(name, tmp_path):
    """The trainer on this path: resnet50_lstm weighs BCE by the train
    split's 1.5 x negatives / positives, freezes the trunk (the optimizer
    holds the LSTM and classifier only) and runs the LR plateau, as the JAX
    trainer does (``laryngeal_tpu/train/trainer.py:67-80, 155``); resnet3d
    trains every parameter with CE and no plateau."""
    root = tmp_path / "data"
    make_synthetic_dataset(str(root), {"train": 3, "val": 1, "test": 1}, num_frames=6, h=32,
                           w=32, seed=5)
    spec = get_model_spec(name)
    loaders = create_dataloaders(str(root), num_frames=FRAMES, batch_size=2,
                                 resize_to=(SIZE, SIZE), label_policy=spec.label_policy,
                                 per_video_seed=spec.per_video_seed, num_workers=1)
    try:
        model = create_model(name, seed=None, hidden_size=HIDDEN)
        trainer = Trainer(model, spec, loaders, {"epochs": 1}, exp_dir=tmp_path / "exp",
                          device="cpu")
    finally:
        for loader in loaders.values():
            loader.close()
    labels = loaders["train"].dataset.labels
    held = [p for group in trainer.state.optimizer.param_groups for p in group["params"]]
    if name == "resnet50_lstm":
        pos = sum(labels)
        assert trainer.pos_weight == pytest.approx(1.5 * (len(labels) - pos) / pos)
        assert trainer.plateau is not None
        assert len(held) == 8 + 4
        assert not any(p.requires_grad for p in model.resnet50.parameters())
    else:
        assert trainer.pos_weight == 1.0 and trainer.plateau is None
        assert len(held) == len(list(model.parameters()))


def test_cli_trains_one_epoch_and_the_inference_cli_serves(tmp_path):
    """``cli.main --model resnet50_lstm`` on the CPU over tiny synthetic
    videos: one epoch with the JAX defaults (adam, lr 1e-3, BCE with the
    train split's pos_weight, composite selection, the LR plateau), the
    trunk frozen at its seeded init, the LSTM's width pinned in the
    checkpoint; then ``cli.inference`` on a video, and ``cli.serve``'s
    parser takes the family and its LSTM flags."""
    root = tmp_path / "data"
    make_synthetic_dataset(str(root), {"train": 3, "val": 1, "test": 2}, num_frames=10, h=40,
                           w=48, seed=4)
    out = cli.main(["--model", "resnet50_lstm", "--device", "cpu", "--data_dir", str(root),
                    "--log_dir", str(tmp_path / "logs"), "--num_frames", str(FRAMES),
                    "--crop_size", str(SIZE), "--batch_size", "2", "--epochs", "1",
                    "--hidden_size", str(HIDDEN), "--decode_workers", "1", "--no-pretrained"])
    exp = tmp_path / "logs" / out["exp_dir"].split("/")[-1]
    assert exp.name.startswith("resnet50_lstm-classifier")
    for f in ("best_model", "latest", "training_history.json", "test_metrics_uniform.json"):
        assert (exp / f).exists(), f
    assert np.isfinite(out["history"]["train_loss"][0]) and out["cm"].shape == (2, 2)
    meta = ckpt.read_metadata(exp / "latest")["config"]
    assert meta["model_kwargs"] == dict(num_classes=2, num_frames=FRAMES, image_size=SIZE,
                                        hidden_size=HIDDEN, num_layers=2, dropout=0.5)
    assert meta["learning_rate"] == 1e-3 and meta["weight_decay"] == 0.0
    saved = torch.load(exp / "latest" / "model.pt", weights_only=True)
    init = resnet.create_resnet50_lstm(hidden_size=HIDDEN, seed=42).state_dict()
    for name in resnet.backbone_param_mask(resnet.create_resnet50_lstm(hidden_size=HIDDEN,
                                                                       seed=None)):
        if name.startswith("resnet50."):
            assert torch.equal(saved[name], init[name]), name
    assert not torch.equal(saved["resnet50.1.running_mean"], init["resnet50.1.running_mean"])
    video = sorted((root / "test").rglob("*.mp4"))[0]
    result = cli_inference.main(["--model", "resnet50_lstm", "--model_path",
                                 str(exp / "latest"), "--video_path", str(video), "--device",
                                 "cpu", "--log_dir", str(tmp_path / "inf")])
    assert result["predicted_class"] in ("referral", "non_referral")
    assert abs(sum(result["probabilities"].values()) - 1.0) < 1e-5
    found = list((tmp_path / "inf").rglob("*_result.json"))
    assert len(found) == 1 and json.loads(found[0].read_text()) == result
    args = cli_serve.build_parser().parse_args(["--model", "resnet50_lstm", "--model_path",
                                                "ck", "--hidden_size", "16"])
    assert (args.model, args.hidden_size, args.num_layers) == ("resnet50_lstm", 16, None)
