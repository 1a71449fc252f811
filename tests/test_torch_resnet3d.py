"""Port 3D-ResNet50 (slow_r50) against the JAX ResNet3D: weights carried
across by the JAX package's ``port_resnet3d`` and the port's
``compat.flax_weights.resnet3d_state_dict_from_flax`` (both directions),
inputs from ``numpy.random.default_rng``. Also the port's BatchNorm against
Flax's, the pytorchvideo names against the JAX suite's plain-torch
``TorchSlowR50``, the train step on a padded batch, bf16, dropout, the
checkpoint, the training CLI and ``Predictor.from_checkpoint``.

Full width and depth (the JAX converters read stages (3, 4, 6, 3)) at 4
frames of 32^2, B = 2: the last stage is 1x1 (8 elements a channel in its
BatchNorm) and the head pool clamps to (4, 1, 1), as
``tests/test_resnet3d_train_parity.py`` clamps it at 64^2.

Training is held in float64 on both sides. In float32, at the JAX test's
size (B = 2 at 64 px, 32 elements a channel in the last stage's BatchNorm),
the two frameworks' step-0 gradients differ by a median 4% (relative L2 per
tensor), and torch's own float32 gradients sit 1.7% from its float64 ones:
the backward amplifies round-off. In float64 they agree to ~1e-8.

Tolerances: f32 eval logits 1e-4 x max(1, max |logit|); float64 step-0
gradients 1e-6 relative L2 per parameter tensor (against JAX through the
head's float64 output, and the port's through its float32 logits against
those); three float64 Adam steps:
losses 1e-6 relative, every parameter tensor and BN running statistic 1e-6
relative L2, with the loss taken on the head's float64 output (both models
cast their logits to float32; through that cast the float32 loss sets a
floor of ~1e-2 after three steps, see ``f64_run``); bf16 logits
3e-2 x max(1, max |logit|) of the f32 ones.
"""

import copy

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from laryngeal_tpu.compat.torch_port import port_resnet3d
from laryngeal_tpu.models.registry import get_model_spec as jax_get_model_spec
from laryngeal_tpu.models.resnet3d import create_resnet3d as jax_create_resnet3d
from laryngeal_tpu.train.losses import cross_entropy as jax_cross_entropy
from laryngeal_tpu.train.state import TrainState as JaxTrainState
from laryngeal_tpu.train.state import make_optimizer as jax_make_optimizer
from laryngeal_tpu.train.steps import make_train_step as jax_make_train_step
from laryngeal_tpu_torch.cli import main as cli
from laryngeal_tpu_torch.compat.flax_weights import resnet3d_state_dict_from_flax
from laryngeal_tpu_torch.data.synthetic import make_synthetic_dataset
from laryngeal_tpu_torch.infer.predictor import Predictor
from laryngeal_tpu_torch.models import layers
from laryngeal_tpu_torch.models.registry import create_model, get_model_spec
from laryngeal_tpu_torch.models.resnet3d import create_resnet3d
from laryngeal_tpu_torch.train import checkpoint as ckpt
from laryngeal_tpu_torch.train import state as st
from laryngeal_tpu_torch.train import steps
from laryngeal_tpu_torch.train.losses import cross_entropy
from tests.test_resnet3d_parity import TorchSlowR50

FRAMES, SIZE = 4, 32
LR = 1e-3


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """The suite runs files in parallel workers: torch's default of one
    thread a core in each of them oversubscribes the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _perturb(model, seed):
    """Move every BN scale, bias and statistic off its init, so eval-mode
    normalisation and every weight matter."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, layers.BatchNorm):
                n = m.num_features
                m.weight.add_(0.1 * torch.randn(n, generator=g, dtype=m.weight.dtype))
                m.bias.add_(0.1 * torch.randn(n, generator=g, dtype=m.bias.dtype))
                m.running_mean.add_(0.05 * torch.randn(n, generator=g, dtype=m.weight.dtype))
                m.running_var.copy_(0.7 + 0.7 * torch.rand(n, generator=g,
                                                            dtype=m.weight.dtype))
        proj = model.blocks[5].proj
        proj.bias.add_(0.1 * torch.randn(proj.bias.shape, generator=g, dtype=proj.bias.dtype))
    return model


def _tree(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-300))


@pytest.fixture(scope="module")
def port_f32():
    return _perturb(create_resnet3d(seed=0), 1)


@pytest.fixture(scope="module")
def pixels():
    return np.random.default_rng(2).standard_normal((2, FRAMES, SIZE, SIZE, 3)).astype(
        np.float32)


# ---------- eval: logits, names, converters ----------

@pytest.mark.parametrize("stem_s2d", [True, False], ids=["s2d_stem", "direct_stem"])
def test_eval_logits_match_jax(port_f32, pixels, stem_s2d):
    """The JAX model's default space-to-depth stem and its direct one, both
    against the port's direct stem."""
    variables = _tree(port_resnet3d(dict(port_f32.state_dict())))
    ref = np.asarray(jax_create_resnet3d(stem_s2d=stem_s2d).apply(variables,
                                                                   jnp.asarray(pixels)))
    with torch.inference_mode():
        out = port_f32(torch.from_numpy(pixels))
    assert out.dtype == torch.float32 and out.shape == (2, 2)
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-4 * max(1.0, np.abs(ref).max()),
                               rtol=0)


def test_pytorchvideo_names_and_eval_logits_match_plain_torch(port_f32, pixels):
    """The port's state_dict loads into the JAX suite's plain-torch
    reimplementation of pytorchvideo's slow_r50 (``nn.BatchNorm3d``, the head
    pool clamped to the features) and gives its eval logits."""
    hf = TorchSlowR50(num_classes=2).eval()
    hf.blocks[5].pool = torch.nn.AvgPool3d((4, 1, 1), stride=1)
    sd = port_f32.state_dict()
    assert {k: tuple(v.shape) for k, v in sd.items()} == {
        k: tuple(v.shape) for k, v in hf.state_dict().items()}
    hf.load_state_dict(sd)
    x = torch.from_numpy(pixels)
    with torch.inference_mode():
        np.testing.assert_allclose(port_f32(x).numpy(), hf(x.permute(0, 4, 1, 2, 3)).numpy(),
                                   atol=1e-5, rtol=0)


def test_state_dict_round_trips_through_both_converters(port_f32):
    """port_resnet3d(state_dict) -> resnet3d_state_dict_from_flax gives back
    every tensor, BN statistics included; and the other way round."""
    sd = port_f32.state_dict()
    variables = port_resnet3d(dict(sd))
    back = resnet3d_state_dict_from_flax(variables)
    assert set(back) == set(sd)
    for name, w in sd.items():
        assert torch.equal(back[name], w), name
    again = port_resnet3d(dict(back))
    flat_a = dict(jax.tree_util.tree_flatten_with_path(variables)[0])
    flat_b = jax.tree_util.tree_flatten_with_path(again)[0]
    assert len(flat_a) == len(flat_b) == 53 * 2 + 53 * 2 + 53 + 2  # BN (2 + 2), convs, proj
    for path, b in flat_b:
        np.testing.assert_array_equal(np.asarray(b), np.asarray(flat_a[path]))


def test_flax_weights_are_copied(port_f32):
    variables = port_resnet3d(dict(port_f32.state_dict()))
    before = np.asarray(variables["batch_stats"]["stem_bn"]["var"]).copy()
    resnet3d_state_dict_from_flax(variables)["blocks.0.norm.running_var"].add_(1.0)
    np.testing.assert_array_equal(variables["batch_stats"]["stem_bn"]["var"], before)


# ---------- BatchNorm: Flax's running-variance rule ----------

@pytest.mark.parametrize("dtype", [torch.float32, torch.float64, torch.bfloat16], ids=str)
def test_batchnorm_matches_flax_and_differs_from_torch_by_n_over_n_minus_1(dtype):
    """Train mode: the output and the running statistics of flax's
    BatchNorm(momentum 0.9, eps 1e-5), whose variance update takes the
    biased batch variance; torch's nn.BatchNorm3d takes the unbiased one.
    bf16: statistics in f32, output in bf16, as Flax's."""
    rng = np.random.default_rng(3)
    x = (1.5 * rng.standard_normal((2, 6, 2, 3, 3)) + 0.3).astype(np.float64)  # n = 36
    scale, bias = rng.standard_normal(6) * 0.2 + 1.0, rng.standard_normal(6) * 0.2
    mean0, var0 = rng.standard_normal(6) * 0.1, rng.uniform(0.5, 1.5, 6)
    wide = torch.float64 if dtype == torch.float64 else torch.float32
    bn = layers.BatchNorm(6, dtype).to(wide).train()
    with torch.no_grad():
        for t, v in ((bn.weight, scale), (bn.bias, bias), (bn.running_mean, mean0),
                     (bn.running_var, var0)):
            t.copy_(torch.from_numpy(v))
    xt = torch.from_numpy(x).to(dtype)
    y = bn(xt)
    assert y.dtype == dtype and bn.running_var.dtype == wide
    assert bn.num_batches_tracked.item() == 1

    jdt = {torch.float32: jnp.float32, torch.float64: jnp.float64,
           torch.bfloat16: jnp.bfloat16}[dtype]
    with jax.enable_x64(dtype == torch.float64):
        fbn = fnn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5,
                            dtype=jdt, param_dtype=jnp.float64 if wide == torch.float64
                            else jnp.float32)
        xj = jnp.asarray(xt.float().numpy() if dtype == torch.bfloat16 else xt.numpy(),
                         jdt).transpose(0, 2, 3, 4, 1)
        pdt = np.float64 if wide == torch.float64 else np.float32
        variables = {"params": {"scale": scale.astype(pdt), "bias": bias.astype(pdt)},
                     "batch_stats": {"mean": mean0.astype(pdt), "var": var0.astype(pdt)}}
        yj, upd = fbn.apply(variables, xj, mutable=["batch_stats"])
        yj = np.asarray(yj.astype(jnp.float32 if dtype != torch.float64 else jnp.float64))
        stats = {k: np.asarray(v) for k, v in upd["batch_stats"].items()}
    tol = {torch.float32: 1e-5, torch.float64: 1e-12, torch.bfloat16: 2e-2}[dtype]
    np.testing.assert_allclose(y.to(wide).detach().numpy(), yj.transpose(0, 4, 1, 2, 3),
                               atol=tol, rtol=0)
    stat_tol = 1e-12 if dtype == torch.float64 else 1e-6
    np.testing.assert_allclose(bn.running_mean.numpy(), stats["mean"], atol=stat_tol, rtol=0)
    np.testing.assert_allclose(bn.running_var.numpy(), stats["var"], atol=stat_tol, rtol=0)

    ref = torch.nn.BatchNorm3d(6, momentum=0.1).to(wide).train()
    with torch.no_grad():
        ref.running_var.copy_(torch.from_numpy(var0))
    ref(xt.to(wide))
    n = x.size // 6
    batch_var = (ref.running_var - 0.9 * torch.from_numpy(var0).to(wide)) / 0.1
    ours = (bn.running_var - 0.9 * torch.from_numpy(var0).to(wide)) / 0.1
    np.testing.assert_allclose((batch_var / ours).numpy(), n / (n - 1),
                               rtol=1e-4 if dtype != torch.float32 else 1e-4)


def test_batchnorm_eval_uses_the_running_statistics():
    bn = layers.BatchNorm(4)
    with torch.no_grad():
        bn.running_mean.copy_(torch.tensor([0.5, -1.0, 0.0, 2.0]))
        bn.running_var.copy_(torch.tensor([4.0, 1.0, 0.25, 9.0]))
    x = torch.randn(3, 4, 5, generator=torch.Generator().manual_seed(0))
    want = (x - bn.running_mean[:, None]) / torch.sqrt(bn.running_var[:, None] + 1e-5)
    torch.testing.assert_close(bn.eval()(x), want, atol=1e-6, rtol=0)
    assert bn.num_batches_tracked.item() == 0


# ---------- training in float64 against JAX ----------

def head_capture_jax(name):
    """An interceptor for ``flax.linen.intercept_methods`` storing the output
    of the submodule ``name`` (the float64 head, before the model's cast of
    its logits to float32) in the returned dict."""
    store = {}

    def interceptor(fn, args, kwargs, context):
        out = fn(*args, **kwargs)
        if context.module.name == name:
            store["out"] = out
        return out

    return interceptor, store


def head_capture_port(module):
    """A forward hook storing ``module``'s output, and the dict it fills."""
    store = {}
    module.register_forward_hook(lambda m, args, out: store.__setitem__("out", out))
    return store


def ce64_port(z, y, mask):
    nll = -torch.log_softmax(z, -1).gather(-1, y[:, None])[:, 0]
    m = mask.to(z.dtype)
    return (nll * m).sum() / m.sum().clamp(min=1.0)


def ce64_jax(z, y, mask):
    nll = -jnp.take_along_axis(jax.nn.log_softmax(z, -1), y[:, None], -1)[:, 0]
    m = mask.astype(z.dtype)
    return (nll * m).sum() / jnp.maximum(m.sum(), 1.0)


@pytest.fixture(scope="module")
def f64_run():
    """Float64 on both sides, from the port's weights, on batches of 2 clips,
    the third a padded last batch (its second row a copy of the first, masked
    out, as the loader pads): three Adam steps whose CE loss is taken in
    float64 on the head's output, before the models' cast of their logits to
    float32; and the port's step-0 gradients through that cast and its own
    float32 CE loss.

    Through the cast, the float32 rounding of the loss's gradient (~1e-7 of
    each gradient tensor) moves gradient elements near Adam's eps = 1e-8 by
    several percent, the first update by up to 1.3e-5 of a tensor, and the
    ill-conditioned backward amplifies that to 1.8e-2 of the next
    gradients: at 64^2 three steps ended 0.9% apart (relative L2 of a
    parameter tensor) and the third loss 4.5e-4 apart. Without it the sides
    stay within 6e-8.

    Returns the gradients, per-step losses and final state of each side."""
    port = _perturb(create_resnet3d(seed=0, dtype=torch.float64, dropout=0.0), 1).double()
    variables = port_resnet3d(dict(port.state_dict()))
    rng = np.random.default_rng(4)
    batches = []
    for i in range(3):
        x = rng.standard_normal((2, FRAMES, SIZE, SIZE, 3))
        mask = np.array([True, i < 2])
        if i == 2:
            x[1] = x[0]
        batches.append(tuple(map(torch.from_numpy, (x, rng.integers(0, 2, 2), mask))))

    # The port: the model, its loss and the optimizer, as the train step runs them.
    twin = copy.deepcopy(port).train()
    cross_entropy(twin(batches[0][0]), batches[0][1], batches[0][2]).backward()
    cast_grads = {n: p.grad for n, p in twin.named_parameters()}
    head = head_capture_port(port.blocks[5].proj)
    state = st.create_train_state(port.train(), "adam", LR)
    port_losses, port_grads = [], None
    for x, y, mask in batches:
        port(x)
        loss = ce64_port(head["out"].mean(dim=(1, 2, 3)), y, mask)
        state.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        port_grads = port_grads or {n: p.grad.clone() for n, p in port.named_parameters()}
        state.optimizer.step()
        port_losses.append(loss.item())

    with jax.enable_x64(True):
        model = jax_create_resnet3d(dropout=0.0, dtype=jnp.float64, stem_s2d=False)
        params, stats = _tree(variables["params"]), _tree(variables["batch_stats"])
        tx = jax_make_optimizer("adam", LR)
        opt_state = tx.init(params)

        def loss_fn(p, stats, x, y, mask):
            interceptor, store = head_capture_jax("proj")
            with fnn.intercept_methods(interceptor):
                _, upd = model.apply({"params": p, "batch_stats": stats}, x, train=True,
                                     mutable=["batch_stats"])
            return ce64_jax(store["out"].mean(axis=(1, 2, 3)), y, mask), upd["batch_stats"]

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
    return dict(port=port, port_grads=port_grads, cast_grads=cast_grads,
                port_losses=port_losses, jax_grads=jax_grads, jax_losses=jax_losses,
                jax_final=final)


def _zero_stats(params):
    """Batch stats of the right tree shape (the converter reads them)."""
    out = {}
    for k, v in params.items():
        if isinstance(v, dict) and "scale" in v:
            out[k] = {"mean": np.zeros_like(v["scale"]), "var": np.zeros_like(v["scale"])}
        elif isinstance(v, dict) and any(isinstance(w, dict) for w in v.values()):
            out[k] = _zero_stats(v)
    return out


def test_step0_gradients_match_jax_in_float64(f64_run):
    """Every parameter's step-0 gradient against JAX's, both through the
    head's float64 output; and the port's through its float32 logits and CE
    loss against those (JAX's through its cast measured 4.2e-7 at most,
    median 3.4e-7, from the port's through the port's cast)."""
    want = resnet3d_state_dict_from_flax({"params": f64_run["jax_grads"],
                                          "batch_stats": _zero_stats(f64_run["jax_grads"])})
    grads = f64_run["port_grads"]
    assert len(grads) == 53 * 3 + 2
    for got, name in ((grads, "jax"), (f64_run["cast_grads"], "cast")):
        errs = {n: _rel_l2(got[n].numpy(), want[n].numpy()) for n in grads}
        worst = max(errs, key=errs.get)
        assert errs[worst] <= 1e-6, (name, worst, errs[worst])


def test_three_adam_steps_match_jax_in_float64(f64_run):
    """Losses, then every parameter tensor and every BN running mean and
    variance (the last stage's included) after the third step."""
    for a, b in zip(f64_run["port_losses"], f64_run["jax_losses"]):
        assert abs(a - b) <= 1e-6 * max(1.0, abs(b)), (f64_run["port_losses"],
                                                      f64_run["jax_losses"])
    final = f64_run["jax_final"]
    want = {k: v.numpy() for k, v in resnet3d_state_dict_from_flax(final).items()}
    got = f64_run["port"].state_dict()
    n_stats = 0
    for name, w in want.items():
        if name.endswith("num_batches_tracked"):
            assert got[name].item() == 3, name
            continue
        assert _rel_l2(got[name].numpy(), w) <= 1e-6, (name, _rel_l2(got[name].numpy(), w))
        n_stats += name.endswith(("running_mean", "running_var"))
    assert n_stats == 2 * 53
    last = "blocks.4.res_blocks.2.branch2.norm_c.running_var"
    assert np.abs(got[last].numpy() - 1.0).max() > 1e-3  # moved by the batches

# ---------- the train step, bf16, dropout ----------

def test_train_step_on_a_padded_batch_matches_jax(port_f32, monkeypatch):
    """The port's train step and the JAX one (pytorchvideo regime,
    LARYNGEAL_NO_AUGMENT=1, dropout 0) on one uint8 batch of 3 clips whose
    last row is padding: the loss (f32, within 1e-5 relative), correct /
    count, the probabilities, and every BN running statistic, which both
    sides take over all 3 rows, within 1e-4 x max(1, max |statistic|) per
    tensor (a float32 forward 50 layers deep, as the logits). At 64^2: at
    32^2 (12 elements a channel in the last stage's BatchNorm) the float32
    train-mode forward is ill-conditioned, both sides' losses 2-4e-4 from
    the float64 one. The parameters after the f32 update are not held (see
    the module docstring)."""
    monkeypatch.setenv("LARYNGEAL_NO_AUGMENT", "1")
    rng = np.random.default_rng(7)
    pixel = rng.integers(0, 256, (3, FRAMES, 72, 80, 3), dtype=np.uint8)
    pixel[2] = pixel[1]
    labels, mask = np.array([0, 1, 1], np.int32), np.array([True, True, False])

    sd = port_f32.state_dict()
    variables = port_resnet3d(dict(sd))
    jmodel = jax_create_resnet3d(dropout=0.0)
    tx = jax_make_optimizer("adam", LR)
    params = _tree(variables["params"])
    jstate = JaxTrainState(step=jnp.zeros((), jnp.int32), params=params,
                           opt_state=tx.init(params),
                           batch_stats=_tree(variables["batch_stats"]), tx=tx)
    jstate, jm = jax_make_train_step(jmodel, "pytorchvideo", "ce", crop=64)(
        jstate, jnp.asarray(pixel), jnp.asarray(labels), jnp.asarray(mask),
        jax.random.PRNGKey(0))

    model = create_resnet3d(seed=None, dropout=0.0)
    model.load_state_dict(sd)
    state = st.create_train_state(model, "adam", LR)
    state, m = steps.make_train_step(model, "pytorchvideo", "ce", crop=64, seed=0)(
        state, torch.from_numpy(pixel), torch.from_numpy(labels.astype(np.int64)),
        torch.from_numpy(mask))
    assert abs(m["loss"].item() - float(jm["loss"])) <= 1e-5 * abs(float(jm["loss"]))
    assert m["correct"].item() == float(jm["correct"]) and m["count"].item() == 2.0
    np.testing.assert_allclose(m["probs"].numpy(), np.asarray(jm["probs"]), atol=1e-5)
    want = resnet3d_state_dict_from_flax({"params": jax.tree_util.tree_map(
        np.asarray, jstate.params), "batch_stats": jax.tree_util.tree_map(
        np.asarray, jstate.batch_stats)})
    got = model.state_dict()
    for name, w in want.items():
        if name.endswith(("running_mean", "running_var")):
            a, b = got[name].numpy(), w.numpy()
            assert np.abs(a - b).max() <= 1e-4 * max(1.0, np.abs(b).max()), name
            assert not torch.equal(got[name], sd[name]), name


def test_bf16_logits_match_f32(port_f32, pixels):
    model = create_resnet3d(seed=None, dtype=torch.bfloat16)
    model.load_state_dict(port_f32.state_dict())
    assert all(p.dtype == torch.float32 for p in model.parameters())
    x = torch.from_numpy(pixels)
    with torch.inference_mode():
        out, ref = model(x), port_f32(x)
    assert out.dtype == torch.float32
    scale = max(1.0, ref.abs().max().item())
    assert (out - ref).abs().max().item() <= 3e-2 * scale


def test_head_dropout_draws_only_with_a_generator_in_train_mode(port_f32, pixels):
    """Train mode with a generator drops (reproducibly from its seed);
    without one, and in eval mode, none. BN runs on the batch in train mode
    either way, so the comparison is against train mode without dropout."""
    model = copy.deepcopy(port_f32)
    x = torch.from_numpy(pixels)
    with torch.no_grad():
        assert torch.equal(model(x, generator=torch.Generator().manual_seed(1)), model(x))
        plain = model.train()(x)
        a = model(x, generator=torch.Generator().manual_seed(1))
        b = model(x, generator=torch.Generator().manual_seed(1))
        c = model(x, generator=torch.Generator().manual_seed(2))
    assert torch.equal(a, b) and not torch.equal(a, plain) and not torch.equal(a, c)


# ---------- registry, checkpoint, CLI ----------

def test_registry_spec_matches_jax():
    a, b = get_model_spec("resnet3d"), jax_get_model_spec("resnet3d")
    for field in ("preprocess_regime", "loss", "optimizer", "default_num_frames", "default_lr",
                  "default_weight_decay", "label_policy", "selection", "per_video_seed"):
        assert getattr(a, field) == getattr(b, field), field
    model = create_model("resnet3d", num_classes=3, num_frames=4, image_size=32, dropout=0.2,
                         stem_s2d=True, seed=None)
    assert model.config.num_classes == 3 and model.config.dropout == 0.2
    assert model.blocks[5].proj.weight.shape == (3, 2048)


def test_checkpoint_resume_matches_an_uninterrupted_run(port_f32, tmp_path):
    """Two Adam steps straight, against one step, a checkpoint (weights, BN
    buffers, Adam moments, step), a fresh model and optimizer resumed from it,
    and the second step: bitwise the same."""
    rng = np.random.default_rng(8)
    batches = [(torch.from_numpy(rng.standard_normal((2, FRAMES, 32, 32, 3)).astype(
        np.float32)), torch.from_numpy(rng.integers(0, 2, 2))) for _ in range(2)]

    def fresh():
        model = create_resnet3d(seed=None, dropout=0.0)
        model.load_state_dict(port_f32.state_dict())
        return st.create_train_state(model.train(), "adam", LR)

    def one(state, batch):
        loss = cross_entropy(state.model(batch[0]), batch[1])
        state.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        state.optimizer.step()
        state.step += 1

    straight = fresh()
    for batch in batches:
        one(straight, batch)
    first = fresh()
    one(first, batches[0])
    ckpt.save_checkpoint(tmp_path / "ck", first, epoch=0, config={"model_kwargs": {}})
    resumed = fresh()
    ckpt.load_checkpoint(tmp_path / "ck", resumed)
    assert resumed.step == 1
    one(resumed, batches[1])
    for (name, a), b in zip(straight.model.state_dict().items(),
                            resumed.model.state_dict().values()):
        assert torch.equal(a, b), name
    predictor = Predictor.from_checkpoint("resnet3d", tmp_path / "ck", num_frames=FRAMES,
                                          crop_size=32, device="cpu")
    for name, w in first.model.state_dict().items():
        assert torch.equal(predictor.model.state_dict()[name], w), name


def test_cli_trains_one_epoch_and_predictor_serves(tmp_path):
    """``cli.main --model resnet3d`` on the CPU over tiny synthetic videos:
    one epoch with the JAX defaults (adam, lr 1e-3, loss/acc selection,
    per-video seeded sampling with its index audit, dropout pinned in the
    checkpoint), then ``Predictor.from_checkpoint`` on best_model/ with
    clip-averaged eval's sampler."""
    root = tmp_path / "data"
    make_synthetic_dataset(str(root), {"train": 3, "val": 1, "test": 2}, num_frames=10, h=40,
                           w=48, seed=4)
    out = cli.main(["--model", "resnet3d", "--device", "cpu", "--data_dir", str(root),
                    "--log_dir", str(tmp_path / "logs"), "--num_frames", str(FRAMES),
                    "--crop_size", "32", "--batch_size", "2", "--epochs", "1",
                    "--dropout", "0.3", "--test_sampling", "random", "--eval_clips", "2",
                    "--decode_workers", "1", "--no-pretrained"])
    exp = tmp_path / "logs" / out["exp_dir"].split("/")[-1]
    assert exp.name.startswith("resnet3d-classifier")
    for f in ("best_model", "latest", "training_history.json", "test_metrics_random.json"):
        assert (exp / f).exists(), f
    audit = exp / "sampled_frames_train_uniform.csv"
    assert audit.exists(), sorted(p.name for p in exp.iterdir())
    assert np.isfinite(out["history"]["train_loss"][0]) and out["cm"].shape == (2, 2)
    meta = ckpt.read_metadata(exp / "best_model")["config"]
    assert meta["model_kwargs"] == dict(num_classes=2, num_frames=FRAMES, image_size=32,
                                        dropout=0.3)
    assert meta["learning_rate"] == 1e-3 and meta["weight_decay"] == 0.0
    saved = torch.load(exp / "best_model" / "optimizer.pt", weights_only=True)
    assert len(saved["optimizer"]["state"]) == 53 * 3 + 2
    predictor = Predictor.from_checkpoint("resnet3d", exp / "best_model", device="cpu")
    assert predictor.model.config.dropout == 0.3 and predictor.sampler.per_video_seed
    clip = np.random.default_rng(1).integers(0, 256, (2, FRAMES, 40, 48, 3), dtype=np.uint8)
    probs = predictor.predict_clip(clip)
    assert probs.shape == (2, 2) and np.allclose(probs.sum(-1), 1.0, atol=1e-6)


@pytest.mark.parametrize("name", ["resnet3d", "resnet50_lstm"])
def test_entry_points_default_to_the_card(name, tmp_path, monkeypatch):
    """Without a card the CLI, the Predictor and the Trainer refuse to run
    unless given the CPU: nothing falls back to it."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = cli.build_parser().parse_args(["--model", name, "--data_dir", str(tmp_path)])
    assert args.device == "cuda"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.run(args)
    model = create_model(name, seed=None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Predictor(model, get_model_spec(name))
    assert Predictor(model, get_model_spec(name), device="cpu").device.type == "cpu"
