"""The port's Trainer, Evaluator, checkpoints, resume and training CLI on a
tiny synthetic dataset, against the JAX package's Trainer and Evaluator from
the same weights. Both sides decode with cv2 (tests/test_torch_data.py says
why) and run in float32 on the CPU.

Tolerances: per-epoch train / val loss within 1e-4 relative of the JAX
history (f32 arithmetic in another order, through two epochs of AdamW);
accuracies, the learning rate and the evaluator's confusion matrix equal.
A resumed run reproduces the uninterrupted one to 1e-6 relative.
"""

import json
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from laryngeal_tpu.compat.torch_port import port_vivit
from laryngeal_tpu.data import native
from laryngeal_tpu.data.pipeline import create_dataloaders as jax_create_dataloaders
from laryngeal_tpu.evals.evaluator import Evaluator as JaxEvaluator
from laryngeal_tpu.models.registry import get_model_spec as jax_get_model_spec
from laryngeal_tpu.models.vivit import create_vivit as jax_create_vivit
from laryngeal_tpu.train import trainer as jax_trainer_module
from laryngeal_tpu.train.state import TrainState as JaxTrainState
from laryngeal_tpu.train.state import make_optimizer as jax_make_optimizer
from laryngeal_tpu.train.trainer import Trainer as JaxTrainer
from laryngeal_tpu_torch.cli import main as cli
from laryngeal_tpu_torch.compat.flax_weights import vivit_state_dict_from_flax
from laryngeal_tpu_torch.data.pipeline import create_dataloaders
from laryngeal_tpu_torch.data.synthetic import make_synthetic_dataset
from laryngeal_tpu_torch.evals.evaluator import Evaluator
from laryngeal_tpu_torch.infer.predictor import Predictor
from laryngeal_tpu_torch.models.registry import get_model_spec
from laryngeal_tpu_torch.models.vivit import create_vivit
from laryngeal_tpu_torch.train import checkpoint as ckpt
from laryngeal_tpu_torch.train.state import create_train_state
from laryngeal_tpu_torch.train.steps import make_train_step
from laryngeal_tpu_torch.train.trainer import Trainer

TINY = dict(hidden_size=32, num_layers=1, num_heads=2, intermediate_size=64)
FRAMES, SIZE = 4, 32
CONFIG = dict(epochs=2, batch_size=4, learning_rate=1e-3, weight_decay=0.01, crop_size=SIZE,
              patience=7, early_stopping_delta=0.001, seed=42, save_every=1)
CLI_FLAGS = ["--model", "vivit", "--device", "cpu", "--num_frames", str(FRAMES),
             "--crop_size", str(SIZE), "--hidden_size", "32", "--num_layers", "1",
             "--num_heads", "2", "--intermediate_size", "64", "--batch_size", "4",
             "--decode_workers", "1", "--no-pretrained"]


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    r = tmp_path_factory.mktemp("trainer_synth")
    make_synthetic_dataset(str(r), {"train": 3, "val": 2, "test": 2}, num_frames=10, h=40,
                           w=48, seed=3)
    return r


@pytest.fixture(scope="module")
def flax_params():
    """The JAX model and shared weights: the port's seeded init carried to
    Flax by the JAX package's own converter (no eager Flax init)."""
    weights = create_vivit(num_frames=FRAMES, image_size=SIZE, seed=1, **TINY).state_dict()
    return (jax_create_vivit(num_frames=FRAMES, image_size=SIZE, **TINY),
            port_vivit(weights, num_layers=TINY["num_layers"]))


def _loaders(root, make=create_dataloaders):
    return make(root, num_frames=FRAMES, batch_size=4, resize_to=(SIZE, SIZE), pad_last=True,
                num_workers=1)


def _port_trainer(root, flax_params, exp_dir, **config):
    model = create_vivit(num_frames=FRAMES, image_size=SIZE, seed=None, **TINY)
    model.load_state_dict(vivit_state_dict_from_flax(flax_params[1]))
    return Trainer(model, get_model_spec("vivit"), _loaders(root), {**CONFIG, **config},
                   exp_dir=exp_dir, device="cpu")


@pytest.fixture(scope="module")
def both_trained(root, flax_params, tmp_path_factory):
    """Two epochs of the JAX Trainer and the port's, from the same weights."""
    jmodel, params = flax_params

    def shared_state(model, rng, sample_input, optimizer, learning_rate, weight_decay,
                     trainable_mask_fn=None):
        tx = jax_make_optimizer(optimizer, learning_rate, weight_decay)
        jp = jax.tree_util.tree_map(jnp.asarray, params)
        return JaxTrainState(step=jnp.zeros((), jnp.int32), params=jp, opt_state=tx.init(jp),
                             batch_stats={}, tx=tx)

    mp = pytest.MonkeyPatch()
    mp.setattr(native, "available", lambda: False)
    mp.setattr(jax_trainer_module, "create_train_state", shared_state)
    try:
        jt = JaxTrainer(jmodel, jax_get_model_spec("vivit"),
                        _loaders(root, jax_create_dataloaders), CONFIG,
                        exp_dir=tmp_path_factory.mktemp("jax_run"))
        jt.train()
        pt = _port_trainer(root, flax_params, tmp_path_factory.mktemp("port_run"))
        pt.train()
        yield jt, pt
    finally:
        mp.undo()


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)


def test_trainer_history_matches_jax(both_trained):
    jt, pt = both_trained
    assert set(pt.history) == set(jt.history)
    for k in ("train_loss", "val_loss"):
        assert len(pt.history[k]) == len(jt.history[k]) == 2
        assert _rel(pt.history[k], jt.history[k]) <= 1e-4, k
    for k in ("train_acc", "val_acc"):
        assert pt.history[k] == jt.history[k], k
    assert pt.history["lr"] == pytest.approx(jt.history["lr"], rel=1e-7)  # JAX's is f32
    for f in ("best_model", "latest", "training_history.json", "training_config.json"):
        assert (pt.exp_dir / f).exists(), f
    assert json.loads((pt.exp_dir / "training_history.json").read_text()) == \
        json.loads(json.dumps(pt.history))
    assert set(json.loads((pt.exp_dir / "training_config.json").read_text())) == \
        set(json.loads((jt.exp_dir / "training_config.json").read_text()))


def test_evaluator_defaults_to_the_card(monkeypatch):
    """Like every entry of the port, Evaluator takes the card unless asked
    for the CPU by name, and raises on a host without one."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Evaluator(lambda *a: None, [])
    assert Evaluator(lambda *a: None, [], device="cpu").device == torch.device("cpu")


def test_evaluator_matches_jax(both_trained, root):
    jt, pt = both_trained
    mp = pytest.MonkeyPatch()
    mp.setattr(native, "available", lambda: False)
    try:
        jloaders = _loaders(root, jax_create_dataloaders)
        want = JaxEvaluator(jt.eval_step, jloaders["test"], exp_dir=jt.exp_dir).evaluate(jt.state)
    finally:
        mp.undo()
    got = Evaluator(pt.eval_step, pt.loaders["test"], exp_dir=pt.exp_dir,
                    device="cpu").evaluate(pt.state)
    assert got[0] == pytest.approx(want[0], abs=1e-9) and got[1] == pytest.approx(want[1])
    np.testing.assert_array_equal(got[2], want[2])
    a = json.loads((pt.exp_dir / "test_metrics_uniform.json").read_text())
    b = json.loads((jt.exp_dir / "test_metrics_uniform.json").read_text())
    assert set(a) == set(b)
    assert [v["label"] for v in a["per_video"]] == [v["label"] for v in b["per_video"]]
    assert [v["pred"] for v in a["per_video"]] == [v["pred"] for v in b["per_video"]]


def test_checkpoint_round_trip_with_optimizer_state(root, flax_params, tmp_path):
    """Saved after a step and loaded into a fresh state, the next step
    gives the same parameters as the state that never left memory."""
    batch = (torch.from_numpy(np.random.default_rng(0).integers(
        0, 256, (2, FRAMES, 40, 48, 3), dtype=np.uint8)), torch.tensor([0, 1]),
        torch.tensor([True, True]))

    def fresh():
        model = create_vivit(num_frames=FRAMES, image_size=SIZE, seed=None, **TINY)
        model.load_state_dict(vivit_state_dict_from_flax(flax_params[1]))
        return model, create_train_state(model, "adamw", 1e-3, 0.01)

    model, state = fresh()
    step = make_train_step(model, "vivit", "ce", crop=SIZE)
    step(state, *batch)
    ckpt.save_checkpoint(tmp_path / "ck", state, epoch=4, history={"val_loss": [1.0]},
                         config={"model_kwargs": dict(num_frames=FRAMES, **TINY)},
                         class_labels=["non_referral", "referral"])
    model2, state2 = fresh()
    restored = ckpt.load_checkpoint(tmp_path / "ck", state2)
    assert restored["epoch"] == 4 and restored["step"] == 1 and state2.step == 1
    assert restored["history"] == {"val_loss": [1.0]}
    step(state, *batch)
    make_train_step(model2, "vivit", "ce", crop=SIZE)(state2, *batch)
    for (n, a), b in zip(model.state_dict().items(), model2.state_dict().values()):
        assert torch.equal(a, b), n
    # A model-only checkpoint (the serving contract) has no optimizer file.
    ckpt.save_checkpoint(tmp_path / "weights", model.state_dict())
    assert not (tmp_path / "weights" / ckpt.OPTIMIZER_FILE).exists()
    assert ckpt.load_checkpoint(tmp_path / "weights")["step"] is None


def test_resume_reproduces_uninterrupted_run(root, flax_params, tmp_path):
    straight = _port_trainer(root, flax_params, tmp_path / "straight")
    straight.train()
    first = _port_trainer(root, flax_params, tmp_path / "interrupted", epochs=1)
    first.train()
    second = _port_trainer(root, flax_params, tmp_path / "resumed")
    assert second.resume(tmp_path / "interrupted" / "latest") == 1
    assert second.state.step == first.state.step
    second.train()
    for k in ("train_loss", "val_loss", "train_acc", "val_acc", "lr"):
        assert _rel(second.history[k], straight.history[k]) <= 1e-6, k
    # The weights after epoch 2 (the final model is the reloaded best one).
    a = ckpt.load_checkpoint(tmp_path / "straight" / "latest")
    b = ckpt.load_checkpoint(tmp_path / "resumed" / "latest")
    assert a["step"] == b["step"] == 2 * len(straight.loaders["train"])
    for n, w in a["state_dict"].items():
        assert _rel(b["state_dict"][n].numpy(), w.numpy()) <= 1e-6, n


def test_find_resume_checkpoint_prefers_newest(tmp_path):
    assert ckpt.find_resume_checkpoint(tmp_path / "none", "vivit") is None
    for name in ("vivit-classifier-a/best_model", "vivit-classifier-b/latest"):
        ckpt.save_checkpoint(tmp_path / name, {"w": torch.zeros(1)})
        time.sleep(0.01)
    assert ckpt.find_resume_checkpoint(tmp_path, "vivit").endswith("vivit-classifier-b/latest")


def test_cli_trains_resumes_evaluates_and_serves(root, tmp_path):
    log_dir = tmp_path / "logs"
    out = cli.main(CLI_FLAGS + ["--data_dir", str(root), "--log_dir", str(log_dir),
                                "--epochs", "1"])
    exp = log_dir / out["exp_dir"].split("/")[-1]
    for f in ("best_model", "latest", "training_history.json", "test_metrics_uniform.json"):
        assert (exp / f).exists(), f
    assert len(out["history"]["train_loss"]) == 1 and out["cm"].shape == (2, 2)
    time.sleep(1.1)  # experiment dirs are stamped to the second
    again = cli.main(CLI_FLAGS + ["--data_dir", str(root), "--log_dir", str(log_dir),
                                  "--epochs", "2", "--resume", "auto"])
    assert again["exp_dir"] != out["exp_dir"]
    assert again["history"]["train_loss"][0] == out["history"]["train_loss"][0]
    assert len(again["history"]["train_loss"]) == 2
    meta = ckpt.read_metadata(exp / "best_model")
    assert "dtype" not in meta["config"]["model_kwargs"]
    predictor = Predictor.from_checkpoint("vivit", exp / "best_model", device="cpu")
    assert next(predictor.model.parameters()).dtype == torch.float32
    clip = np.random.default_rng(1).integers(0, 256, (2, FRAMES, 40, 48, 3), dtype=np.uint8)
    probs = predictor.predict_clip(clip)
    assert probs.shape == (2, 2) and np.allclose(probs.sum(-1), 1.0, atol=1e-6)


def test_cli_runs_the_training_options(root, flax_params, tmp_path):
    """--grad_accum_steps 2 --remat --torch_weights --clip_cache_dir
    --profile_dir on the CPU: the weights file is what the run starts from,
    every clip lands in the cache and a second run decodes none, and the
    profiler writes a Chrome trace."""
    from laryngeal_tpu_torch.data import dataset as port_dataset

    weights = create_vivit(num_frames=FRAMES, image_size=SIZE, seed=5, **TINY).state_dict()
    torch.save({"model_state_dict": weights}, tmp_path / "w.pth")
    flags = CLI_FLAGS + ["--data_dir", str(root), "--epochs", "1", "--grad_accum_steps", "2",
                         "--remat", "--torch_weights", str(tmp_path / "w.pth"),
                         "--clip_cache_dir", str(tmp_path / "cache"),
                         "--profile_dir", str(tmp_path / "prof")]
    out = cli.main(flags + ["--log_dir", str(tmp_path / "logs")])
    exp = tmp_path / "logs" / out["exp_dir"].split("/")[-1]
    log = (exp / "experiment.log").read_text()
    assert "Loaded torch weights from" in log and "PRETRAINED WEIGHTS UNAVAILABLE" not in log
    meta = ckpt.read_metadata(exp / "best_model")
    assert meta["config"]["grad_accum_steps"] == 2 and meta["config"]["model_kwargs"]["remat"]
    assert len(list((tmp_path / "cache").glob("*.npy"))) == 2 * (3 + 2 + 2)  # 2 classes
    traces = list((tmp_path / "prof").glob("*.pt.trace.json"))
    assert len(traces) == 1 and '"traceEvents"' in traces[0].read_text()
    assert np.isfinite(out["history"]["train_loss"]).all()

    decoded = []
    real = port_dataset.decode_frames
    mp = pytest.MonkeyPatch()
    mp.setattr(port_dataset, "decode_frames", lambda *a, **k: decoded.append(a) or real(*a, **k))
    try:
        time.sleep(1.1)  # experiment dirs are stamped to the second
        cli.main(flags + ["--log_dir", str(tmp_path / "logs2"), "--no_cache_clips"])
    finally:
        mp.undo()
    assert decoded == []


def test_profiling_timer_block_and_a_trace_that_cannot_start(tmp_path, monkeypatch):
    """``StepTimer`` summarises as the JAX one does; ``block`` and
    ``trace(None)`` are no-ops on the CPU; a profiler that cannot start is
    an error when the card is traced, and a no-op otherwise."""
    from laryngeal_tpu.utils.profiling import StepTimer as JaxStepTimer
    from laryngeal_tpu_torch.utils import profiling

    port, ref = profiling.StepTimer(warmup=1, items_per_step=8), JaxStepTimer(1, 8)
    for timer in (port, ref):
        timer._count = 1
        timer.times = [0.5, 0.25, 0.75, 1.0]
    assert port.summary() == ref.summary()
    with profiling.StepTimer(warmup=0) as timer:
        profiling.block(torch.ones(2))
        profiling.block()
    assert timer.summary()["steps"] == 1
    with profiling.trace(None) as prof:
        assert prof is None

    def refuse(self):
        raise RuntimeError("no CUPTI")

    monkeypatch.setattr(torch.profiler.profile, "start", refuse)
    with pytest.raises(RuntimeError, match="did not start on the card"):
        with profiling.trace(tmp_path / "card", cuda=True):
            pass
    with profiling.trace(tmp_path / "host", cuda=False) as prof:
        assert prof is None


@pytest.mark.parametrize("flags,match", [
    (["--fsdp"], "not yet ported"),
    (["--model", "resnet50_lstm", "--remat"], "transformer families"),
    (["--grad_accum_steps", "3"], "must be divisible"),
    (["--wire", "i420"], "not yet ported"),
    (["--mesh_model", "2"], "not yet ported"),
    (["--model", "swin3d", "--mesh_seq", "2"], "not yet ported"),
    (["--model", "resnet3d", "--remat"], "transformer families")],
    ids=["fsdp", "remat", "grad_accum", "wire", "mesh", "swin3d", "resnet3d"])
def test_cli_refuses_unported_flags(flags, match, tmp_path):
    """Unported flags, and (as the JAX CLI refuses them) --remat on a CNN
    family and a batch that does not split into --grad_accum_steps, are
    refused before the experiment directory exists."""
    with pytest.raises(SystemExit, match=match):
        cli.main(CLI_FLAGS + ["--data_dir", str(tmp_path), "--log_dir",
                              str(tmp_path / "logs")] + flags)
    assert not (tmp_path / "logs").exists()


def test_cli_defaults_to_the_card(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = cli.build_parser().parse_args(["--model", "vivit", "--data_dir", str(tmp_path)])
    assert args.device == "cuda"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.run(args)
