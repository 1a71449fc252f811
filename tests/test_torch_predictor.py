"""Port Predictor against the JAX Predictor (same Flax weights, same uint8
clip), checkpoints, video decode, the CLIs and the device rule."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

cv2 = pytest.importorskip("cv2")

from laryngeal_tpu.data.synthetic import synth_video
from laryngeal_tpu.data.video import write_video
from laryngeal_tpu.infer.predictor import Predictor as JaxPredictor
from laryngeal_tpu.models.registry import get_model_spec as jax_spec
from laryngeal_tpu.models.vivit import VivitConfig as JaxVivitConfig
from laryngeal_tpu.models.vivit import VivitForVideoClassification as JaxVivit
from laryngeal_tpu.train.losses import binary_probs_from_logit as jax_binary_probs
from laryngeal_tpu.train.state import create_train_state
from laryngeal_tpu_torch.cli import inference as cli_inference
from laryngeal_tpu_torch.compat.flax_weights import vivit_state_dict_from_flax
from laryngeal_tpu_torch.data import samplers, video
from laryngeal_tpu_torch.infer.predictor import Predictor
from laryngeal_tpu_torch.models.registry import get_model_spec
from laryngeal_tpu_torch.models.vivit import create_vivit
from laryngeal_tpu_torch.train import losses
from laryngeal_tpu_torch.train.checkpoint import load_checkpoint, save_checkpoint

KW = dict(hidden_size=32, num_layers=1, num_heads=2, intermediate_size=64)
FRAMES, SIZE = 4, 64
LABELS = ["non_referral", "referral"]


@pytest.fixture(scope="module")
def jax_predictor():
    spec = jax_spec("vivit")
    model = JaxVivit(JaxVivitConfig(image_size=SIZE, num_frames=FRAMES, **KW))
    state = create_train_state(
        model, jax.random.PRNGKey(0), jnp.zeros((1, FRAMES, SIZE, SIZE, 3)),
        optimizer=spec.optimizer, learning_rate=1e-3, weight_decay=0.01)
    rng = np.random.default_rng(5)
    params = jax.tree_util.tree_map(
        lambda p: np.asarray(p) + 0.05 * rng.standard_normal(p.shape).astype(np.float32),
        state.params)
    state = state.replace(params=params)
    return JaxPredictor(model, spec, state, num_frames=FRAMES, crop_size=SIZE)


@pytest.fixture(scope="module")
def port_model(jax_predictor):
    model = create_vivit(num_frames=FRAMES, image_size=SIZE, seed=None, **KW)
    model.load_state_dict(vivit_state_dict_from_flax(jax_predictor.state.params))
    return model


@pytest.fixture(scope="module")
def predictor(port_model):
    return Predictor(port_model, get_model_spec("vivit"), num_frames=FRAMES,
                     crop_size=SIZE, device="cpu")


@pytest.fixture(scope="module")
def video_path(tmp_path_factory):
    p = tmp_path_factory.mktemp("port_video") / "clip.mp4"
    write_video(p, synth_video(np.random.default_rng(3), 12, 64, 64, referral=True), fps=30)
    return p


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory, port_model):
    path = tmp_path_factory.mktemp("port_ckpt") / "best_model"
    save_checkpoint(path, port_model.state_dict(), epoch=3,
                    config={"model_kwargs": dict(num_frames=FRAMES, image_size=SIZE, **KW)},
                    class_labels=LABELS)
    return path


@pytest.mark.parametrize("batch", [1, 3])
def test_predict_clip_matches_jax(jax_predictor, predictor, batch):
    clip = np.random.default_rng(batch).integers(0, 256, (batch, FRAMES, SIZE, SIZE, 3),
                                                 dtype=np.uint8)
    ref = jax_predictor.predict_clip(clip)
    out = predictor.predict_clip(clip)
    assert out.shape == (batch, 2)
    np.testing.assert_allclose(out, ref, atol=1e-5)


def test_predict_clip_unbatched_and_bad_shape(predictor):
    clip = np.zeros((FRAMES, SIZE, SIZE, 3), np.uint8)
    assert predictor.predict_clip(clip).shape == (1, 2)
    with pytest.raises(ValueError):
        predictor.predict_clip(np.zeros((SIZE, SIZE, 3), np.uint8))


def test_predict_video_matches_jax(jax_predictor, predictor, video_path):
    ref = jax_predictor.predict_video(video_path)
    out = predictor.predict_video(video_path)
    assert set(out) == set(ref)
    for key in ("predicted_class", "class_id", "frame_indices", "total_frames",
                "class_mapping", "num_frames", "sampling_method"):
        assert out[key] == ref[key], key
    for c in LABELS:
        assert abs(out["probabilities"][c] - ref["probabilities"][c]) < 1e-5


def test_predict_videos_skips_unreadable(predictor, video_path, tmp_path):
    bad = tmp_path / "broken.mp4"
    bad.write_bytes(b"not a video")
    res = predictor.predict_videos([str(video_path), str(bad), str(video_path)],
                                   batch_size=2)
    assert len(res) == 2
    single = predictor.predict_video(video_path)
    assert res[0]["probabilities"] == pytest.approx(single["probabilities"], abs=1e-5)
    path = predictor.save_sampled_frames(tmp_path)
    assert path and open(path).read().startswith("video_filename")


def test_checkpoint_round_trip(checkpoint, port_model, predictor):
    restored = load_checkpoint(checkpoint)
    assert restored["epoch"] == 3 and restored["class_labels"] == LABELS
    meta = json.loads((checkpoint / "metadata.json").read_text())
    assert meta["id2label"] == {"0": LABELS[0], "1": LABELS[1]}
    assert meta["label2id"] == {LABELS[0]: 0, LABELS[1]: 1}
    for k, v in port_model.state_dict().items():
        assert torch.equal(restored["state_dict"][k], v), k
    loaded = Predictor.from_checkpoint("vivit", checkpoint, device="cpu")
    assert (loaded.num_frames, loaded.crop_size) == (FRAMES, SIZE)
    clip = np.random.default_rng(9).integers(0, 256, (2, FRAMES, SIZE, SIZE, 3), np.uint8)
    np.testing.assert_array_equal(loaded.predict_clip(clip), predictor.predict_clip(clip))


def test_checkpoint_metadata_precedence(checkpoint, tmp_path, port_model):
    """model_kwargs from the metadata reach the model (num_classes included);
    explicit caller arguments win over them."""
    path = tmp_path / "three_class"
    model = create_vivit(num_frames=FRAMES, image_size=SIZE, num_classes=3, **KW)
    save_checkpoint(path, model.state_dict(), config={"model_kwargs": dict(
        num_frames=FRAMES, image_size=SIZE, num_classes=3, **KW)})
    loaded = Predictor.from_checkpoint("vivit", path, device="cpu")
    assert loaded.model.config.num_classes == 3
    assert loaded.class_labels == LABELS  # default labels when none were saved
    clip = np.zeros((1, FRAMES, SIZE, SIZE, 3), np.uint8)
    assert loaded.predict_clip(clip).shape == (1, 3)
    bf16 = Predictor.from_checkpoint("vivit", checkpoint, device="cpu",
                                     model_kwargs={"dtype": "bfloat16", "layer_norm_eps": 1e-5})
    assert bf16.model.config.dtype == torch.bfloat16
    assert bf16.model.config.layer_norm_eps == 1e-5


@pytest.mark.parametrize("saved,asked,want", [
    (None, None, torch.float32),
    ("bfloat16", None, torch.bfloat16),
    ("bfloat16", "float32", torch.float32),
    (None, "bfloat16", torch.bfloat16),
])
def test_checkpoint_metadata_sets_compute_dtype(port_model, tmp_path, saved, asked, want):
    """The compute dtype comes from model_kwargs: the caller's over the
    metadata's, float32 when neither names one. Parameters stay float32."""
    kwargs = dict(num_frames=FRAMES, image_size=SIZE, **KW)
    if saved:
        kwargs["dtype"] = saved
    save_checkpoint(tmp_path / "ckpt", port_model.state_dict(), config={"model_kwargs": kwargs})
    loaded = Predictor.from_checkpoint("vivit", tmp_path / "ckpt", device="cpu",
                                       model_kwargs={"dtype": asked} if asked else None)
    assert loaded.model.config.dtype == want
    assert all(p.dtype == torch.float32 for p in loaded.model.parameters())


def test_predictor_defaults_to_cuda(port_model, checkpoint, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Predictor(port_model, get_model_spec("vivit"), num_frames=FRAMES, crop_size=SIZE)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Predictor.from_checkpoint("vivit", checkpoint)
    # The wires are ported (tests/test_torch_wire.py): refused is what the
    # JAX predictor refuses, an unknown wire and a dct geometry that is not
    # a multiple of 16.
    with pytest.raises(ValueError, match="Unknown wire format"):
        Predictor(port_model, get_model_spec("vivit"), wire="nope", device="cpu")
    with pytest.raises(ValueError, match="multiples of 16"):
        Predictor(port_model, get_model_spec("vivit"), crop_size=40, wire="dct", device="cpu")


def test_cli_inference_single_and_batch(checkpoint, video_path, tmp_path, capsys):
    args = ["--model", "vivit", "--model_path", str(checkpoint), "--device", "cpu",
            "--log_dir", str(tmp_path / "logs")]
    result = cli_inference.main(args + ["--video_path", str(video_path)])
    assert result["predicted_class"] in LABELS and result["num_frames"] == FRAMES
    results = cli_inference.main(args + ["--video_dir", str(video_path.parent)])
    assert len(results) == 1
    assert results[0]["probabilities"] == pytest.approx(result["probabilities"], abs=1e-5)
    assert cli_inference.build_parser().parse_args([]).device == "cuda"


def test_decode_matches_jax_decode(video_path):
    from laryngeal_tpu.data.video import decode_frames as jax_decode
    from laryngeal_tpu.data.video import get_video_properties as jax_props

    assert video.get_video_properties(video_path) == jax_props(video_path)
    idx = [0, 0, 3, 7, 11, 11]
    np.testing.assert_array_equal(video.decode_frames(video_path, idx, (32, 32)),
                                  jax_decode(video_path, idx, (32, 32)))
    with pytest.raises(ValueError):
        video.decode_frames(video_path, [])


@pytest.mark.parametrize("method", ["uniform", "random", "random_window"])
def test_sampler_copy_matches_jax(method):
    from laryngeal_tpu.data.samplers import FrameSampler as JaxSampler

    for per_video in (False, True):
        a = samplers.FrameSampler(method, 8, per_video_seed=per_video)
        b = JaxSampler(method, 8, per_video_seed=per_video)
        for path, total in (("a.mp4", 100), ("b.mp4", 5), ("c.mp4", 8)):
            assert a(path, total) == b(path, total)


def test_probs_fn_matches_jax():
    logits = np.random.default_rng(0).standard_normal((4, 2)).astype(np.float32)
    np.testing.assert_allclose(losses.probs_fn("ce")(torch.from_numpy(logits)).numpy(),
                               np.asarray(jax.nn.softmax(jnp.asarray(logits), -1)), atol=1e-7)
    one = logits[:, :1]
    np.testing.assert_allclose(losses.probs_fn("bce_pos_weight")(torch.from_numpy(one)).numpy(),
                               np.asarray(jax_binary_probs(jnp.asarray(one))), atol=1e-7)
    with pytest.raises(ValueError):
        losses.probs_fn("mse")
