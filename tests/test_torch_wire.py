"""The port's host->device wire formats (i420, delta, dct, dctp) against the
JAX package's, from the host encoders through the dataset, the loader, the
Predictor, the train step and the CLIs, on numpy inputs from a seed and
``mp4v`` files at small sizes (T <= 4, 32 x 32 to 64 x 48 frames, a 2-layer
ViViT of width 32).

Limits:
- tables, numpy encoders, nibble pack / unpack, temporal deltas, the I420
  conversion and the dataset / loader payloads (tuples leaf by leaf, on the
  native and the cv2 decode routes): bitwise;
- the i420 / delta decode heads: within 1e-3 of 255 levels (measured 0);
- the dct / dctp heads: every element within 2 levels, all but 1e-3 of them
  within 1e-3. Where torch's and XLA's IDCT sums land on opposite sides of
  a rounding boundary, a plane sample moves by one level, which the BT.601
  matrix turns into 1.16 levels of R, G and B (Y), 1.60 of R (V) or 2.02 of
  B (U, past the 2-level limit). Measured here: no such flip, max 3.05e-5
  (float round-off), in these cases and on four 8-frame 224^2 clips;
- Predictor probabilities through each wire: within 1e-4 of the JAX
  Predictor's in f32, on weights carried across by ``compat/flax_weights``;
- one train step on a dctp payload, at grad_accum 1 and 2: the tolerances
  of ``tests/test_torch_train.py`` (loss 1e-5 relative, probabilities 1e-5,
  each parameter tensor after AdamW within 1e-5 relative L2, the key biases
  within 3 lr per step and side).
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from laryngeal_tpu.compat.torch_port import port_vivit
from laryngeal_tpu.data import native as jax_native
from laryngeal_tpu.data.dataset import VideoDataset as JaxVideoDataset
from laryngeal_tpu.data.pipeline import ClipLoader as JaxClipLoader
from laryngeal_tpu.infer.predictor import Predictor as JaxPredictor
from laryngeal_tpu.models.registry import get_model_spec as jax_spec
from laryngeal_tpu.models.vivit import create_vivit as jax_create_vivit
from laryngeal_tpu.preprocess import dct_wire as jdw
from laryngeal_tpu.preprocess import transforms as jt
from laryngeal_tpu.train.state import TrainState as JaxTrainState
from laryngeal_tpu.train.state import make_optimizer as jax_make_optimizer
from laryngeal_tpu.train.steps import make_train_step as jax_make_train_step
from laryngeal_tpu_torch.cli import inference as cli_inference
from laryngeal_tpu_torch.cli import main as cli
from laryngeal_tpu_torch.cli import serve as cli_serve
from laryngeal_tpu_torch.compat.flax_weights import vivit_state_dict_from_flax
from laryngeal_tpu_torch.data import native
from laryngeal_tpu_torch.data.dataset import VideoDataset
from laryngeal_tpu_torch.data.pipeline import ClipLoader
from laryngeal_tpu_torch.data.synthetic import make_synthetic_dataset, synth_video
from laryngeal_tpu_torch.data.video import rgb_to_yuv420, write_video
from laryngeal_tpu_torch.infer.predictor import Predictor
from laryngeal_tpu_torch.models.registry import get_model_spec
from laryngeal_tpu_torch.models.vivit import create_vivit
from laryngeal_tpu_torch.preprocess import dct_wire as tdw
from laryngeal_tpu_torch.preprocess import transforms as tt
from laryngeal_tpu_torch.train import state as st
from laryngeal_tpu_torch.train import steps

TINY = dict(hidden_size=32, num_layers=2, num_heads=2, intermediate_size=64)
FRAMES, SIZE = 4, 32
WIRES = ("rgb", "i420", "delta", "dct", "dctp")


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    r = tmp_path_factory.mktemp("wire_synth")
    make_synthetic_dataset(str(r), {"train": 2, "val": 1, "test": 1}, num_frames=12, h=48,
                           w=64, seed=6)
    return r


def _rgb(shape, seed):
    return np.random.default_rng(seed).integers(0, 256, shape, dtype=np.uint8)


def _i420_batch(b=2, t=3, h=48, w=64, seed=0):
    """I420 clips of real-looking frames (the synthetic writer's) and of
    noise, which saturates the int8 planes."""
    rng = np.random.default_rng(seed)
    clips = [synth_video(rng, t, h, w, referral=bool(i % 2)) for i in range(b - 1)]
    clips.append(_rgb((t, h, w, 3), seed))
    return np.stack([rgb_to_yuv420(c) for c in clips])


# ---------- host encoders ----------

def test_tables_and_geometry_match_jax():
    for name in ("ZIGZAG", "JPEG_LUMA_Q50", "JPEG_CHROMA_Q50"):
        np.testing.assert_array_equal(getattr(tdw, name), getattr(jdw, name))
    for q in (1, 10, 49, 50, 51, 75, 87, 100):
        for base in (tdw.JPEG_LUMA_Q50, tdw.JPEG_CHROMA_Q50):
            np.testing.assert_array_equal(tdw.quant_table(base, q), jdw.quant_table(base, q))
    for bad in (0, 101):
        with pytest.raises(ValueError):
            tdw.quant_table(tdw.JPEG_LUMA_Q50, bad)
    np.testing.assert_array_equal(tdw._idct_kron(), jdw._idct_kron())
    for hw in ((48, 64), (32, 32), (224, 224)):
        assert tdw.block_geometry(*hw) == jdw.block_geometry(*hw)
        np.testing.assert_array_equal(tdw._dequant_scales(*hw, 75), jdw._dequant_scales(*hw, 75))
    with pytest.raises(ValueError, match="multiples of 16"):
        tdw.block_geometry(40, 48)
    assert (tdw.DEFAULT_QUALITY, tdw.DEFAULT_KEEP_AC, tdw.DEFAULT_PACK_FROM) == \
        (jdw.DEFAULT_QUALITY, jdw.DEFAULT_KEEP_AC, jdw.DEFAULT_PACK_FROM)


@pytest.mark.parametrize("quality,keep_ac,pack_from", [(75, 31, 14), (75, 15, 8), (87, 63, 0),
                                                        (30, 9, 9), (90, 20, 7)])
@pytest.mark.parametrize("route", ["native", "numpy"])
def test_host_encoders_match_jax_bitwise(monkeypatch, quality, keep_ac, pack_from, route):
    """encode_clip(_np / _packed), pack / unpack and the host decode, with
    the native library (both packages') and without it (numpy)."""
    if route == "numpy":
        monkeypatch.setattr(native, "available", lambda: False)
        monkeypatch.setattr(jax_native, "available", lambda: False)
    i420 = _i420_batch(b=2, seed=quality)[1]
    for got, want in ((tdw.encode_clip_np(i420, quality, keep_ac),
                       jdw.encode_clip_np(i420, quality, keep_ac)),
                      (tdw.encode_clip(i420, quality, keep_ac),
                       jdw.encode_clip(i420, quality, keep_ac)),
                      (tdw.encode_clip_packed(i420, quality, keep_ac, pack_from),
                       jdw.encode_clip_packed(i420, quality, keep_ac, pack_from))):
        assert len(got) == len(want)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    dc, ac = tdw.encode_clip(i420, quality, keep_ac)
    hi, pk = tdw.pack_ac_planes(ac, pack_from)
    np.testing.assert_array_equal(tdw.unpack_ac_planes(hi, pk, keep_ac),
                                  jdw.unpack_ac_planes(hi, pk, keep_ac))
    np.testing.assert_array_equal(tdw.unpack_ac_planes(hi, pk, keep_ac)[:pack_from],
                                  ac[:pack_from])
    np.testing.assert_array_equal(tdw.decode_clip_np(dc, ac, 48, 64, quality),
                                  jdw.decode_clip_np(dc, ac, 48, 64, quality))


def test_delta_and_i420_conversion_match_jax():
    rgb = _rgb((3, 32, 48, 3), seed=1)
    i420 = rgb_to_yuv420(rgb)
    from laryngeal_tpu.data.video import rgb_to_yuv420 as jax_rgb_to_yuv420

    np.testing.assert_array_equal(i420, jax_rgb_to_yuv420(rgb))
    assert i420.shape == (3, 48, 48)
    batch = _i420_batch(b=3, t=4, h=32, w=32)
    delta = np.stack([tt.temporal_delta_encode(c) for c in batch])
    np.testing.assert_array_equal(delta, np.stack([jt.temporal_delta_encode(c) for c in batch]))
    got = tt.temporal_delta_decode(torch.from_numpy(delta), axis=1)
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), batch)
    np.testing.assert_array_equal(
        tt.temporal_delta_decode(torch.from_numpy(delta[0])).numpy(),
        np.asarray(jt.temporal_delta_decode(jnp.asarray(delta[0]))))


# ---------- the device decode heads ----------

def _payload(wire, batch, quality=75, keep_ac=31, pack_from=14):
    """A (B, T, H*3/2, W) I420 batch as the wire's batched host payload."""
    if wire == "i420":
        return batch
    if wire == "delta":
        return np.stack([tt.temporal_delta_encode(c) for c in batch])
    if wire == "dct":
        parts = [tdw.encode_clip(c, quality, keep_ac) for c in batch]
    else:
        parts = [tdw.encode_clip_packed(c, quality, keep_ac, pack_from) for c in batch]
    return tuple(np.stack([p[i] for p in parts]) for i in range(len(parts[0])))


def _as(payload, fn):
    return tuple(fn(x) for x in payload) if isinstance(payload, tuple) else fn(payload)


@pytest.mark.parametrize("wire,quality,keep_ac,pack_from", [
    ("i420", 75, 31, 14), ("delta", 75, 31, 14), ("dct", 75, 31, 14), ("dct", 90, 63, 14),
    ("dct", 40, 5, 14), ("dctp", 75, 31, 14), ("dctp", 75, 15, 8), ("dctp", 87, 63, 0),
    ("dctp", 60, 20, 20)])
def test_decode_heads_match_jax(wire, quality, keep_ac, pack_from):
    batch = _i420_batch(b=3, t=3, h=48, w=64, seed=keep_ac)
    payload = _payload(wire, batch, quality, keep_ac, pack_from)
    got = tt.decode_wire_batch(_as(payload, torch.from_numpy), wire, (48, 64), quality, keep_ac)
    want = np.asarray(jt.decode_wire_batch(_as(payload, jnp.asarray), wire, (48, 64), quality,
                                           keep_ac))
    assert got.dtype == torch.float32 and got.shape == (3, 3, 48, 64, 3) == want.shape
    diff = np.abs(got.numpy() - want)
    if wire in ("i420", "delta"):
        assert diff.max() <= 1e-3
        return
    assert diff.max() <= 2.0 and (diff > 1e-3).mean() <= 1e-3, (diff.max(), (diff > 1e-3).mean())
    # One clip decodes as its row of the batch.
    one = (tdw.decode_to_rgb(*(torch.from_numpy(x[1]) for x in payload), 48, 64, quality)
           if wire == "dct" else
           tdw.decode_to_rgb_packed(*(torch.from_numpy(x[1]) for x in payload), 48, 64,
                                    quality, keep_ac))
    torch.testing.assert_close(one, got[1], rtol=0, atol=0)


def test_dct_decode_is_the_host_reconstruction():
    """The device head's planes are the host inverse's uint8 I420: decoded
    through the i420 head, ``decode_clip_np``'s clip gives the dct head's RGB
    within float round-off."""
    batch = _i420_batch(b=2, t=2, h=32, w=48, seed=3)
    dc, ac = _payload("dct", batch)
    recon = np.stack([tdw.decode_clip_np(d, a, 32, 48, 75) for d, a in zip(dc, ac)])
    via_i420 = tt.decode_wire_batch(torch.from_numpy(recon), "i420")
    via_dct = tt.decode_wire_batch((torch.from_numpy(dc), torch.from_numpy(ac)), "dct", (32, 48))
    assert (via_i420 - via_dct).abs().max().item() <= 2.0
    assert ((via_i420 - via_dct).abs() > 1e-3).float().mean().item() <= 1e-3


# ---------- dataset and loader ----------

@pytest.fixture
def decode_route(request, monkeypatch):
    if request.param == "cv2":
        monkeypatch.setattr(native, "available", lambda: False)
        monkeypatch.setattr(jax_native, "available", lambda: False)
    return request.param


def _assert_payload_equal(got, want):
    assert type(got) is type(want)
    if isinstance(want, tuple):
        assert len(got) == len(want)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    else:
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("decode_route", ["native", "cv2"], indirect=True)
@pytest.mark.parametrize("wire,lowres", [("rgb", 0), ("i420", 0), ("delta", 0), ("dct", 0),
                                         ("dctp", 0), ("i420", 1), ("dctp", 1)])
def test_dataset_payloads_match_jax(root, decode_route, wire, lowres):
    kw = dict(num_frames=FRAMES, resize_to=(SIZE, SIZE), wire=wire, wire_quality=80,
              wire_keep_ac=20, wire_pack_from=9, wire_lowres=lowres)
    a, b = VideoDataset(root, "train", **kw), JaxVideoDataset(root, "train", **kw)
    if wire != "rgb":
        assert a.wire_wh == b.wire_wh == (SIZE >> lowres, SIZE >> lowres)
    assert a.wire_lowres == b.wire_lowres
    for i in range(len(a)):
        x, y = a[i], b[i]
        assert x["frame_indices"] == y["frame_indices"]
        _assert_payload_equal(x["pixel_values"], y["pixel_values"])
    _assert_payload_equal(a._placeholder_clip(), b._placeholder_clip())
    _assert_payload_equal(a.rgb_clip(0, indices=a[0]["frame_indices"]),
                          b.rgb_clip(0, indices=b[0]["frame_indices"]))


@pytest.mark.parametrize("decode_route", ["native", "cv2"], indirect=True)
def test_loader_stacks_payload_tuples_like_jax(root, decode_route):
    kw = dict(num_frames=FRAMES, resize_to=(SIZE, SIZE), wire="dctp", wire_keep_ac=15,
              wire_pack_from=8)
    lkw = dict(batch_size=3, shuffle=True, seed=4, pad_last=True, num_workers=2)
    a = ClipLoader(VideoDataset(root, "train", **kw), **lkw)
    b = JaxClipLoader(JaxVideoDataset(root, "train", **kw), **lkw)
    got, want = list(a), list(b)
    a.close()
    assert len(got) == len(want) == 2
    for x, y in zip(got, want):
        assert x["video_paths"] == y["video_paths"]
        np.testing.assert_array_equal(x["mask"], y["mask"])
        _assert_payload_equal(x["pixel_values"], y["pixel_values"])
    dc, hi, pk = got[-1]["pixel_values"]
    assert dc.shape[0] == hi.shape[0] == pk.shape[0] == 3 and hi.shape[1] == 8
    pixel, _, _ = steps.prepare_batch(got[-1], "cpu")
    assert isinstance(pixel, tuple) and [p.dtype for p in pixel] == [torch.int16, torch.int8,
                                                                     torch.uint8]


def test_disk_cache_keys_the_wire_and_lowres_and_skips_the_dct_wires(root, tmp_path,
                                                                     monkeypatch):
    """The port reads an i420 lowres cache the JAX dataset wrote (the same
    key: path, indices, resize, wire, wire_lowres) without decoding; the
    dct wires keep nothing on disk, as in the JAX package."""
    kw = dict(num_frames=FRAMES, resize_to=(SIZE, SIZE), wire="i420", wire_lowres=1,
              cache_clips=False, cache_dir=tmp_path / "c")
    jds = JaxVideoDataset(root, "train", **kw)
    want = [jds[i]["pixel_values"] for i in range(len(jds))]
    assert len(list((tmp_path / "c").glob("*.npy"))) == len(jds)
    monkeypatch.setattr(native, "decode_frames_auto",
                        lambda *a, **k: pytest.fail("the port decoded a cached clip"))
    ds = VideoDataset(root, "train", **kw)
    for i in range(len(ds)):
        np.testing.assert_array_equal(ds[i]["pixel_values"], want[i])
    monkeypatch.undo()
    kw.update(wire="dct", wire_lowres=0, cache_dir=tmp_path / "d")
    ds = VideoDataset(root, "train", **kw)
    assert isinstance(ds[0]["pixel_values"], tuple)
    assert not list((tmp_path / "d").glob("*.npy"))


# ---------- the Predictor ----------

@pytest.fixture(scope="module")
def weights():
    """JAX ViViT params (a JAX init, perturbed so every weight matters) and
    the port's state_dict of them (``compat/flax_weights``)."""
    from laryngeal_tpu.train.state import create_train_state

    model = jax_create_vivit(num_frames=FRAMES, image_size=SIZE, **TINY)
    state = create_train_state(model, jax.random.PRNGKey(0),
                               jnp.zeros((1, FRAMES, SIZE, SIZE, 3)), optimizer="adamw",
                               learning_rate=1e-3, weight_decay=0.01)
    rng = np.random.default_rng(5)
    params = jax.tree_util.tree_map(
        lambda p: np.asarray(p) + 0.05 * rng.standard_normal(p.shape).astype(np.float32),
        state.params)
    return model, params, vivit_state_dict_from_flax(params)


def _predictors(weights, **wire_kw):
    jmodel, params, state_dict = weights
    jp = JaxPredictor(jmodel, jax_spec("vivit"), types.SimpleNamespace(params=params,
                                                                       batch_stats={}),
                      num_frames=FRAMES, crop_size=SIZE, **wire_kw)
    model = create_vivit(num_frames=FRAMES, image_size=SIZE, seed=None, **TINY)
    model.load_state_dict(state_dict)
    pp = Predictor(model, get_model_spec("vivit"), num_frames=FRAMES, crop_size=SIZE,
                   device="cpu", **wire_kw)
    return jp, pp


@pytest.fixture(scope="module")
def mp4v_path(tmp_path_factory):
    path = tmp_path_factory.mktemp("wire_video") / "clip.mp4"
    assert write_video(path, synth_video(np.random.default_rng(8), 12, 48, 64, True)) == "mp4v"
    return path


@pytest.mark.parametrize("wire,lowres", [(w, 0) for w in WIRES] + [("i420", 1)])
def test_predictor_wires_match_jax(weights, mp4v_path, wire, lowres):
    """RGB and I420 clips and a video through each wire: the JAX
    Predictor's probabilities within 1e-4 (both decode natively)."""
    jp, pp = _predictors(weights, wire=wire, wire_quality=80, wire_keep_ac=31,
                         wire_pack_from=14, wire_lowres=lowres)
    assert pp.wire_lowres == jp.wire_lowres and pp._wire_hw() == jp._wire_hw()
    rgb = _rgb((2, FRAMES, SIZE, SIZE, 3), seed=11)
    got, want = pp.predict_clip(rgb), np.asarray(jp.predict_clip(rgb))
    assert got.shape == (2, 2) and np.allclose(got.sum(-1), 1.0, atol=1e-6)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    if wire != "rgb":
        i420 = np.stack([rgb_to_yuv420(c) for c in rgb[:, :, :SIZE >> lowres, :SIZE >> lowres]])
        np.testing.assert_allclose(pp.predict_clip(i420), np.asarray(jp.predict_clip(i420)),
                                   atol=1e-4, rtol=0)
        np.testing.assert_allclose(pp.predict_clip(i420[0]), pp.predict_clip(i420)[:1],
                                   atol=1e-6, rtol=0)
    clip, idx, total = pp.extract_clip_with_indices(mp4v_path)
    jclip, jidx, jtotal = jp.extract_clip_with_indices(mp4v_path)
    assert (idx, total) == (jidx, jtotal)
    np.testing.assert_array_equal(clip, jclip)
    out, ref = pp.predict_video(mp4v_path), jp.predict_video(mp4v_path)
    for c in ref["probabilities"]:
        assert abs(out["probabilities"][c] - ref["probabilities"][c]) <= 1e-4
    # Batch mode decodes with decode_frames_auto on every wire, rgb too.
    batch = pp.predict_videos([str(mp4v_path)] * 3, batch_size=2)
    jbatch = jp.predict_videos([str(mp4v_path)] * 3, batch_size=2)
    assert len(batch) == len(jbatch) == 3
    for r, q in zip(batch, jbatch):
        assert r["frame_indices"] == q["frame_indices"]
        for c in q["probabilities"]:
            assert abs(r["probabilities"][c] - q["probabilities"][c]) <= 1e-4


def test_predict_clip_shape_dispatch_matches_jax(weights):
    jp, pp = _predictors(weights, wire="dct")
    for shape in ((FRAMES, SIZE, SIZE, 1), (2, FRAMES, SIZE, SIZE, 4), (SIZE, SIZE),
                  (1, 2, FRAMES, SIZE, SIZE, 3)):
        x = np.zeros(shape, np.uint8)
        with pytest.raises(ValueError):
            pp.predict_clip(x)
        with pytest.raises(ValueError):
            jp.predict_clip(x)
    _, rgb_pp = _predictors(weights)
    with pytest.raises(ValueError, match="rgb wire expects"):
        rgb_pp.predict_clip(np.zeros((FRAMES, SIZE * 3 // 2, SIZE), np.uint8))


# ---------- the train step on a dctp payload ----------

def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)


def _rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


@pytest.mark.parametrize("grad_accum", [1, 2])
def test_dctp_train_step_matches_jax(grad_accum):
    weights = create_vivit(num_frames=FRAMES, image_size=SIZE, seed=0, **TINY).state_dict()
    rng = np.random.default_rng(1)
    params = jax.tree_util.tree_map(
        lambda p: p + 0.02 * rng.standard_normal(p.shape).astype(np.float32),
        port_vivit(weights, num_layers=TINY["num_layers"]))
    i420 = np.stack([rgb_to_yuv420(c) for c in _rgb((4, FRAMES, SIZE, SIZE, 3), seed=2)])
    payload = _payload("dctp", i420, 75, 15, 8)
    labels = np.array([0, 1, 1, 0], np.int32)
    mask = np.array([True, True, True, False])
    wire_kw = dict(wire="dctp", wire_hw=(SIZE, SIZE), wire_quality=75, wire_keep_ac=15)

    tx = jax_make_optimizer("adamw", 1e-3, 0.01)
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    jstate = JaxTrainState(step=jnp.zeros((), jnp.int32), params=jparams,
                           opt_state=tx.init(jparams), batch_stats={}, tx=tx)
    jstep = jax_make_train_step(jax_create_vivit(num_frames=FRAMES, image_size=SIZE, **TINY),
                                "vivit", "ce", crop=SIZE, grad_accum=grad_accum, **wire_kw)
    jstate, jm = jstep(jstate, _as(payload, jnp.asarray), jnp.asarray(labels),
                       jnp.asarray(mask), jax.random.PRNGKey(0))

    model = create_vivit(num_frames=FRAMES, image_size=SIZE, seed=None, **TINY)
    model.load_state_dict(vivit_state_dict_from_flax(params))
    state = st.create_train_state(model, "adamw", 1e-3, 0.01)
    pixel, lab, msk = steps.prepare_batch(
        {"pixel_values": payload, "labels": labels, "mask": mask}, "cpu")
    state, m = steps.make_train_step(model, "vivit", "ce", crop=SIZE, grad_accum=grad_accum,
                                     **wire_kw)(state, pixel, lab, msk)
    assert state.step == 1 and int(jstate.step) == 1
    assert _rel(m["loss"].item(), float(jm["loss"])) <= 1e-5
    np.testing.assert_allclose(m["probs"].numpy(), np.asarray(jm["probs"]), atol=1e-5)
    want = vivit_state_dict_from_flax(jax.tree_util.tree_map(np.asarray, jstate.params))
    got = model.state_dict()
    for name, w in want.items():
        if name.endswith("attention.attention.key.bias"):
            assert np.abs(got[name].numpy() - w.numpy()).max() <= 2 * 3 * 1e-3, name
        else:
            assert _rel_l2(got[name].numpy(), w.numpy()) <= 1e-5, name


# ---------- the CLIs ----------

def test_cli_trains_over_dctp_and_serves_over_dct(root, tmp_path, capsys):
    """One CPU epoch of ``cli.main --wire dctp`` (the trainer takes the
    geometry from the dataset), then ``cli.inference --wire dct`` on its
    best model, and the serving parser's wire flags."""
    out = cli.main(["--model", "vivit", "--device", "cpu", "--data_dir", str(root),
                    "--log_dir", str(tmp_path / "logs"), "--num_frames", str(FRAMES),
                    "--crop_size", str(SIZE), "--hidden_size", "32", "--num_layers", "2",
                    "--num_heads", "2", "--intermediate_size", "64", "--batch_size", "2",
                    "--epochs", "1", "--decode_workers", "1", "--no-pretrained",
                    "--wire", "dctp"])
    assert np.isfinite(out["history"]["train_loss"]).all() and len(out["history"]["lr"]) == 1
    best = tmp_path / "logs" / out["exp_dir"].split("/")[-1] / "best_model"
    video = next(root.rglob("*.mp4"))
    args = ["--model", "vivit", "--model_path", str(best), "--device", "cpu",
            "--log_dir", str(tmp_path / "inf"), "--video_path", str(video)]
    rgb = cli_inference.main(args)
    dct = cli_inference.main(args + ["--wire", "dct"])
    assert dct["frame_indices"] == rgb["frame_indices"]
    assert abs(dct["probabilities"]["referral"] - rgb["probabilities"]["referral"]) < 0.05
    parsed = cli_serve.build_parser().parse_args(["--wire", "dctp", "--wire_lowres", "1"])
    assert (parsed.wire, parsed.wire_quality, parsed.wire_keep_ac, parsed.wire_pack_from,
            parsed.wire_lowres) == ("dctp", 75, 31, 14, 1)
    train = cli.build_parser().parse_args(["--model", "vivit", "--data_dir", "d"])
    assert (train.wire_quality, train.wire_keep_ac, train.wire_pack_from) == (75, 15, 8)
