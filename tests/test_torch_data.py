"""The port's data path and metrics against the JAX package's: the
synthetic writer, ``VideoDataset`` (paths, labels, sampled indices, pixels),
``ClipLoader`` (batch order per epoch, padding masks) and the numpy metrics.

Pixels: both datasets decode through ``native.decode_frames_auto``, which
takes the package's C++ decoder when it is built. On the synthetic mp4s that
decoder gives the same pixels as cv2 at the source size but not after a
resize (its scaler differs from ``cv2.resize``), so the tests that hold the
port's clips to ``laryngeal_tpu.data.video.decode_frames`` (the JAX
package's cv2 decode) bit for bit make both packages take the cv2 route
(``cv2_decode``). ``tests/test_torch_wire.py`` holds the native route of
both, and the wires' payloads.
"""

import filecmp

import numpy as np
import pytest

from laryngeal_tpu.data import native
from laryngeal_tpu.data import video as jax_video
from laryngeal_tpu.data.dataset import VideoDataset as JaxVideoDataset
from laryngeal_tpu.data.pipeline import ClipLoader as JaxClipLoader
from laryngeal_tpu.data.synthetic import make_synthetic_dataset as jax_make_synthetic
from laryngeal_tpu.evals import metrics as jax_metrics
from laryngeal_tpu_torch.data import native as port_native
from laryngeal_tpu_torch.data import video
from laryngeal_tpu_torch.data.dataset import ClipCache, VideoDataset, resolve_data_dir
from laryngeal_tpu_torch.data.pipeline import ClipLoader, create_dataloaders
from laryngeal_tpu_torch.data.synthetic import make_synthetic_dataset
from laryngeal_tpu_torch.evals import metrics

SIZES = dict(videos_per_class={"train": 3, "val": 1, "test": 1}, num_frames=12, h=48, w=64,
             seed=2)


@pytest.fixture(scope="module")
def roots(tmp_path_factory):
    port = tmp_path_factory.mktemp("port_synth")
    ref = tmp_path_factory.mktemp("jax_synth")
    make_synthetic_dataset(str(port), **SIZES)
    jax_make_synthetic(str(ref), **SIZES)
    return port, ref


@pytest.fixture
def cv2_decode(monkeypatch):
    """Both packages' datasets decode with cv2 (see the module docstring)."""
    monkeypatch.setattr(native, "available", lambda: False)
    monkeypatch.setattr(port_native, "available", lambda: False)


def test_synthetic_writer_matches_jax_bytes(roots):
    port, ref = roots
    files = sorted(p.relative_to(ref) for p in ref.rglob("*.mp4"))
    assert len(files) == 10
    assert sorted(p.relative_to(port) for p in port.rglob("*.mp4")) == files
    for f in files:
        assert filecmp.cmp(port / f, ref / f, shallow=False), f


@pytest.mark.parametrize("policy", ["sorted", "referral"])
@pytest.mark.parametrize("method", ["uniform", "random", "random_window"])
def test_dataset_plan_matches_jax(roots, method, policy, cv2_decode):
    """Same paths, labels, class labels and, draw for draw, the same sampled
    frame indices (stream-seeded samplers consume one draw per video)."""
    root = roots[0]
    a = VideoDataset(root, "train", sampling_method=method, num_frames=8, label_policy=policy)
    b = JaxVideoDataset(root, "train", sampling_method=method, num_frames=8,
                        label_policy=policy)
    assert a.video_paths == b.video_paths and a.labels == b.labels
    assert a.class_labels == b.class_labels and a.class_counts == b.class_counts
    for _ in range(2):
        for i in range(len(a)):
            assert a.plan(i) == b.plan(i)


@pytest.mark.parametrize("resize", [(32, 32), None])
def test_clip_pixels_match_jax_cv2_decode(roots, resize, cv2_decode):
    root = roots[0]
    ds = VideoDataset(root, "val", num_frames=8, resize_to=resize)
    for i in range(len(ds)):
        item = ds[i]
        want = jax_video.decode_frames(item["video_path"], item["frame_indices"],
                                       resize_to=resize)
        assert item["pixel_values"].dtype == np.uint8
        assert np.array_equal(item["pixel_values"], want)


def test_native_decoder_agrees_with_port_at_source_size(roots):
    """The finding behind the docstring: where the JAX package's C++
    decoder is built, it gives the port's pixels at the source size."""
    if not native.available():
        pytest.skip("the JAX package's native decoder is not built here")
    path = sorted(roots[0].rglob("*.mp4"))[0]
    idx = list(range(0, 8, 2))
    assert np.array_equal(native.decode_frames_auto(path, idx),
                          video.decode_frames(path, idx))


def test_placeholder_clip_on_decode_failure(tmp_path):
    d = tmp_path / "train" / "referral"
    d.mkdir(parents=True)
    (d / "broken.mp4").write_bytes(b"not a video")
    ds = VideoDataset(tmp_path, "train", num_frames=4, resize_to=(16, 16))
    item = ds[0]
    assert item["frame_indices"] == [] and item["pixel_values"].shape == (4, 16, 16, 3)
    assert (item["pixel_values"] == 127).all()
    assert not video.verify_video_integrity(d / "broken.mp4")
    assert len(VideoDataset(tmp_path, "train", verify_integrity=True)) == 0


def test_layout_tolerance_and_missing_dir(tmp_path):
    (tmp_path / "train").mkdir()
    assert resolve_data_dir(tmp_path, "train") == tmp_path / "train"
    (tmp_path / "dataset" / "train").mkdir(parents=True)
    assert resolve_data_dir(tmp_path, "train") == tmp_path / "dataset" / "train"
    with pytest.raises(FileNotFoundError):
        VideoDataset(tmp_path, "val")


def test_unported_dataset_options_raise(roots):
    """The wires are ported: the dataset refuses what the JAX one refuses (an
    unknown wire, a non-rgb wire without a static geometry or at one that is
    not a multiple of 16); the multi-process feed is not ported."""
    for kw, match in ((dict(wire="nope"), "Unknown wire format"),
                      (dict(wire="i420", resize_to=None), "explicit resize_to"),
                      (dict(wire="dct", resize_to=(40, 48)), "multiples of 16"),
                      (dict(wire="dctp", resize_to=(48, 48), wire_lowres=1), "multiples of 16")):
        with pytest.raises(ValueError, match=match):
            VideoDataset(roots[0], "train", **kw)
        with pytest.raises(ValueError, match=match):
            JaxVideoDataset(roots[0], "train", **kw)
    with pytest.raises(NotImplementedError, match="not yet ported"):
        ClipLoader(VideoDataset(roots[0], "val"), process_count=2)


@pytest.mark.parametrize("pad_last,drop_last", [(True, False), (False, False), (False, True)])
def test_loader_batches_match_jax(roots, pad_last, drop_last, cv2_decode):
    """Shuffled batch order per (set) epoch, labels, masks and pixels."""
    root = roots[0]
    ds_a = VideoDataset(root, "train", num_frames=4, resize_to=(32, 32))
    ds_b = JaxVideoDataset(root, "train", num_frames=4, resize_to=(32, 32))
    kw = dict(batch_size=4, shuffle=True, seed=7, pad_last=pad_last, drop_last=drop_last,
              num_workers=2)
    a, b = ClipLoader(ds_a, **kw), JaxClipLoader(ds_b, **kw)
    assert len(a) == len(b)
    orders = []
    for epoch in (0, 1, 0):
        a.set_epoch(epoch)
        b.set_epoch(epoch)
        got, want = list(a), list(b)
        assert len(got) == len(want) == len(a)
        for x, y in zip(got, want):
            assert x["video_paths"] == y["video_paths"]
            assert np.array_equal(x["labels"], y["labels"])
            assert np.array_equal(x["mask"], y["mask"])
            assert np.array_equal(x["pixel_values"], y["pixel_values"])
        orders.append([p for x in got for p in x["video_paths"]])
    a.close()
    assert orders[0] == orders[2] and orders[0] != orders[1]
    last = got[-1]
    if pad_last:
        assert last["pixel_values"].shape[0] == 4 and last["mask"].tolist() == [1, 1, 0, 0]
    elif not drop_last:
        assert last["mask"].tolist() == [1, 1]


def test_loader_stops_early_without_leaking_its_thread(roots):
    loader = ClipLoader(VideoDataset(roots[0], "train", num_frames=4, resize_to=(16, 16)),
                        batch_size=1, prefetch=1, num_workers=1)
    it = iter(loader)
    next(it)
    it.close()  # the generator's finally drains the queue and joins the worker
    assert len(list(loader)) == len(loader)


def test_create_dataloaders_surface(roots):
    loaders = create_dataloaders(roots[0], num_frames=4, batch_size=2, resize_to=(16, 16),
                                 pad_last=True, num_workers=1)
    assert set(loaders) == {"train", "val", "test"}
    assert loaders["train"].shuffle and not loaders["val"].shuffle
    batch = next(iter(loaders["val"]))
    assert batch["pixel_values"].shape == (2, 4, 16, 16, 3)
    for loader in loaders.values():
        loader.close()


def test_clip_cache_budget_and_hits():
    cache = ClipCache(max_bytes=100)
    cache.put("a", np.zeros(60, np.uint8))
    cache.put("b", np.zeros(60, np.uint8))  # evicts a
    assert "a" not in cache and "b" in cache and cache.nbytes == 60
    cache.put("big", np.zeros(200, np.uint8))  # over budget: never cached
    assert "big" not in cache and "b" in cache
    assert cache.get("b") is not None and cache.get("a") is None
    assert cache.stats()["hits"] == 1 and cache.stats()["misses"] == 1


def _counting_decode(monkeypatch):
    """Counts the port dataset's decodes (``native.decode_frames_auto``)."""
    calls = []
    real = port_native.decode_frames_auto

    def decode(*args, **kwargs):
        calls.append(args[0])
        return real(*args, **kwargs)

    monkeypatch.setattr(port_native, "decode_frames_auto", decode)
    return calls


@pytest.mark.parametrize("method,per_video_seed", [("uniform", False), ("random", True)])
def test_port_reads_a_jax_written_clip_cache(roots, tmp_path, cv2_decode, monkeypatch, method,
                                             per_video_seed):
    """A directory the JAX dataset filled is read by the port: the same file
    names (the JAX key rule), the same clips, no decode."""
    kw = dict(num_frames=6, resize_to=(32, 32), sampling_method=method,
              per_video_seed=per_video_seed, cache_clips=False, cache_dir=tmp_path / "c")
    jds = JaxVideoDataset(roots[0], "train", **kw)
    want = [jds[i]["pixel_values"] for i in range(len(jds))]
    files = sorted((tmp_path / "c").glob("*.npy"))
    assert len(files) == len(jds)
    calls = _counting_decode(monkeypatch)
    ds = VideoDataset(roots[0], "train", **kw)
    for i in range(len(ds)):
        assert np.array_equal(ds[i]["pixel_values"], want[i])
    assert calls == [] and sorted((tmp_path / "c").glob("*.npy")) == files


def test_port_writes_a_clip_cache_jax_reads_and_skips_corrupt_entries(roots, tmp_path,
                                                                      monkeypatch):
    kw = dict(num_frames=6, resize_to=(32, 32), cache_clips=False, cache_dir=tmp_path / "c")
    calls = _counting_decode(monkeypatch)
    ds = VideoDataset(roots[0], "val", **kw)
    first = [ds[i]["pixel_values"] for i in range(len(ds))]
    assert len(calls) == len(ds)
    files = sorted((tmp_path / "c").glob("*.npy"))
    assert len(files) == len(ds) and not list((tmp_path / "c").glob("*.tmp"))
    again = [VideoDataset(roots[0], "val", **kw)[i]["pixel_values"] for i in range(len(ds))]
    assert len(calls) == len(ds)  # the second pass decoded nothing
    assert all(np.array_equal(a, b) for a, b in zip(first, again))
    jds = JaxVideoDataset(roots[0], "val", **kw)
    monkeypatch.setattr(native, "decode_frames_auto",
                        lambda *a, **k: pytest.fail("the JAX dataset decoded"))
    assert all(np.array_equal(jds[i]["pixel_values"], first[i]) for i in range(len(jds)))
    files[0].write_bytes(b"truncated")  # a corrupt entry is a miss, decoded again
    assert all(np.array_equal(VideoDataset(roots[0], "val", **kw)[i]["pixel_values"], first[i])
               for i in range(len(ds)))
    assert len(calls) == len(ds) + 1


def test_save_sampled_indices_matches_jax(roots, tmp_path):
    a = VideoDataset(roots[0], "train", sampling_method="random", per_video_seed=True)
    b = JaxVideoDataset(roots[0], "train", sampling_method="random", per_video_seed=True)
    (tmp_path / "a").mkdir()
    (tmp_path / "b").mkdir()
    pa, pb = a.save_sampled_indices(tmp_path / "a"), b.save_sampled_indices(tmp_path / "b")
    assert open(pa).read() == open(pb).read()


@pytest.mark.parametrize("seed,ties", [(0, False), (1, False), (2, True)])
def test_metrics_match_jax(seed, ties):
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, 2, 40)
    scores = rng.random(40)
    if ties:
        scores = np.round(scores, 1)
    probs = np.stack([1 - scores, scores], -1)
    preds = probs.argmax(-1)
    got = metrics.compute_all_metrics(labels, preds, probs)
    want = jax_metrics.compute_all_metrics(labels, preds, probs)
    assert got.keys() == want.keys()
    for k in want:
        if isinstance(want[k], dict):
            for kk in want[k]:
                np.testing.assert_array_equal(got[k][kk], want[k][kk])
        else:
            np.testing.assert_array_equal(got[k], want[k])
