"""The port's native clip decoder and wire encoder
(``laryngeal_tpu_torch/data/native.py`` over its own copy of
``cliploader.cpp``) against the JAX package's binding of the same source.

Both libraries are built with the JAX ``native/Makefile``'s flags, so the
decode (rgb, i420, ``fast``, ``lowres``) and the dct encode and nibble pack
are held bitwise on an ``mp4v`` file and numpy inputs from a seed; the cv2
fallback of ``decode_frames_auto`` is held bitwise against the JAX one.
The numpy dct encoder agrees with the native one to +-1 on a few
coefficients (float accumulation order), as in the JAX package.
"""

import filecmp

import numpy as np
import pytest

from laryngeal_tpu.data import native as jax_native
from laryngeal_tpu.preprocess import dct_wire as jax_dct
from laryngeal_tpu_torch.data import native
from laryngeal_tpu_torch.data.synthetic import synth_video
from laryngeal_tpu_torch.data.video import rgb_to_yuv420, write_video
from laryngeal_tpu_torch.preprocess import dct_wire

REPO = native.PKG_DIR.parent


@pytest.fixture(scope="module")
def video_path(tmp_path_factory):
    """An mp4v (MPEG-4 part 2) file: lowres decodes it."""
    path = tmp_path_factory.mktemp("native") / "clip.mp4"
    codec = write_video(path, synth_video(np.random.default_rng(4), 14, 64, 96, referral=True))
    assert codec == "mp4v"
    return path


@pytest.fixture(scope="module")
def both_built():
    if not native.available():
        pytest.fail(f"the port's native library did not build: {native.unavailable_reason()}")
    if not jax_native.available():
        pytest.fail("the JAX package's native library did not build")


def test_library_builds_from_the_port_source_into_its_build_dir(both_built):
    ok, detail = native.toolchain()
    assert ok and "g++" in detail and "libavcodec" in detail
    assert native.SOURCE == REPO / "laryngeal_tpu_torch" / "native" / "cliploader.cpp"
    path = native.library_path()
    assert path.parent == REPO / "laryngeal_tpu_torch" / "_build" and path.exists()
    assert native.unavailable_reason() is None and native.build_seconds is not None
    # The same code as the JAX package's source: only comments differ.
    strip = lambda p: [ln for ln in p.read_text().splitlines()
                       if ln.strip() and not ln.strip().startswith("//")]
    assert strip(native.SOURCE) == strip(REPO / "native" / "cliploader.cpp")


def test_video_properties_match_jax(both_built, video_path):
    assert native.get_video_properties(video_path) == jax_native.get_video_properties(video_path)


@pytest.mark.parametrize("kw", [
    dict(), dict(resize_to=(48, 32)), dict(fmt="i420"), dict(fmt="i420", resize_to=(32, 32)),
    dict(fmt="i420", fast=True), dict(fast=True, resize_to=(48, 32)),
    dict(fmt="i420", lowres=1), dict(lowres=1), dict(fmt="i420", lowres=1, resize_to=(32, 32)),
    dict(fmt="i420", lowres=2)],
    ids=["rgb", "rgb_resize", "i420", "i420_resize", "i420_fast", "rgb_fast", "i420_lowres1",
         "rgb_lowres1", "i420_lowres1_resize", "i420_lowres2"])
def test_decode_frames_matches_jax_bitwise(both_built, video_path, kw):
    idx = [0, 3, 3, 7, 12, 5]  # unsorted, with a duplicate
    got = native.decode_frames(video_path, idx, **kw)
    want = jax_native.decode_frames(video_path, idx, **kw)
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_decode_frames_refusals(both_built, video_path):
    for kw, error in ((dict(lowres=4), ValueError), (dict(fmt="i420", resize_to=(33, 32)),
                                                     ValueError)):
        with pytest.raises(error):
            native.decode_frames(video_path, [0], **kw)
        with pytest.raises(error):
            jax_native.decode_frames(video_path, [0], **kw)
    with pytest.raises(ValueError, match="at least one index"):
        native.decode_frames(video_path, [])
    with pytest.raises(ValueError, match="Could not open"):
        native.get_video_properties(video_path.parent / "missing.mp4")


@pytest.mark.parametrize("quality,keep_ac", [(75, 31), (87, 63), (50, 15), (10, 0)])
def test_dct_encode_matches_jax_bitwise(both_built, quality, keep_ac):
    i420 = rgb_to_yuv420(synth_video(np.random.default_rng(quality), 3, 48, 64, False))
    dc, ac = native.dct_encode(i420, quality, keep_ac)
    jdc, jac = jax_native.dct_encode(i420, quality, keep_ac)
    assert dc.dtype == np.int16 and ac.dtype == np.int8 and ac.shape == (keep_ac, 3, 72)
    np.testing.assert_array_equal(dc, jdc)
    np.testing.assert_array_equal(ac, jac)


def test_native_encoder_matches_numpy(both_built):
    """The JAX package's bound on its two encoders, for the port's: +-1, on
    under 2e-3 of the coefficients (the 8x8 two-pass transform against the
    64-wide product sums in another order)."""
    i420 = rgb_to_yuv420(synth_video(np.random.default_rng(3), 6, 64, 64, True))
    dc, ac = native.dct_encode(i420, 87)
    ndc, nac = dct_wire.encode_clip_np(i420, 87)
    d_dc = np.abs(dc.astype(np.int32) - ndc.astype(np.int32))
    d_ac = np.abs(ac.astype(np.int32) - nac.astype(np.int32))
    assert d_dc.max() <= 1 and d_ac.max() <= 1
    frac = (np.count_nonzero(d_dc) + np.count_nonzero(d_ac)) / (d_dc.size + d_ac.size)
    assert frac < 2e-3, frac


@pytest.mark.parametrize("planes", [1, 4, 7])
def test_ac_pack_matches_jax_bitwise_and_numpy(both_built, planes):
    ac = np.random.default_rng(planes).integers(-20, 20, (planes, 3, 50), dtype=np.int8)
    got = native.ac_pack(ac)
    np.testing.assert_array_equal(got, jax_native.ac_pack(ac))
    # The numpy path of pack_ac_planes (taken without the library) agrees.
    clipped = np.clip(ac.astype(np.int16), -8, 7)
    if planes % 2:
        clipped = np.concatenate([clipped, np.zeros((1, 3, 50), np.int16)])
    want = ((clipped[0::2] & 15) | ((clipped[1::2] & 15) << 4)).astype(np.uint8)
    np.testing.assert_array_equal(got, want)


def test_encode_h264_matches_jax(both_built, tmp_path):
    frames = np.random.default_rng(0).integers(0, 256, (6, 32, 48, 3), dtype=np.uint8)
    try:
        jax_native.encode_h264(tmp_path / "jax.mp4", frames)
    except RuntimeError as e:  # no libx264 in this libavcodec: the port says so too
        with pytest.raises(RuntimeError, match="libx264"):
            native.encode_h264(tmp_path / "port.mp4", frames)
        assert "libx264" in str(e)
        return
    native.encode_h264(tmp_path / "port.mp4", frames)
    assert native.encoder_available()
    assert filecmp.cmp(tmp_path / "port.mp4", tmp_path / "jax.mp4", shallow=False)
    assert native.decode_frames(tmp_path / "port.mp4", range(6)).shape == (6, 32, 48, 3)


@pytest.mark.parametrize("kw", [dict(resize_to=(48, 32)), dict(fmt="i420", resize_to=(32, 32)),
                                dict(fmt="i420", lowres=1), dict()],
                         ids=["rgb", "i420", "i420_lowres1", "rgb_source"])
def test_auto_falls_back_to_cv2_as_jax_does(video_path, monkeypatch, kw):
    """Without the library both packages decode with cv2 (lowres: a full
    decode resized to the reduced geometry), bit for bit."""
    monkeypatch.setattr(native, "available", lambda: False)
    monkeypatch.setattr(jax_native, "available", lambda: False)
    idx = [1, 4, 4, 9]
    got = native.decode_frames_auto(video_path, idx, **kw)
    np.testing.assert_array_equal(got, jax_native.decode_frames_auto(video_path, idx, **kw))


def test_missing_toolchain_is_reported_and_encode_falls_back(monkeypatch):
    """No g++ / libav: not available, the reason kept, the dct encoder on
    numpy (the JAX package's contract)."""
    monkeypatch.setitem(native._state, "tried", False)
    monkeypatch.setitem(native._state, "lib", None)
    monkeypatch.setitem(native._state, "reason", None)
    monkeypatch.setattr(native, "toolchain", lambda: (False, "g++ not found on PATH"))
    assert not native.available()
    assert native.unavailable_reason() == "g++ not found on PATH"
    with pytest.raises(RuntimeError, match=r"unavailable: g\+\+ not found"):
        native.decode_frames("any.mp4", [0])
    i420 = rgb_to_yuv420(synth_video(np.random.default_rng(2), 2, 32, 32, True))
    got = dct_wire.encode_clip_packed(i420, 75, 31, 8)
    want = jax_dct.encode_clip_packed(i420, 75, 31, 8)
    monkeypatch.setattr(jax_native, "available", lambda: False)
    want_np = jax_dct.encode_clip_packed(i420, 75, 31, 8)
    for a, b in zip(got, want_np):
        np.testing.assert_array_equal(a, b)
    assert [a.shape for a in got] == [a.shape for a in want]
