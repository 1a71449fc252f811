"""Host-side video decode and encode with OpenCV (counterpart of
``get_video_properties``, ``verify_video_integrity``, ``rgb_to_yuv420``,
``decode_frames`` and ``write_video`` in ``laryngeal_tpu/data/video.py``).

cv2 is imported on first use, so the package imports without it; the
functions raise a clear error when it is missing. Index-based OpenCV decode
with the reference's robustness ladder: seek -> sequential re-read -> gray
placeholder frame.
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional, Sequence, Tuple

import numpy as np


def _cv2():
    try:
        import cv2
    except ImportError as e:
        raise ImportError(
            "OpenCV (cv2) is required for video decode; install opencv-python "
            "or feed decoded uint8 clips to Predictor.predict_clip instead."
        ) from e
    return cv2


def get_video_properties(path) -> Tuple[int, float, float, int, int]:
    """(total_frames, fps, duration_sec, width, height) — reference
    ``vivit_transformer/.../dataset.py:114-127``."""
    cv2 = _cv2()
    cap = cv2.VideoCapture(str(path))
    if not cap.isOpened():
        raise ValueError(f"Could not open video: {path}")
    total = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
    fps = cap.get(cv2.CAP_PROP_FPS)
    if not fps or fps <= 0 or np.isnan(fps):
        fps = 30.0  # reference fallback (videoswintransformer/.../dataset.py:108-112)
    w = int(cap.get(cv2.CAP_PROP_FRAME_WIDTH))
    h = int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT))
    cap.release()
    return total, float(fps), total / float(fps), w, h


def verify_video_integrity(path) -> bool:
    """Openable + >=1 readable frame + positive frame count
    (reference dataset.py:48-72)."""
    try:
        cv2 = _cv2()
    except ImportError:
        return Path(path).exists()
    cap = cv2.VideoCapture(str(path))
    try:
        if not cap.isOpened():
            return False
        ret, _ = cap.read()
        return bool(ret) and int(cap.get(cv2.CAP_PROP_FRAME_COUNT)) > 0
    finally:
        cap.release()


def rgb_to_yuv420(frames_rgb: np.ndarray) -> np.ndarray:
    """RGB uint8 (T, H, W, 3) -> I420 planar uint8 (T, H*3/2, W) with cv2's
    ``COLOR_RGB2YUV_I420``: the non-rgb wires' host format (half the bytes of
    RGB24), expanded on the device by ``preprocess.transforms.yuv420_to_rgb``."""
    cv2 = _cv2()
    return np.stack([cv2.cvtColor(f, cv2.COLOR_RGB2YUV_I420) for f in frames_rgb])


def decode_frames(path, indices: Sequence[int],
                  resize_to: Optional[Tuple[int, int]] = None) -> np.ndarray:
    """Decode the frames at ``indices`` (may repeat) as RGB uint8 (N, H, W, C).

    Single sequential pass with grab()-skipping — each needed frame is
    decoded once regardless of duplicates. Unreadable frames become gray
    placeholders (value 127, reference dataset.py:341-355).

    resize_to: optional (width, height) applied per frame (the HF-regime
    datasets cv2-resize to 224x224 on the host, dataset.py:349-352).
    """
    cv2 = _cv2()
    indices = [int(i) for i in indices]
    if not indices:
        raise ValueError("decode_frames requires at least one index")
    cap = cv2.VideoCapture(str(path))
    if not cap.isOpened():
        raise ValueError(f"Could not open video: {path}")

    decoded = {}
    pos = 0
    shape_hw: Optional[Tuple[int, int]] = None
    for target in sorted(set(indices)):
        ok = True
        while pos < target:  # skip undecoded frames cheaply
            if not cap.grab():
                ok = False
                break
            pos += 1
        frame = None
        if ok:
            ret, frame = cap.read()
            if ret:
                pos += 1
            else:
                frame = None
        if frame is None:
            # Retry with a hard seek (reference fallback ladder).
            cap.set(cv2.CAP_PROP_POS_FRAMES, target)
            ret, frame = cap.read()
            frame = frame if ret else None
            pos = target + 1
        if frame is not None:
            frame = cv2.cvtColor(frame, cv2.COLOR_BGR2RGB)
            if resize_to is not None:
                frame = cv2.resize(frame, resize_to)
            shape_hw = frame.shape[:2]
        decoded[target] = frame
    cap.release()

    if shape_hw is None:
        if resize_to is None:
            raise ValueError(f"Could not decode any frame of {path}")
        shape_hw = (resize_to[1], resize_to[0])
    placeholder = np.full((*shape_hw, 3), 127, dtype=np.uint8)
    return np.stack([decoded[i] if decoded.get(i) is not None else placeholder
                     for i in indices])


def write_video(path, frames_rgb: np.ndarray, fps: float = 30.0) -> str:
    """Encode RGB uint8 (T, H, W, C) to a video file with cv2, trying mp4v,
    avc1 and XVID in that order (the JAX package's ``codec="auto"`` chain);
    returns the codec used. The native libx264 encoder is not ported."""
    cv2 = _cv2()
    path = str(path)
    _, h, w, _ = frames_rgb.shape
    for codec in ("mp4v", "avc1", "XVID"):
        writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*codec), fps, (w, h))
        if writer.isOpened():
            for f in frames_rgb:
                writer.write(cv2.cvtColor(f, cv2.COLOR_RGB2BGR))
            writer.release()
            return codec
        writer.release()
    raise RuntimeError(f"No working video codec found for {path}")
