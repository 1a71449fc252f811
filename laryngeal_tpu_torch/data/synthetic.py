"""Synthetic laryngoscopy-like dataset generator for tests and smoke runs.

The port's own copy of ``laryngeal_tpu/data/synthetic.py``: the same seed
gives the same videos.

The reference has no tests and relies on a private 132-video dataset
(``data_description/dataset_splits.csv``). For an executable test pyramid we
generate tiny mp4s with a *learnable* class signal: 'referral' videos contain
a bright moving disk (mock lesion) on textured background, 'non_referral'
videos only the background. A 1-epoch train run on these shows real learning
signal end-to-end.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, Optional

import numpy as np

from .video import write_video


def synth_video(
    rng: np.random.Generator,
    num_frames: int,
    h: int,
    w: int,
    referral: bool,
) -> np.ndarray:
    """(T,H,W,3) uint8 clip; referral => bright moving disk present."""
    t = np.arange(num_frames)
    base = rng.integers(30, 90, (1, h, w, 3)).astype(np.float32)
    noise = rng.normal(0, 12, (num_frames, h, w, 3)).astype(np.float32)
    frames = base + noise
    if referral:
        yy, xx = np.mgrid[0:h, 0:w]
        cx = w * (0.3 + 0.4 * (0.5 + 0.5 * np.sin(2 * np.pi * t / max(num_frames, 2))))
        cy = h * (0.3 + 0.4 * (0.5 + 0.5 * np.cos(2 * np.pi * t / max(num_frames, 2))))
        r = 0.15 * min(h, w)
        for i in range(num_frames):
            mask = (yy - cy[i]) ** 2 + (xx - cx[i]) ** 2 < r**2
            frames[i][mask] += 140.0
    return np.clip(frames, 0, 255).astype(np.uint8)


def make_synthetic_dataset(
    root: str,
    videos_per_class: Dict[str, int] = None,
    num_frames: int = 24,
    h: int = 64,
    w: int = 64,
    fps: float = 12.0,
    seed: int = 0,
    splits=("train", "val", "test"),
    varied_lengths: bool = True,
) -> Path:
    """Create ``{root}/{split}/{referral,non_referral}/*.mp4``. Returns root."""
    if videos_per_class is None:
        videos_per_class = {"train": 4, "val": 2, "test": 2}
    rng = np.random.default_rng(seed)
    root_path = Path(root)
    for split in splits:
        n = videos_per_class.get(split, 2)
        for cls in ("non_referral", "referral"):
            d = root_path / split / cls
            d.mkdir(parents=True, exist_ok=True)
            for i in range(n):
                t = num_frames
                if varied_lengths:
                    t = int(rng.integers(max(4, num_frames // 2), num_frames * 2))
                clip = synth_video(rng, t, h, w, referral=(cls == "referral"))
                write_video(d / f"{cls}_{split}_{i:02d}.mp4", clip, fps=fps)
    return root_path
