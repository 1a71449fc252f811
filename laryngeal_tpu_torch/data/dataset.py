"""Dataset walker + clip loading (counterpart of ``laryngeal_tpu/data/dataset.py``).

Directory-layout tolerance as the reference (dataset.py:24-31): given
``root_dir`` and ``mode``, data is found at ``root/dataset/{mode}`` if
``root/dataset`` exists, else ``root/{mode}`` if it exists, else
``root/dataset/{mode}`` (and a FileNotFoundError if absent).

Label policies:
- ``sorted``: labels from sorted class-dir names (ViViT/TimeSformer,
  dataset.py:80-85). For {non_referral, referral} this yields referral=1.
- ``referral``: hardcoded ``referral``->1, everything else 0
  (resnet50-3d-video dataset.py:68-73, 2d-lstm, swin).

Decode goes through the port's cv2 ``data/video.py``; the JAX dataset takes
its native C++ decoder when that is built. Ported: the rgb wire and the RAM
clip cache. The other wires and the on-disk clip cache are not yet ported
(ROADMAP.md) and raise.
"""

from __future__ import annotations

import csv
import logging
import os
import threading
from collections import OrderedDict
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

from .samplers import FrameSampler
from .video import decode_frames, get_video_properties, verify_video_integrity

logger = logging.getLogger(__name__)


def resolve_data_dir(root_dir, mode: str) -> Path:
    root = Path(root_dir)
    if not (root / "dataset").exists():
        if (root / mode).exists():
            return root / mode
        return root / "dataset" / mode
    return root / "dataset" / mode


class ClipCache:
    """Byte-budgeted LRU cache for decoded uint8 clips, shared by the decode
    threads. Entries are evicted least-recently-used once the byte budget is
    exceeded; a clip over the whole budget is never cached."""

    def __init__(self, max_bytes: int = 2 << 30):
        self.max_bytes = int(max_bytes)
        self._store: "OrderedDict" = OrderedDict()
        self._bytes = 0
        self._lock = threading.Lock()
        self.n_hits = 0
        self.n_misses = 0

    def __contains__(self, key) -> bool:
        with self._lock:
            return key in self._store

    def __len__(self) -> int:
        return len(self._store)

    @property
    def nbytes(self) -> int:
        return self._bytes

    def get(self, key):
        with self._lock:
            clip = self._store.get(key)
            if clip is not None:
                self._store.move_to_end(key)
                self.n_hits += 1
            else:
                self.n_misses += 1
            return clip

    def stats(self) -> dict:
        with self._lock:
            return {"hits": self.n_hits, "misses": self.n_misses,
                    "entries": len(self._store), "bytes": self._bytes}

    def put(self, key, clip: np.ndarray) -> None:
        if clip.nbytes > self.max_bytes:
            return  # one clip over budget: never cache, never evict others
        with self._lock:
            if key in self._store:
                self._bytes -= self._store.pop(key).nbytes
            self._store[key] = clip
            self._bytes += clip.nbytes
            while self._bytes > self.max_bytes and self._store:
                _, evicted = self._store.popitem(last=False)
                self._bytes -= evicted.nbytes

    def clear(self) -> None:
        with self._lock:
            self._store.clear()
            self._bytes = 0


class VideoDataset:
    """Walks ``{data_dir}/{class}/*.mp4``, assigns labels, samples frame
    indices, and decodes fixed-length uint8 RGB clips (T, H, W, 3).

    Decoded clips are cached in RAM (``cache_clips``, byte-budget LRU) when
    the sampled indices recur: uniform sampling and per-video-seeded
    samplers. Stream-seeded random samplers draw fresh indices every epoch
    and are not cached."""

    def __init__(
        self,
        root_dir,
        mode: str = "train",
        sampling_method: str = "uniform",
        num_frames: int = 32,
        label_policy: str = "sorted",
        per_video_seed: bool = False,
        seed: int = 42,
        verify_integrity: bool = False,
        resize_to: Optional[tuple] = (224, 224),
        cache_clips: bool = True,
        clip_cache_mb: int = 2048,
        cache_dir=None,
        wire: str = "rgb",
    ):
        if wire != "rgb":
            raise NotImplementedError(
                f"wire format {wire!r} is not yet ported to laryngeal_tpu_torch, "
                "see ROADMAP.md")
        if cache_dir is not None:
            raise NotImplementedError(
                "the on-disk clip cache (cache_dir) is not yet ported to "
                "laryngeal_tpu_torch, see ROADMAP.md")
        self.root_dir = Path(root_dir)
        self.mode = mode
        self.num_frames = int(num_frames)
        self.sampling_method = sampling_method
        self.resize_to = resize_to
        self.wire = wire
        self.cache_clips = cache_clips and (per_video_seed or sampling_method == "uniform")
        self._clip_cache = ClipCache(max_bytes=int(clip_cache_mb) << 20)
        self._props_cache: Dict = {}
        self.sampler = FrameSampler(sampling_method, num_frames, seed=seed,
                                    per_video_seed=per_video_seed)
        self.video_paths: List[str] = []
        self.labels: List[int] = []
        self.class_labels: List[str] = []
        self.data_dir = resolve_data_dir(root_dir, mode)
        self._load(label_policy, verify_integrity)

    def _load(self, label_policy: str, verify: bool) -> None:
        if not self.data_dir.exists():
            raise FileNotFoundError(f"Data directory not found: {self.data_dir}")
        class_dirs = sorted(d for d in self.data_dir.iterdir() if d.is_dir())
        self.class_labels = [d.name for d in class_dirs]
        label_map = {name: i for i, name in enumerate(self.class_labels)}
        for class_dir in class_dirs:
            if label_policy == "referral":
                label = 1 if class_dir.name == "referral" else 0
            else:
                label = label_map[class_dir.name]
            files = sorted(class_dir.glob("*.mp4"))
            if verify:
                files = [f for f in files if verify_video_integrity(f)]
            for f in files:
                self.video_paths.append(str(f))
                self.labels.append(label)
        logger.info("Found %d videos for %s (classes=%s)", len(self.video_paths), self.mode,
                    self.class_labels)

    def __len__(self) -> int:
        return len(self.video_paths)

    def resample_clips(self, pass_idx: int) -> None:
        """Draw a fresh (deterministic) clip per video for clip-averaged
        evaluation pass ``pass_idx`` and drop clips cached under the previous
        pass's indices."""
        self.sampler.resample(pass_idx)
        self._clip_cache.clear()

    def video_properties(self, path: str):
        if path not in self._props_cache:
            self._props_cache[path] = get_video_properties(path)
        return self._props_cache[path]

    def plan(self, idx: int) -> Dict:
        """Probe + sample frame indices for item ``idx``. Runs serially in
        dataset-iteration order: stream-seeded samplers consume one RNG draw
        per video, and index parity with the reference depends on the order."""
        path = self.video_paths[idx]
        try:
            total_frames = self.video_properties(path)[0]
            indices = self.sampler(path, total_frames)
        except Exception as e:  # the data path never raises for one bad video
            logger.warning("Could not probe %s: %s — placeholder clip", path, e)
            indices = None
        return {"video_path": path, "label": int(self.labels[idx]), "frame_indices": indices}

    def _placeholder_clip(self) -> np.ndarray:
        """Gray clip (robustness contract, vivit dataset.py:370-381)."""
        w, h = self.resize_to or (224, 224)
        return np.full((self.num_frames, h, w, 3), 127, np.uint8)

    def materialize(self, plan: Dict) -> Dict:
        """Decode the planned clip; thread-safe (the cache is locked, decode
        touches no sampler state). A decode failure gives the gray
        placeholder clip with empty frame_indices, never an exception."""
        path, label, indices = plan["video_path"], plan["label"], plan["frame_indices"]
        if indices is None:
            return {"pixel_values": self._placeholder_clip(), "label": label,
                    "video_path": path, "frame_indices": []}
        key = (path, tuple(indices))
        clip = self._clip_cache.get(key) if self.cache_clips else None
        if clip is None:
            try:
                clip = decode_frames(path, indices, resize_to=self.resize_to)
            except Exception as e:  # the data path never raises for one bad video
                logger.warning("Decode failed for %s: %s — placeholder clip", path, e)
                clip = self._placeholder_clip()
            if self.cache_clips:
                self._clip_cache.put(key, clip)
        return {"pixel_values": clip, "label": label, "video_path": path,
                "frame_indices": list(indices)}

    def __getitem__(self, idx: int) -> Dict:
        return self.materialize(self.plan(idx))

    def save_sampled_indices(self, log_dir) -> Optional[str]:
        """CSV audit of per-video sampled indices
        (resnet50-3d-video/.../dataset.py:245-288)."""
        if not log_dir:
            return None
        for p in self.video_paths:
            self.sampler(p, self.video_properties(p)[0])
        path = os.path.join(str(log_dir),
                            f"sampled_frames_{self.mode}_{self.sampling_method}.csv")
        cache = self.sampler.cached_indices
        with open(path, "w", newline="") as f:
            wr = csv.writer(f)
            wr.writerow(["video_filename", "total_frames", "sampled_frames"])
            for p in sorted(self.video_paths):
                total = self.video_properties(p)[0]
                idx = cache.get(p) or self.sampler(p, total)
                wr.writerow([os.path.basename(p), total, ",".join(map(str, idx))])
        return path

    @property
    def class_counts(self) -> Dict[str, int]:
        counts: Dict[str, int] = {}
        for lbl in self.labels:
            name = self.class_labels[lbl] if lbl < len(self.class_labels) else str(lbl)
            counts[name] = counts.get(name, 0) + 1
        return counts
