"""Host clip pipeline: batching and background prefetch (counterpart of
``laryngeal_tpu/data/pipeline.py``).

Item planning (frame-index sampling) runs serially, to keep the reference's
sampler RNG order; the decodes fan out over a thread pool (cv2 releases the
GIL); finished batches wait in a bounded queue, so decode overlaps the
card's compute. Batches stack the dataset's wire payloads: dense uint8
(B, T, H, W, C) on the rgb wire, (B, T, H*3/2, W) on i420 and delta, a
tuple stacked leaf by leaf on dct and dctp; the wire decode and the
preprocessing run on the card (preprocess/transforms.py). One process only: the JAX package's
process-sharded feed is not yet ported (ROADMAP.md).
"""

from __future__ import annotations

import os
import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator, Optional

import numpy as np

from .dataset import VideoDataset


class ClipLoader:
    """Iterable over stacked clip batches with background prefetch."""

    def __init__(self, dataset: VideoDataset, batch_size: int = 4, shuffle: bool = False,
                 seed: int = 42, drop_last: bool = False, prefetch: int = 2,
                 pad_last: bool = False, num_workers: Optional[int] = None,
                 process_index: int = 0, process_count: int = 1):
        if process_count != 1 or process_index != 0:
            raise NotImplementedError(
                "the multi-process feed (process_count > 1) is not yet ported to "
                "laryngeal_tpu_torch, see ROADMAP.md")
        self.dataset = dataset
        self.batch_size = int(batch_size)
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.prefetch = max(1, int(prefetch))
        self.pad_last = pad_last
        if num_workers is None:
            num_workers = min(4, os.cpu_count() or 1)
        self.num_workers = max(1, int(num_workers))
        self._pool: Optional[ThreadPoolExecutor] = None
        self._epoch = 0

    def _executor(self) -> Optional[ThreadPoolExecutor]:
        if self.num_workers <= 1:
            return None
        if self._pool is None:
            self._pool = ThreadPoolExecutor(max_workers=self.num_workers,
                                            thread_name_prefix="clip-decode")
        return self._pool

    def close(self) -> None:
        """Stop the decode threads (a later iteration starts new ones)."""
        if self._pool is not None:
            self._pool.shutdown(wait=True)
            self._pool = None

    def __len__(self) -> int:
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def set_epoch(self, epoch: int) -> None:
        """Pin the shuffle epoch (order seed = seed + epoch), so a resumed run
        shuffles as the uninterrupted one did."""
        self._epoch = int(epoch)

    def _order(self) -> np.ndarray:
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            np.random.default_rng(self.seed + self._epoch).shuffle(idx)
        return idx

    def _make_batch(self, indices) -> Dict:
        plans = [self.dataset.plan(int(i)) for i in indices]  # serial: RNG order
        n_real = len(plans)
        pad = self.batch_size - n_real if self.pad_last and n_real < self.batch_size else 0
        pool = self._executor()
        if pool is not None and n_real > 1:
            items = list(pool.map(self.dataset.materialize, plans))
        else:
            items = [self.dataset.materialize(p) for p in plans]
        # Padding rows repeat the last real clip and are masked out.
        items += [items[-1]] * pad
        first = items[0]["pixel_values"]
        if isinstance(first, tuple):  # a dct wire payload: stack leaf by leaf
            pixel = tuple(np.stack([it["pixel_values"][k] for it in items])
                          for k in range(len(first)))
        else:
            pixel = np.stack([it["pixel_values"] for it in items])
        return {
            "pixel_values": pixel,
            "labels": np.asarray([it["label"] for it in items], np.int32),
            "mask": np.concatenate([np.ones(n_real, np.bool_), np.zeros(pad, np.bool_)]),
            "video_paths": [it["video_path"] for it in items],
            "frame_indices": [it["frame_indices"] for it in items],
        }

    def __iter__(self) -> Iterator[Dict]:
        order = self._order()
        self._epoch += 1
        n = len(order)
        starts = list(range(0, n, self.batch_size))
        if self.drop_last and starts and n - starts[-1] < self.batch_size:
            starts.pop()

        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        sentinel = object()
        errors = []
        stop = threading.Event()

        def worker():
            try:
                for s in starts:
                    if stop.is_set():
                        break
                    q.put(self._make_batch(order[s:s + self.batch_size]))
            except Exception as e:  # re-raised on the consumer side
                errors.append(e)
            finally:
                q.put(sentinel)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is sentinel:
                    break
                yield item
        finally:
            # A consumer that stops early: let the worker finish its put and exit.
            stop.set()
            while t.is_alive():
                try:
                    q.get(timeout=0.1)
                except queue.Empty:
                    pass
            t.join()
        if errors:
            raise errors[0]


def create_dataloaders(data_dir, test_data_dir=None,
                       sampling_methods: Optional[Dict[str, str]] = None,
                       num_frames: int = 32, batch_size: int = 4, seed: int = 42,
                       label_policy: str = "sorted", per_video_seed: bool = False,
                       verify_integrity: bool = False, resize_to=(224, 224),
                       drop_last_train: bool = False, pad_last: bool = False,
                       cache_clips: bool = True, clip_cache_mb: int = 2048, cache_dir=None,
                       num_workers: Optional[int] = None, wire: str = "rgb",
                       wire_quality: int = 75, wire_keep_ac: int = 31,
                       wire_pack_from: int = 14, wire_lowres: int = 0,
                       process_index: int = 0,
                       process_count: int = 1) -> Dict[str, ClipLoader]:
    """Train/val/test loaders — the reference ``create_dataloaders`` surface
    (vivit_transformer/.../dataloader.py:52-135). ``cache_dir`` is each
    split's on-disk clip cache (``dataset.DiskClipCache``), shared by the
    three; ``wire*`` pick the payload format (``dataset.VideoDataset``),
    which steps made with the same wire decode."""
    sampling_methods = sampling_methods or {}
    loaders = {}
    for split in ("train", "val", "test"):
        root = test_data_dir if (split == "test" and test_data_dir) else data_dir
        ds = VideoDataset(root, mode=split,
                          sampling_method=sampling_methods.get(split, "uniform"),
                          num_frames=num_frames, label_policy=label_policy,
                          per_video_seed=per_video_seed, seed=seed,
                          verify_integrity=verify_integrity, resize_to=resize_to,
                          cache_clips=cache_clips, clip_cache_mb=clip_cache_mb,
                          cache_dir=cache_dir, wire=wire, wire_quality=wire_quality,
                          wire_keep_ac=wire_keep_ac, wire_pack_from=wire_pack_from,
                          wire_lowres=wire_lowres)
        loaders[split] = ClipLoader(ds, batch_size=batch_size, shuffle=(split == "train"),
                                    seed=seed, drop_last=(split == "train" and drop_last_train),
                                    pad_last=pad_last, num_workers=num_workers,
                                    process_index=process_index, process_count=process_count)
    return loaders
