"""Host-side predictor machinery (counterpart of
``laryngeal_tpu/infer/base.py``).

Sampling, decode, the wire payload, batching and the result schema.
Subclasses provide ``_forward(payload)`` (the batched wire payload as numpy:
(B, T, H, W, 3) uint8 on the rgb wire, (B, T, H*3/2, W) I420 planes or their
deltas, or the dct wires' tuples -> (B, num_classes) probability tensor),
``sampler``, ``class_labels``, ``num_frames``, ``sampling_method``,
``crop_size`` and ``logger``, and may set the ``wire*`` attributes (the
class defaults: rgb). The non-rgb wires decode I420 straight from the
codec (``native.decode_frames_auto``) at ``crop_size >> wire_lowres``.

Result schema parity: ``vivit_transformer/inference.py:225-248`` (single)
and ``resnet50-2d-lstm/inference.py:250-351`` (batch skip semantics).
"""

from __future__ import annotations

import os
import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from datetime import datetime
from typing import Dict, Optional

import numpy as np
import torch

from ..data import native
from ..data.video import decode_frames, get_video_properties, rgb_to_yuv420
from ..preprocess.transforms import encode_wire


class VideoPredictorBase:
    # Host->device payload format (preprocess.transforms.decode_wire_batch)
    # and its parameters; Predictor sets them.
    wire: str = "rgb"
    wire_quality: int = 75
    wire_keep_ac: int = 31
    wire_pack_from: int = 14
    # Non-rgb wires: decode at 1/2**n resolution (native mpeg4 lowres) and
    # ship (crop >> n) pixels; the preprocessing resizes them to the crop.
    wire_lowres: int = 0

    def _wire_hw(self) -> int:
        return self.crop_size >> (self.wire_lowres if self.wire != "rgb" else 0)

    def extract_clip_with_indices(self, video_path):
        total_frames, *_ = get_video_properties(video_path)
        indices = self.sampler(str(video_path), total_frames)
        if self.wire != "rgb":
            # The codec's own 4:2:0 planes at the wire's geometry.
            w = self._wire_hw()
            clip = native.decode_frames_auto(video_path, indices, resize_to=(w, w),
                                             fmt="i420", lowres=self.wire_lowres)
        else:
            hw = (self.crop_size, self.crop_size)
            clip = decode_frames(video_path, indices, resize_to=hw)
        return clip, indices, total_frames

    def extract_clip(self, video_path) -> np.ndarray:
        return self.extract_clip_with_indices(video_path)[0]

    def _encode_wire(self, i420: np.ndarray):
        """One clip's host-side wire encode: I420 (T, H*3/2, W) -> payload."""
        return encode_wire(i420, self.wire, self.wire_quality, self.wire_keep_ac,
                           self.wire_pack_from)

    def _stack_payload(self, clips):
        """Clips in the wire's host format (rgb: (T, H, W, 3) uint8; the
        others: I420 (T, H*3/2, W) uint8) -> the batched payload (numpy; a
        tuple on the dct wires)."""
        if self.wire == "rgb":
            return np.stack(clips)
        payloads = [self._encode_wire(c) for c in clips]
        if isinstance(payloads[0], tuple):
            return tuple(np.stack([p[i] for p in payloads]) for i in range(len(payloads[0])))
        return np.stack(payloads)

    def predict_clip(self, clip_u8: np.ndarray) -> np.ndarray:
        """(T,H,W,3) or (B,T,H,W,3) RGB uint8 -> (B, num_classes)
        probabilities. On a non-rgb wire RGB input becomes I420 on the host
        (4:2:0 chroma, the loss the video source already carries), and I420
        input (T,H*3/2,W) or (B,T,H*3/2,W) is taken as it is.

        Shape dispatch: on the rgb wire by ndim only (4D one clip, 5D a
        batch), so a (T,H,W,1) clip is never read as batched I420. On the
        other wires a last dim of 3 marks RGB; a 4D input whose last dim is
        another channel-like size (<= 4) is ambiguous and raises."""
        if self.wire == "rgb":
            if clip_u8.ndim not in (4, 5):
                raise ValueError(
                    f"rgb wire expects (T,H,W,C) or (B,T,H,W,C); got shape {clip_u8.shape}")
            rgb_in, batched = True, clip_u8.ndim == 5
        elif clip_u8.ndim == 3:
            rgb_in, batched = False, False
        elif clip_u8.ndim == 5:
            if clip_u8.shape[-1] != 3:
                raise ValueError(f"5D input must be (B,T,H,W,3) RGB; got shape {clip_u8.shape}")
            rgb_in, batched = True, True
        elif clip_u8.ndim == 4:
            if clip_u8.shape[-1] == 3:
                rgb_in, batched = True, False
            elif clip_u8.shape[-1] <= 4:
                raise ValueError(
                    f"4D input with trailing dim {clip_u8.shape[-1]} is neither RGB (C=3) nor "
                    f"batched I420 (B,T,H*3/2,W); got shape {clip_u8.shape}")
            else:
                rgb_in, batched = False, True
        else:
            raise ValueError(f"unsupported input shape {clip_u8.shape}")
        clips = list(clip_u8) if batched else [clip_u8]
        if self.wire != "rgb" and rgb_in:
            w = self._wire_hw()
            if clips and clips[0].shape[1] != w:
                # A lowres wire: RGB input to the wire's geometry first (an
                # area downscale, the analogue of the lowres decode's loss).
                import cv2

                clips = [np.stack([cv2.resize(f, (w, w), interpolation=cv2.INTER_AREA)
                                   for f in c]) for c in clips]
            clips = [rgb_to_yuv420(np.ascontiguousarray(c)) for c in clips]
        return self._forward(self._stack_payload(clips)).cpu().numpy()

    def save_sampled_frames(self, log_dir) -> Optional[str]:
        """CSV audit of the indices every prediction of this session sampled
        (``inference_sampled_frames_{method}.csv``, reference
        resnet50-3d-video/inference.py:206-245); dynamic_fps stays blank."""
        import csv

        records = getattr(self, "_sampled_records", None)
        if not log_dir or not records:
            return None
        path = os.path.join(str(log_dir),
                            f"inference_sampled_frames_{self.sampling_method}.csv")
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w", newline="") as f:
            wr = csv.writer(f)
            wr.writerow(["video_filename", "total_frames", "sampled_frames", "dynamic_fps"])
            for vp in sorted(records):
                total, idx = records[vp]
                wr.writerow([os.path.basename(vp), total, ",".join(map(str, idx)), ""])
        self.logger.info("Saved %d sampled frame records to %s", len(records), path)
        return path

    def _result(self, video_path, probs, indices, total_frames) -> Dict:
        if not hasattr(self, "_sampled_records"):
            self._sampled_records = {}
        self._sampled_records[str(video_path)] = (int(total_frames), list(indices))
        pred = int(np.argmax(probs))
        class_name = (self.class_labels[pred]
                      if pred < len(self.class_labels) else str(pred))
        # Result schema: vivit_transformer/inference.py:225-248.
        return {
            "video_path": str(video_path),
            "predicted_class": class_name,
            "class_id": pred,
            "confidence": float(probs[pred]),
            "probabilities": {c: float(probs[i])
                              for i, c in enumerate(self.class_labels)},
            "class_mapping": {str(i): c for i, c in enumerate(self.class_labels)},
            "sampling_method": self.sampling_method,
            "num_frames": self.num_frames,
            "frame_indices": list(indices),
            "total_frames": int(total_frames),
            "timestamp": datetime.now().isoformat(),
        }

    def predict_video(self, video_path) -> Dict:
        clip, indices, total_frames = self.extract_clip_with_indices(video_path)
        probs = self.predict_clip(clip)[0]
        return self._result(video_path, probs, indices, total_frames)

    def predict_videos(self, video_paths, batch_size: int = 4,
                       prefetch: int = 2, num_workers: Optional[int] = None):
        """Batch mode: serial sampling (RNG-order parity with dataset
        iteration), pooled decode (``native.decode_frames_auto`` at the
        wire's geometry), prefetched batches of one shape (the last is
        padded with its final clip). Per-video results follow
        ``predict_video``'s schema; unreadable videos are skipped with a
        warning (the reference batch mode, resnet50-2d-lstm/inference.py:
        263-276)."""
        plans = []
        for p in video_paths:
            try:
                total, *_ = get_video_properties(p)
                plans.append((str(p), self.sampler(str(p), total), int(total)))
            except Exception as e:
                self.logger.warning("Skipping unreadable video %s: %s", p, e)
        if not plans:
            return []
        w = self._wire_hw()
        fmt = "rgb" if self.wire == "rgb" else "i420"
        lowres = self.wire_lowres if self.wire != "rgb" else 0

        def decode(plan):
            path, idx, _ = plan
            try:
                return native.decode_frames_auto(path, idx, resize_to=(w, w), fmt=fmt,
                                                 lowres=lowres)
            except Exception as e:
                self.logger.warning("Decode failed for %s: %s — skipped", path, e)
                return None

        workers = max(1, num_workers or min(4, os.cpu_count() or 1))
        q: "queue.Queue" = queue.Queue(maxsize=max(1, prefetch))
        sentinel = object()

        def producer():
            try:
                with ThreadPoolExecutor(max_workers=workers) as pool:
                    batch_plans, batch_clips = [], []
                    for start in range(0, len(plans), batch_size):
                        chunk = plans[start:start + batch_size]
                        for plan, clip in zip(chunk, pool.map(decode, chunk)):
                            if clip is None:
                                continue
                            batch_plans.append(plan)
                            batch_clips.append(clip)
                            if len(batch_clips) == batch_size:
                                q.put((batch_plans, self._stack_payload(batch_clips)))
                                batch_plans, batch_clips = [], []
                    if batch_clips:
                        n_real = len(batch_clips)
                        while len(batch_clips) < batch_size:  # keep one batch shape
                            batch_clips.append(batch_clips[-1])
                        q.put((batch_plans[:n_real], self._stack_payload(batch_clips)))
            finally:
                q.put(sentinel)

        threading.Thread(target=producer, daemon=True).start()
        out_plans, out_probs = [], []
        while True:
            item = q.get()
            if item is sentinel:
                break
            bplans, payload = item
            probs = self._forward(payload)
            out_plans.extend(bplans)
            out_probs.append(probs[: len(bplans)])
        if not out_plans:
            return []
        all_probs = torch.cat(out_probs).cpu().numpy()
        return [self._result(path, all_probs[i], idx, total)
                for i, (path, idx, total) in enumerate(out_plans)]
