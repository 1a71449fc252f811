"""Predictor — decode -> preprocess -> backbone -> probabilities on the card
(counterpart of ``laryngeal_tpu/infer/predictor.py``).

Decode, frame sampling and the wire encode stay on the host; from the
payload batch on, everything runs eagerly under ``torch.inference_mode()``
on ``device``: the wire decode (rgb passes through; i420, delta, dct and
dctp decode to RGB, ``preprocess.transforms.decode_wire_batch``), the
model's preprocessing regime (ViViT, TimeSformer
or pytorchvideo for Swin3D and the two CNN families), the model (its
attention in the CUDA kernels: flash for ViViT, short-sequence for
TimeSformer, shifted-window for Swin3D; cuDNN convolutions for 3D-ResNet50
and ResNet50 + LSTM), softmax, or for resnet50_lstm's one BCE logit its
sigmoid as two-class probabilities. ``device=None`` means ``cuda`` and raises
without a card; the CPU is used only when asked for.
"""

from __future__ import annotations

import logging
from typing import Dict, Optional, Union

import numpy as np
import torch

from ..data.samplers import FrameSampler
from ..models.registry import ModelSpec, create_model, get_model_spec
from ..preprocess.transforms import batch_preprocess, check_wire, decode_wire_batch
from ..train.checkpoint import load_checkpoint, read_metadata
from ..train.losses import probs_fn
from ..utils.device import resolve_device
from .base import VideoPredictorBase

DEFAULT_CLASSES = ["non_referral", "referral"]


def resolve_dtype(dtype: Union[str, torch.dtype]) -> torch.dtype:
    """torch.dtype or its name ('float32', 'bfloat16')."""
    if isinstance(dtype, torch.dtype):
        return dtype
    resolved = getattr(torch, str(dtype), None)
    if not isinstance(resolved, torch.dtype):
        raise ValueError(f"unknown dtype {dtype!r}")
    return resolved


class Predictor(VideoPredictorBase):
    def __init__(self, model: torch.nn.Module, spec: ModelSpec, class_labels=None,
                 num_frames: int = 32, sampling_method: str = "uniform",
                 crop_size: int = 224, logger=None, wire: str = "rgb",
                 device: Optional[Union[str, torch.device]] = None, wire_quality: int = 75,
                 wire_keep_ac: int = 31, wire_pack_from: int = 14, wire_lowres: int = 0):
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.spec = spec
        self.class_labels = list(class_labels or DEFAULT_CLASSES)
        self.num_frames = num_frames
        self.sampling_method = sampling_method
        self.crop_size = crop_size
        self.logger = logger or logging.getLogger(__name__)
        # The serving wire (the training feed's transport); dct and dctp
        # are lossy. wire_lowres ships (crop >> n) pixels on a non-rgb wire,
        # which the preprocessing resizes to the model's input.
        self.wire = wire
        self.wire_quality = int(wire_quality)
        self.wire_keep_ac = int(wire_keep_ac)
        self.wire_pack_from = int(wire_pack_from)
        self.wire_lowres = int(wire_lowres) if wire != "rgb" else 0
        whw = self._wire_hw()
        self.wire_hw = (whw, whw)
        check_wire(wire, self.wire_hw if wire in ("dct", "dctp") else None)
        self.sampler = FrameSampler(sampling_method, num_frames,
                                    per_video_seed=spec.per_video_seed)
        self._probs = probs_fn(spec.loss)

    def payload_to_device(self, payload):
        """A host payload (an array, or a dct wire's tuple of arrays) as
        tensors on the predictor's device."""
        if isinstance(payload, tuple):
            return tuple(torch.from_numpy(np.ascontiguousarray(x)).to(self.device)
                         for x in payload)
        return torch.from_numpy(np.ascontiguousarray(payload)).to(self.device)

    @torch.inference_mode()
    def _forward(self, payload) -> torch.Tensor:
        """The batched wire payload (numpy; a tuple on the dct wires) ->
        (B, num_classes) float32 probabilities, left on the device."""
        pixel = decode_wire_batch(self.payload_to_device(payload), self.wire, self.wire_hw,
                                  self.wire_quality, self.wire_keep_ac)
        clips = batch_preprocess(pixel, self.spec.preprocess_regime, train=False,
                                 crop=self.crop_size)
        return self._probs(self.model(clips))

    @classmethod
    def from_checkpoint(cls, model_name: str, checkpoint_path,
                        num_frames: Optional[int] = None,
                        sampling_method: str = "uniform", num_classes: int = 2,
                        crop_size: Optional[int] = None,
                        image_size: Optional[int] = None,
                        arch_defaults: Optional[Dict] = None, logger=None,
                        model_kwargs: Optional[Dict] = None, wire: str = "rgb",
                        device: Optional[Union[str, torch.device]] = None,
                        wire_quality: int = 75, wire_keep_ac: int = 31,
                        wire_pack_from: int = 14, wire_lowres: int = 0) -> "Predictor":
        """Load a port checkpoint (``train/checkpoint.py``). Metadata may pin
        the architecture: explicit caller arguments win, metadata fills the
        gaps, spec defaults last (the JAX predictor's precedence). The
        compute dtype is part of it: ``model_kwargs['dtype']`` ('bfloat16',
        'float32'), float32 when neither names one. ``arch_defaults`` (the
        CLIs' architecture flags, e.g. Swin3D's ``model_size``) apply only
        where the metadata names nothing; resnet50_lstm's ``hidden_size`` /
        ``num_layers`` come this way from ``cli.inference``."""
        spec = get_model_spec(model_name)
        device = resolve_device(device)
        meta_cfg = read_metadata(checkpoint_path).get("config", {})
        saved_kwargs = dict(meta_cfg.get("model_kwargs", {}))
        saved_num_frames = saved_kwargs.pop("num_frames", None)
        saved_image = saved_kwargs.pop("image_size", None)

        num_frames = num_frames or saved_num_frames or spec.default_num_frames
        # One resolution drives the model config AND the decode/preprocess
        # crop — they must agree or the patch counts mismatch.
        resolution = (crop_size or image_size or saved_image
                      or meta_cfg.get("crop_size") or 224)
        kwargs = dict(num_classes=num_classes, num_frames=num_frames,
                      image_size=resolution, **(arch_defaults or {}))
        kwargs.update(saved_kwargs)
        kwargs.update(model_kwargs or {})
        if "dtype" in kwargs:
            kwargs["dtype"] = resolve_dtype(kwargs["dtype"])
        model = create_model(model_name, seed=None, **kwargs)
        restored = load_checkpoint(checkpoint_path)
        model.load_state_dict(restored["state_dict"])
        class_labels = restored["class_labels"] or DEFAULT_CLASSES
        return cls(model, spec, class_labels, num_frames, sampling_method,
                   resolution, logger, wire=wire, device=device, wire_quality=wire_quality,
                   wire_keep_ac=wire_keep_ac, wire_pack_from=wire_pack_from,
                   wire_lowres=wire_lowres)
