"""Model registry (counterpart of ``laryngeal_tpu/models/registry.py``).

All five families: ViViT, TimeSformer, Swin3D, 3D-ResNet50 and
ResNet50-2D + LSTM.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Tuple

from .resnet import create_resnet50_lstm
from .resnet3d import create_resnet3d
from .swin3d import create_swin3d
from .timesformer import create_timesformer
from .vivit import create_vivit

VIT_FLAGS = ("hidden_size", "num_layers", "num_heads", "intermediate_size")


@dataclasses.dataclass(frozen=True)
class ModelSpec:
    name: str
    factory: Callable
    preprocess_regime: str        # 'pytorchvideo' | 'vivit' | 'timesformer'
    loss: str                     # 'ce' | 'bce_pos_weight'
    optimizer: str                # 'adam' | 'adamw'
    default_num_frames: int
    default_lr: float
    default_weight_decay: float
    label_policy: str             # dataset label policy
    selection: str                # 'min_loss' | 'composite' | 'loss_acc_threshold'
    per_video_seed: bool = False  # resnet3d-style deterministic sampling
    reference: str = ""
    # CLI flags that pin the family's architecture in a checkpoint's
    # model_kwargs (written by the training CLI, read by the predictor).
    arch_flags: Tuple[str, ...] = ()


MODEL_REGISTRY: Dict[str, ModelSpec] = {
    "resnet50_lstm": ModelSpec(
        name="resnet50_lstm", factory=create_resnet50_lstm,
        preprocess_regime="pytorchvideo", loss="bce_pos_weight",
        optimizer="adam", default_num_frames=32, default_lr=1e-3,
        default_weight_decay=0.0, label_policy="referral",
        selection="composite",
        reference="resnet50-2d-lstm/src/models/model.py:10-59",
        arch_flags=("hidden_size", "num_layers", "dropout"),
    ),
    "resnet3d": ModelSpec(
        name="resnet3d", factory=create_resnet3d,
        preprocess_regime="pytorchvideo", loss="ce",
        optimizer="adam", default_num_frames=32, default_lr=1e-3,
        default_weight_decay=0.0, label_policy="referral",
        selection="loss_acc_threshold", per_video_seed=True,
        reference="resnet50-3d-video/video_classifier/models/resnet3d.py:4-49",
        arch_flags=("dropout",),
    ),
    "vivit": ModelSpec(
        name="vivit", factory=create_vivit,
        preprocess_regime="vivit", loss="ce",
        optimizer="adamw", default_num_frames=32, default_lr=1e-3,
        default_weight_decay=0.01, label_policy="sorted",
        selection="min_loss",
        reference="vivit_transformer/vivit_classifier/models/vivit_model.py:4-52",
        arch_flags=VIT_FLAGS,
    ),
    "timesformer": ModelSpec(
        name="timesformer", factory=create_timesformer,
        preprocess_regime="timesformer", loss="ce",
        # 32 frames, the reference CLI's default (timesformer/main.py:39).
        optimizer="adamw", default_num_frames=32, default_lr=1e-3,
        default_weight_decay=0.01, label_policy="sorted",
        selection="min_loss",
        reference="timesformer/timesformer_classifier/models/timesformer_model.py:27-43",
        arch_flags=VIT_FLAGS,
    ),
    "swin3d": ModelSpec(
        name="swin3d", factory=create_swin3d,
        preprocess_regime="pytorchvideo", loss="ce",
        optimizer="adamw", default_num_frames=32, default_lr=1e-4,
        default_weight_decay=0.05, label_policy="referral",
        selection="loss_acc_threshold",
        reference="videoswintransformer/swin_video_classifier/models/swin3d.py:7-53",
        arch_flags=("model_size", "stochastic_depth"),
    ),
}


def get_model_spec(name: str) -> ModelSpec:
    if name not in MODEL_REGISTRY:
        raise ValueError(f"Unknown model {name!r}; expected one of {sorted(MODEL_REGISTRY)}")
    return MODEL_REGISTRY[name]


def create_model(name: str, **kwargs):
    """Instantiate a backbone by registry name."""
    return get_model_spec(name).factory(**kwargs)
