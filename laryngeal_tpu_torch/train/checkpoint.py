"""Checkpoints of the port: a directory holding ``model.pt`` (the model's
state_dict), ``optimizer.pt`` (the optimizer's state_dict and the step, when
a train state is saved) and ``metadata.json``.

The metadata keeps the JAX package's contract
(``laryngeal_tpu/train/checkpoint.py:87-95``): epoch, history, config
(``config.model_kwargs`` pins the architecture), ``class_labels`` and
``id2label`` / ``label2id``. A directory is written beside the target and
renamed over it, so a failed save leaves the previous checkpoint whole.
``load_checkpoint`` restores the model and, when given a train state, its
optimizer too: the mid-training resume of ``Trainer.resume``.
"""

from __future__ import annotations

import json
import shutil
from pathlib import Path
from typing import Any, Dict, Mapping, Optional, Union

import torch

from .state import TrainState

MODEL_FILE = "model.pt"
OPTIMIZER_FILE = "optimizer.pt"
METADATA_FILE = "metadata.json"


def save_checkpoint(path, state: Union[TrainState, Mapping[str, torch.Tensor]],
                    epoch: int = 0, history: Optional[Dict] = None,
                    config: Optional[Dict] = None, class_labels=None) -> str:
    """Write a checkpoint directory at ``path``. ``state`` is a TrainState
    (model, optimizer state and step are saved) or a model state_dict."""
    path = Path(path).absolute()
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.parent / (path.name + ".tmp")
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir()
    state_dict = state.model.state_dict() if isinstance(state, TrainState) else state
    torch.save({k: v.detach().cpu() for k, v in state_dict.items()}, tmp / MODEL_FILE)
    if isinstance(state, TrainState):
        torch.save({"optimizer": state.optimizer.state_dict(), "step": int(state.step)},
                   tmp / OPTIMIZER_FILE)
    class_labels = list(class_labels or [])
    meta = {
        "epoch": int(epoch),
        "history": history or {},
        "config": config or {},
        "class_labels": class_labels,
        "id2label": {str(i): c for i, c in enumerate(class_labels)},
        "label2id": {c: i for i, c in enumerate(class_labels)},
    }
    with open(tmp / METADATA_FILE, "w") as f:
        json.dump(meta, f, indent=4, default=str)
    if path.exists():
        shutil.rmtree(path)
    tmp.rename(path)
    return str(path)


def read_metadata(path) -> Dict[str, Any]:
    meta_path = Path(path) / METADATA_FILE
    return json.loads(meta_path.read_text()) if meta_path.exists() else {}


def load_checkpoint(path, state: Optional[TrainState] = None,
                    map_location="cpu") -> Dict[str, Any]:
    """Read {state_dict, epoch, history, config, class_labels, step} from
    ``path``. Given ``state``, also load the weights into ``state.model``
    and, when the checkpoint has them, the optimizer state and step into
    ``state.optimizer`` / ``state.step`` (returned as ``"state"``)."""
    path = Path(path).absolute()
    model_file = path / MODEL_FILE
    if not model_file.exists():
        raise FileNotFoundError(f"no {MODEL_FILE} in checkpoint directory {path}")
    state_dict = torch.load(model_file, map_location=map_location, weights_only=True)
    opt_file = path / OPTIMIZER_FILE
    opt = torch.load(opt_file, map_location=map_location, weights_only=True) \
        if opt_file.exists() else None
    if state is not None:
        state.model.load_state_dict(state_dict)
        if opt is not None:
            state.optimizer.load_state_dict(opt["optimizer"])
            state.step = int(opt["step"])
    meta = read_metadata(path)
    return {
        "state_dict": state_dict,
        "state": state,
        "step": opt["step"] if opt is not None else None,
        "epoch": meta.get("epoch", 0),
        "history": meta.get("history", {}),
        "config": meta.get("config", {}),
        "class_labels": meta.get("class_labels", []),
    }


def find_resume_checkpoint(log_dir, model_name: str) -> Optional[str]:
    """Newest resumable checkpoint under ``log_dir`` for ``--resume auto``:
    the rolling ``latest`` (preferred: it carries the last epoch) or
    ``best_model`` of the ``{model}-classifier-*/`` experiment dirs; the most
    recently modified wins, or None."""
    base = Path(log_dir)
    if not base.exists():
        return None
    candidates = []
    for exp in base.glob(f"{model_name}-classifier-*"):
        for name in ("latest", "best_model"):
            ck = exp / name
            if (ck / METADATA_FILE).exists():
                candidates.append((ck.stat().st_mtime, name == "latest", ck))
    if not candidates:
        return None
    candidates.sort()
    return str(candidates[-1][2])
