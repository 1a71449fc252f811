"""Trainer — the epoch loop (counterpart of ``laryngeal_tpu/train/trainer.py``,
one device).

Per epoch: a train pass and a validation pass with loss / accuracy / AUROC
history, LR plateau scheduling (the specs that use it), the spec's
model-selection policy, early stopping, ``best_model/`` on improvement and a
rolling ``latest/`` every ``save_every`` epochs, ``training_history.json``;
at the end the best model is reloaded. ``resume`` restores model, optimizer
state, history and epoch counter and re-primes selection, early stopping and
plateau from the history, so a resumed run continues as an uninterrupted
one: the train step's random draws (the pytorchvideo augmentation, Swin3D's
stochastic depth, the CNN families' dropout) come from the config's seed and
the restored step count. resnet50_lstm trains with its ResNet trunk frozen
(``models.resnet.backbone_param_mask``) and, as in the JAX trainer, with the
LR plateau on. Runs on the
card unless ``device="cpu"`` is asked for. Not ported: the
mesh / tensor / pipeline / fsdp axes, the multi-process mode, the tracker
and the training-history plots (ROADMAP.md).
"""

from __future__ import annotations

import json
import logging
import time
from pathlib import Path
from typing import Dict, Optional, Union

import numpy as np
import torch

from ..evals import metrics as M
from ..models.registry import ModelSpec
from ..models.resnet import backbone_param_mask
from ..utils.device import resolve_device
from .checkpoint import load_checkpoint, save_checkpoint
from .losses import reference_pos_weight
from .selection import EarlyStopping, ReduceLROnPlateau, make_selection
from .state import TrainState, create_train_state, get_learning_rate, set_learning_rate
from .steps import make_eval_step, make_train_step, prepare_batch

HISTORY_KEYS = ("train_loss", "val_loss", "train_acc", "val_acc", "train_auroc",
                "val_auroc", "lr", "epoch_time")


class Trainer:
    def __init__(self, model: torch.nn.Module, spec: ModelSpec, loaders: Dict, config: Dict,
                 logger=None, exp_dir=None,
                 device: Optional[Union[str, torch.device]] = None):
        self.device = resolve_device(device)
        self.model = model.to(self.device)
        self.spec = spec
        self.loaders = loaders
        self.config = dict(config)
        self.logger = logger or logging.getLogger(__name__)
        self.exp_dir = Path(exp_dir) if exp_dir else Path("runs")
        self.exp_dir.mkdir(parents=True, exist_ok=True)

        train_ds = loaders["train"].dataset
        self.class_labels = train_ds.class_labels
        # Class weighting (2d-lstm: BCE pos_weight from the train distribution).
        pos = int(sum(train_ds.labels))
        neg = len(train_ds.labels) - pos
        self.pos_weight = reference_pos_weight(pos, neg) if spec.loss == "bce_pos_weight" else 1.0

        self.crop = int(config.get("crop_size", 224))
        trainable_mask = None
        if spec.name == "resnet50_lstm":  # the reference freezes the ResNet trunk
            trainable_mask = backbone_param_mask(self.model)
        self.state: TrainState = create_train_state(
            self.model, optimizer=spec.optimizer,
            learning_rate=config.get("learning_rate", spec.default_lr),
            weight_decay=config.get("weight_decay", spec.default_weight_decay),
            trainable_mask=trainable_mask)
        # The steps decode whatever wire the loaders ship; the dct wires need
        # the payload's geometry, the dataset's (w, h) wire_wh as (h, w).
        wire = getattr(train_ds, "wire", "rgb")
        wire_hw = None
        if wire in ("dct", "dctp"):
            ww, wh = getattr(train_ds, "wire_wh", train_ds.resize_to or (224, 224))
            wire_hw = (wh, ww)
        wire_kw = dict(wire=wire, wire_hw=wire_hw,
                       wire_quality=getattr(train_ds, "wire_quality", 75),
                       wire_keep_ac=getattr(train_ds, "wire_keep_ac", 31))
        self.train_step = make_train_step(
            self.model, spec.preprocess_regime, spec.loss, self.pos_weight, crop=self.crop,
            grad_accum=int(config.get("grad_accum_steps", 1)),
            seed=int(config.get("seed", 42)), **wire_kw)
        self.eval_step = make_eval_step(
            self.model, spec.preprocess_regime, spec.loss, self.pos_weight, crop=self.crop,
            **wire_kw)

        self.selection = make_selection(spec.selection,
                                        loss_weight=config.get("loss_weight", 0.3),
                                        acc_threshold=config.get("acc_threshold", 0.02))
        self.early_stopping = EarlyStopping(
            patience=config.get("patience", 7),
            delta=config.get("early_stopping_delta", 0.0),
        ) if config.get("use_early_stopping", True) else None
        self.plateau = ReduceLROnPlateau(
            lr=config.get("learning_rate", spec.default_lr), mode="max", factor=0.5,
            patience=5,
        ) if config.get("lr_plateau", spec.name == "resnet50_lstm") else None

        self.history: Dict = {k: [] for k in HISTORY_KEYS}
        self.start_epoch = 0
        self.best_path = self.exp_dir / "best_model"
        self._save_config()

    def resume(self, checkpoint_path) -> int:
        """Restore model, optimizer state, step, history and epoch counter,
        and re-prime selection / early stopping / plateau from the history."""
        restored = load_checkpoint(checkpoint_path, self.state, map_location=self.device)
        for k, v in restored["history"].items():
            if k in self.history and isinstance(v, list):
                self.history[k] = list(v)
        self.start_epoch = int(restored["epoch"]) + 1
        for i, vl in enumerate(self.history["val_loss"]):
            auroc_i = self.history["val_auroc"][i] if i < len(self.history["val_auroc"]) else 0.0
            acc_i = self.history["val_acc"][i] if i < len(self.history["val_acc"]) else 0.0
            self.selection(val_loss=vl, val_auroc=auroc_i, val_acc=acc_i)
            if self.early_stopping is not None:
                self.early_stopping(vl)
            if self.plateau is not None:
                self.plateau.step(auroc_i)
        if self.plateau is not None and self.history["lr"]:
            self.plateau.lr = self.history["lr"][-1]  # the optimizer's came with its state
        self.logger.info("Resumed from %s at epoch %d", checkpoint_path, self.start_epoch)
        return self.start_epoch

    def _save_config(self):
        cfg = {k: str(v) if isinstance(v, Path) else v for k, v in self.config.items()}
        cfg["model"] = self.spec.name
        with open(self.exp_dir / "training_config.json", "w") as f:
            json.dump(cfg, f, indent=4, default=str)

    def _run_epoch(self, split: str, train: bool, epoch: Optional[int] = None) -> Dict:
        """One pass over a split. Per-batch metrics stay on the device and
        come to the host in one transfer at the end of the pass."""
        loader = self.loaders[split]
        if train and epoch is not None and hasattr(loader, "set_epoch"):
            loader.set_epoch(epoch)  # absolute epoch: resumed runs shuffle the same
        scalars, probs_dev, masks, labels_host = [], [], [], []
        t_start = time.time()
        for batch in loader:
            pixel, labels, mask = prepare_batch(batch, self.device)
            if train:
                self.state, m = self.train_step(self.state, pixel, labels, mask)
            else:
                m = self.eval_step(self.state, pixel, labels, mask)
            scalars.append(torch.stack([m["loss"], m["correct"], m["count"]]))
            probs_dev.append(m["probs"])
            masks.append(np.asarray(batch["mask"]))
            labels_host.append(np.asarray(batch["labels"]))
        if scalars:
            host = torch.stack(scalars).double().cpu().numpy()
            valid = np.concatenate(masks)
            probs = torch.cat(probs_dev).cpu().numpy()[valid]
            labels = np.concatenate(labels_host)[valid]
            losses = [float(x) for x in host[:, 0]]
            correct, count = float(host[:, 1].sum()), float(host[:, 2].sum())
        else:
            losses, correct, count = [], 0.0, 0.0
            probs, labels = np.zeros((0, 2)), np.zeros((0,), int)
        auroc = 0.0
        if labels.size and np.unique(labels).size > 1:
            auroc = M.roc_auc_score(labels, probs[:, 1])
        return {
            "loss": float(np.mean(losses)) if losses else 0.0,
            "acc": correct / max(count, 1.0),
            "auroc": auroc,
            "clips_per_sec": count / max(time.time() - t_start, 1e-6),
        }

    def train(self) -> TrainState:
        epochs = int(self.config.get("epochs", 1))
        best_epoch = -1
        save_every = int(self.config.get("save_every", 1) or 0)
        for epoch in range(self.start_epoch, epochs):
            t0 = time.time()
            tr = self._run_epoch("train", train=True, epoch=epoch)
            va = self._run_epoch("val", train=False)
            dt = time.time() - t0

            lr = get_learning_rate(self.state)
            if self.plateau is not None:
                self.plateau.lr = lr
                new_lr = self.plateau.step(va["auroc"])
                if new_lr != lr:
                    self.logger.info("ReduceLROnPlateau: lr %.2e -> %.2e", lr, new_lr)
                    set_learning_rate(self.state, new_lr)
                    lr = new_lr

            for k, v in (("train_loss", tr["loss"]), ("val_loss", va["loss"]),
                         ("train_acc", tr["acc"]), ("val_acc", va["acc"]),
                         ("train_auroc", tr["auroc"]), ("val_auroc", va["auroc"]),
                         ("lr", lr), ("epoch_time", dt)):
                self.history[k].append(v)
            self.logger.info(
                "Epoch %d/%d — train loss %.4f acc %.4f auroc %.4f | "
                "val loss %.4f acc %.4f auroc %.4f | lr %.2e | %.1fs (%.1f clips/s train)",
                epoch + 1, epochs, tr["loss"], tr["acc"], tr["auroc"], va["loss"], va["acc"],
                va["auroc"], lr, dt, tr["clips_per_sec"])

            if self.selection(val_loss=va["loss"], val_auroc=va["auroc"], val_acc=va["acc"]):
                best_epoch = epoch
                save_checkpoint(self.best_path, self.state, epoch=epoch, history=self.history,
                                config=self.config, class_labels=self.class_labels)
                self.logger.info("Saved best model (epoch %d) to %s", epoch + 1,
                                 self.best_path)
            # Rolling preemption-safe checkpoint: a resumed run restarts from
            # the last epoch, not the last improvement.
            if save_every and (epoch + 1) % save_every == 0:
                save_checkpoint(self.exp_dir / "latest", self.state, epoch=epoch,
                                history=self.history, config=self.config,
                                class_labels=self.class_labels)

            if self.early_stopping is not None:
                self.early_stopping(va["loss"])
                if self.early_stopping.should_stop:
                    self.logger.info("Early stopping at epoch %d", epoch + 1)
                    break

        with open(self.exp_dir / "training_history.json", "w") as f:
            json.dump(self.history, f, indent=4, default=float)
        if best_epoch >= 0:
            self.logger.info("Reloading best model from epoch %d", best_epoch + 1)
            load_checkpoint(self.best_path, self.state, map_location=self.device)
        return self.state
