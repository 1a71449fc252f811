"""Evaluator — test-set metrics + JSON output (counterpart of
``laryngeal_tpu/evals/evaluator.py``).

Parity: ``vivit_transformer/vivit_classifier/evaluators/evaluator.py:122-255``:
returns ``(auroc, f1, confusion_matrix)`` and writes
``test_metrics_{sampling}.json`` with a ``per_video`` list. Per-batch
outputs stay on the device and are fetched once at the end of a pass. Plots
are drawn only through a visualizer passed in; the port has none yet
(``utils/visualization.py`` is not ported, ROADMAP.md).
"""

from __future__ import annotations

import json
import logging
from pathlib import Path
from typing import Sequence, Tuple

import numpy as np
import torch

from ..train.steps import prepare_batch
from ..utils.device import resolve_device
from . import metrics as M


def _jsonable(obj):
    if isinstance(obj, np.ndarray):
        return obj.tolist()
    if isinstance(obj, dict):
        return {k: _jsonable(v) for k, v in obj.items()}
    if isinstance(obj, (np.floating, np.integer)):
        return obj.item()
    if isinstance(obj, (list, tuple)):
        return [_jsonable(v) for v in obj]
    return obj


class Evaluator:
    def __init__(self, eval_step, loader, class_names: Sequence[str] = ("non_referral",
                                                                       "referral"),
                 logger=None, exp_dir=None, visualizer=None, device=None):
        self.eval_step = eval_step
        self.loader = loader
        self.class_names = list(class_names)
        self.logger = logger or logging.getLogger(__name__)
        self.exp_dir = Path(exp_dir) if exp_dir else None
        self.visualizer = visualizer
        self.device = resolve_device(device)

    def _run_pass(self, state):
        probs_dev, loss_dev, masks, labels_all, paths = [], [], [], [], []
        for batch in self.loader:
            pixel, labels, mask = prepare_batch(batch, self.device)
            m = self.eval_step(state, pixel, labels, mask)
            probs_dev.append(m["probs"])
            loss_dev.append(m["loss"])
            valid = np.asarray(batch["mask"])
            masks.append(valid)
            labels_all.append(np.asarray(batch["labels"])[valid])
            paths.extend(p for p, ok in zip(batch["video_paths"], valid) if ok)
        if not probs_dev:
            return np.zeros((0, 2)), np.zeros((0,), int), [], []
        probs = torch.cat(probs_dev).cpu().numpy()[np.concatenate(masks)]
        losses = torch.stack(loss_dev).cpu().numpy()
        return probs, np.concatenate(labels_all), paths, [float(x) for x in losses]

    def evaluate(self, state, sampling_method: str = "uniform",
                 eval_clips: int = 1) -> Tuple[float, float, np.ndarray]:
        """eval_clips > 1 averages per-video probabilities over clips drawn
        by a stochastic sampler (the resnet3d evaluator's clip mean,
        resnet50-3d-video/.../evaluators/evaluator.py:289-302); with
        'uniform' sampling the extra passes would repeat, so they are
        skipped."""
        sampler = getattr(self.loader.dataset, "sampler", None)
        passes = 1
        if eval_clips > 1 and sampler is not None and sampler.method != "uniform":
            passes = int(eval_clips)
        probs_sum = None
        labels = paths = None
        losses = []
        for p in range(passes):
            if passes > 1:
                self.loader.dataset.resample_clips(p)
            probs, labels, paths, pass_losses = self._run_pass(state)
            losses.extend(pass_losses)
            probs_sum = probs if probs_sum is None else probs_sum + probs
        if passes > 1:
            self.loader.dataset.resample_clips(0)
        probs = probs_sum / passes if probs_sum is not None else np.zeros((0, 2))
        preds = probs.argmax(axis=-1) if probs.size else np.zeros((0,), int)

        metrics = M.compute_all_metrics(labels, preds, probs, self.class_names)
        metrics["test_loss"] = float(np.mean(losses)) if losses else 0.0
        for k in ("accuracy", "f1_score", "precision", "recall", "auroc"):
            self.logger.info("%s: %.4f", k, metrics.get(k, 0.0))

        if self.exp_dir is not None:
            out = self.exp_dir / f"test_metrics_{sampling_method}.json"
            payload = {k: _jsonable(v) for k, v in metrics.items()}
            payload["per_video"] = [
                {"video_path": p, "label": int(l), "pred": int(pr),
                 "prob_referral": float(pb[1])}
                for p, l, pr, pb in zip(paths, labels, preds, probs)]
            with open(out, "w") as f:
                json.dump(payload, f, indent=4)
            self.logger.info("Saved test metrics to %s", out)

        if self.visualizer is not None:
            try:
                self.visualizer.plot_confusion_matrix(
                    metrics.get("confusion_matrix", np.zeros((2, 2))), self.class_names)
                if "roc_curve" in metrics:
                    self.visualizer.plot_roc_curve(metrics)
                self.visualizer.plot_evaluation_metrics(metrics, self.class_names)
            except Exception as e:  # plots must never fail an evaluation
                self.logger.warning("Evaluation plots failed: %s", e)

        return (metrics.get("auroc", 0.0), metrics.get("f1_score", 0.0),
                metrics.get("confusion_matrix", np.array([])))
