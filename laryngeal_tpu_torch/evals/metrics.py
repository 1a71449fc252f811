"""Classification metrics in pure numpy.

The port's own copy of ``laryngeal_tpu/evals/metrics.py``.

Covers the full metric surface the reference computes with sklearn
(``vivit_transformer/vivit_classifier/evaluators/evaluator.py:257-401``):
accuracy, confusion matrix, precision/recall/F1 (binary and weighted
multiclass), ROC curve + AUROC, PR curve + average precision, optimal
threshold (argmax tpr-fpr), best-F1 threshold, specificity, NPV.

Pure numpy so the framework has no hard sklearn dependency; parity is
verified against sklearn in tests (sklearn is available in this image but is
treated as a test-only dependency).
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np

__all__ = [
    "accuracy_score",
    "confusion_matrix",
    "precision_recall_f1",
    "roc_curve",
    "roc_auc_score",
    "precision_recall_curve",
    "average_precision_score",
    "optimal_roc_threshold",
    "best_f1_threshold",
    "specificity_npv",
    "compute_all_metrics",
]


def _as1d(x) -> np.ndarray:
    return np.asarray(x).reshape(-1)


def accuracy_score(y_true, y_pred) -> float:
    y_true, y_pred = _as1d(y_true), _as1d(y_pred)
    if y_true.size == 0:
        return 0.0
    return float(np.mean(y_true == y_pred))


def confusion_matrix(y_true, y_pred, num_classes: Optional[int] = None) -> np.ndarray:
    """Rows = true class, cols = predicted class (sklearn convention)."""
    y_true, y_pred = _as1d(y_true).astype(np.int64), _as1d(y_pred).astype(np.int64)
    if num_classes is None:
        num_classes = int(max(y_true.max(initial=-1), y_pred.max(initial=-1)) + 1)
        num_classes = max(num_classes, 1)
    cm = np.zeros((num_classes, num_classes), dtype=np.int64)
    np.add.at(cm, (y_true, y_pred), 1)
    return cm


def precision_recall_f1(
    y_true, y_pred, average: str = "binary", zero_division: float = 0.0
) -> Tuple[float, float, float]:
    """Precision, recall, F1. ``average``: 'binary' (positive class = 1) or
    'weighted' (support-weighted per-class, matching sklearn)."""
    y_true, y_pred = _as1d(y_true), _as1d(y_pred)
    if y_true.size == 0:
        return zero_division, zero_division, zero_division
    if average == "binary":
        tp = float(np.sum((y_pred == 1) & (y_true == 1)))
        fp = float(np.sum((y_pred == 1) & (y_true == 0)))
        fn = float(np.sum((y_pred == 0) & (y_true == 1)))
        p = tp / (tp + fp) if (tp + fp) > 0 else zero_division
        r = tp / (tp + fn) if (tp + fn) > 0 else zero_division
        f1 = 2 * p * r / (p + r) if (p + r) > 0 else zero_division
        return p, r, f1
    if average == "weighted":
        classes = np.unique(y_true)
        ps, rs, f1s, ws = [], [], [], []
        for c in classes:
            tp = float(np.sum((y_pred == c) & (y_true == c)))
            fp = float(np.sum((y_pred == c) & (y_true != c)))
            fn = float(np.sum((y_pred != c) & (y_true == c)))
            p = tp / (tp + fp) if (tp + fp) > 0 else zero_division
            r = tp / (tp + fn) if (tp + fn) > 0 else zero_division
            f1 = 2 * p * r / (p + r) if (p + r) > 0 else zero_division
            ps.append(p); rs.append(r); f1s.append(f1)
            ws.append(float(np.sum(y_true == c)))
        w = np.asarray(ws) / np.sum(ws)
        return float(np.dot(w, ps)), float(np.dot(w, rs)), float(np.dot(w, f1s))
    raise ValueError(f"Unknown average {average!r}")


def roc_curve(y_true, y_score) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """ROC curve with sklearn semantics: thresholds descending, curve points
    only at score boundaries (drop-intermediate NOT applied — all unique
    thresholds kept, matching sklearn's default except for its collinearity
    pruning, which does not affect AUROC or argmax(tpr-fpr))."""
    y_true, y_score = _as1d(y_true).astype(np.float64), _as1d(y_score).astype(np.float64)
    order = np.argsort(-y_score, kind="stable")
    y_true, y_score = y_true[order], y_score[order]

    # Indices where the score changes (threshold boundaries).
    distinct = np.where(np.diff(y_score))[0]
    threshold_idxs = np.r_[distinct, y_true.size - 1]

    tps = np.cumsum(y_true)[threshold_idxs]
    fps = 1 + threshold_idxs - tps
    thresholds = y_score[threshold_idxs]

    # Prepend the (0,0) point with threshold = inf (sklearn uses inf).
    tps = np.r_[0.0, tps]
    fps = np.r_[0.0, fps]
    thresholds = np.r_[np.inf, thresholds]

    n_pos = tps[-1]
    n_neg = fps[-1]
    tpr = tps / n_pos if n_pos > 0 else np.zeros_like(tps)
    fpr = fps / n_neg if n_neg > 0 else np.zeros_like(fps)
    return fpr, tpr, thresholds


def roc_auc_score(y_true, y_score) -> float:
    """AUROC via the Mann-Whitney U statistic (tie-aware; exactly the
    trapezoidal area under the sklearn ROC curve)."""
    y_true, y_score = _as1d(y_true).astype(np.float64), _as1d(y_score).astype(np.float64)
    pos = y_score[y_true == 1]
    neg = y_score[y_true == 0]
    if pos.size == 0 or neg.size == 0:
        raise ValueError("roc_auc_score requires both classes present")
    # Midranks handle ties exactly.
    all_scores = np.concatenate([pos, neg])
    order = np.argsort(all_scores, kind="stable")
    ranks = np.empty_like(order, dtype=np.float64)
    sorted_scores = all_scores[order]
    i = 0
    n = all_scores.size
    rank_vals = np.arange(1, n + 1, dtype=np.float64)
    while i < n:
        j = i
        while j + 1 < n and sorted_scores[j + 1] == sorted_scores[i]:
            j += 1
        rank_vals[i : j + 1] = 0.5 * (i + 1 + j + 1)
        i = j + 1
    ranks[order] = rank_vals
    r_pos = np.sum(ranks[: pos.size])
    auc = (r_pos - pos.size * (pos.size + 1) / 2.0) / (pos.size * neg.size)
    return float(auc)


def precision_recall_curve(y_true, y_score) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """PR curve with sklearn semantics: returned in order of increasing
    recall→decreasing... precisely: thresholds ascending-score order reversed —
    precision/recall arrays end with (1, 0) sentinel and have
    ``len(thresholds) = len(precision) - 1``."""
    y_true, y_score = _as1d(y_true).astype(np.float64), _as1d(y_score).astype(np.float64)
    order = np.argsort(-y_score, kind="stable")
    y_true, y_score = y_true[order], y_score[order]

    distinct = np.where(np.diff(y_score))[0]
    threshold_idxs = np.r_[distinct, y_true.size - 1]

    tps = np.cumsum(y_true)[threshold_idxs]
    fps = 1 + threshold_idxs - tps
    thresholds = y_score[threshold_idxs]

    n_pos = tps[-1] if tps.size else 0.0
    denom = tps + fps
    precision = np.divide(tps, denom, out=np.zeros_like(tps, dtype=np.float64), where=denom > 0)
    recall = tps / n_pos if n_pos > 0 else np.zeros_like(tps)

    # sklearn cuts after full recall is reached and reverses.
    last_ind = int(np.searchsorted(tps, n_pos)) if n_pos > 0 else tps.size - 1
    sl = slice(last_ind, None, -1)
    precision = np.r_[precision[sl], 1.0]
    recall = np.r_[recall[sl], 0.0]
    thresholds = thresholds[sl]
    return precision, recall, thresholds


def average_precision_score(y_true, y_score) -> float:
    precision, recall, _ = precision_recall_curve(y_true, y_score)
    # AP = sum((R_n - R_{n+1}) * P_n)  over the reversed arrays.
    return float(-np.sum(np.diff(recall) * precision[:-1]))


def optimal_roc_threshold(y_true, y_score) -> float:
    """Threshold maximizing Youden's J = tpr - fpr (reference evaluator.py:297-299)."""
    fpr, tpr, thr = roc_curve(y_true, y_score)
    return float(thr[int(np.argmax(tpr - fpr))])


def best_f1_threshold(y_true, y_score) -> Optional[float]:
    """Threshold with max F1 along the PR curve (reference evaluator.py:311-325).

    Matches the reference's loop: iterate PR points (excluding the final
    sentinel), compute F1, return the threshold at the argmax if in range.
    """
    precision, recall, thresholds = precision_recall_curve(y_true, y_score)
    if thresholds.size == 0:
        return None
    f1s = []
    for i in range(len(precision) - 1):
        p, r = precision[i], recall[i]
        f1s.append(2 * p * r / (p + r) if (p + r) > 0 else 0.0)
    if not f1s:
        return None
    best = int(np.argmax(f1s))
    if best < len(thresholds):
        return float(thresholds[best])
    return None


def specificity_npv(cm: np.ndarray) -> Tuple[float, float]:
    """Specificity and negative predictive value from a 2x2 confusion matrix
    (reference evaluator.py:389-394)."""
    tn, fp, fn, tp = [float(v) for v in np.asarray(cm).ravel()]
    spec = tn / (tn + fp) if (tn + fp) > 0 else 0.0
    npv = tn / (tn + fn) if (tn + fn) > 0 else 0.0
    return spec, npv


def compute_all_metrics(
    labels,
    preds,
    probs,
    class_names: Sequence[str] = ("non_referral", "referral"),
) -> Dict:
    """Full reference-schema metrics dict (evaluator.py:257-401).

    ``probs`` is (N, C) class probabilities; binary metrics use column 1.
    Degenerate inputs degrade to defaults instead of raising (the reference's
    error-handling contract: AUROC 0.0, F1 0.0, empty CM).
    """
    labels, preds = _as1d(labels), _as1d(preds)
    probs = np.asarray(probs)
    metrics: Dict = {}

    if labels.size == 0 or preds.size == 0:
        return {"accuracy": 0.0, "f1_score": 0.0, "auroc": 0.0,
                "confusion_matrix": np.array([])}

    num_classes = max(len(class_names), 2)
    metrics["accuracy"] = accuracy_score(labels, preds)
    metrics["confusion_matrix"] = confusion_matrix(labels, preds, num_classes)

    binary = len(class_names) == 2
    avg = "binary" if binary else "weighted"
    p, r, f1 = precision_recall_f1(labels, preds, average=avg)
    metrics["precision"], metrics["recall"], metrics["f1_score"] = p, r, f1

    pos_scores = probs[:, 1] if probs.ndim > 1 and probs.shape[1] > 1 else probs.reshape(-1)
    if np.unique(labels).size > 1 and probs.size > 0:
        if binary:
            metrics["auroc"] = roc_auc_score(labels, pos_scores)
            fpr, tpr, thr = roc_curve(labels, pos_scores)
            metrics["roc_curve"] = {"fpr": fpr, "tpr": tpr, "thresholds": thr}
            metrics["optimal_threshold"] = float(thr[int(np.argmax(tpr - fpr))])
            prec, rec, pr_thr = precision_recall_curve(labels, pos_scores)
            metrics["pr_curve"] = {"precision": prec, "recall": rec,
                                   "thresholds": pr_thr if pr_thr.size else []}
            metrics["average_precision"] = average_precision_score(labels, pos_scores)
            bft = best_f1_threshold(labels, pos_scores)
            if bft is not None:
                metrics["best_f1_threshold"] = bft
        else:
            # Macro one-vs-rest AUROC + per-class AUROC.
            aucs = {}
            vals = []
            for i, name in enumerate(class_names):
                y_bin = (labels == i).astype(np.int64)
                try:
                    a = roc_auc_score(y_bin, probs[:, i])
                except ValueError:
                    a = 0.0
                aucs[name] = a
                vals.append(a)
            metrics["class_auroc"] = aucs
            metrics["auroc"] = float(np.mean(vals)) if vals else 0.0
    else:
        metrics["auroc"] = 0.0
        metrics["roc_curve"] = {"fpr": [0, 1], "tpr": [0, 1], "thresholds": [1, 0]}
        metrics["pr_curve"] = {"precision": [1, 0], "recall": [0, 1], "thresholds": []}
        metrics["average_precision"] = 0.0

    cm = metrics["confusion_matrix"]
    if getattr(cm, "shape", None) == (2, 2):
        spec, npv = specificity_npv(cm)
        metrics["specificity"] = spec
        metrics["npv"] = npv
    return metrics
