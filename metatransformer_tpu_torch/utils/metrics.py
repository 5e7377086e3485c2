"""Evaluation metrics: the reference's metric zoo, numpy.

A copy of ``metatransformer_tpu/utils/metrics.py`` (numpy only); the port
keeps its own so that nothing of the JAX package is imported.

Covers: ConfusionMatrix with OA/mAcc/mIoU (``openpoints/utils/metrics.py``),
AverageMeter, AST's mAP/AUC stats (``Audio/src/utilities/stats.py``),
Time-Series MAE/MSE/etc (``Time-Series/utils/metrics.py``), and
hyper-spectral OA/AA/kappa (``Hyper-spectrum/train.py``).
"""

from __future__ import annotations

from typing import Dict

import numpy as np


class AverageMeter:
    def __init__(self):
        self.reset()

    def reset(self):
        self.sum = 0.0
        self.count = 0

    def update(self, val: float, n: int = 1):
        self.sum += float(val) * n
        self.count += n

    @property
    def avg(self) -> float:
        return self.sum / max(self.count, 1)


class ConfusionMatrix:
    """Streaming confusion matrix -> OA / mAcc / per-class acc / mIoU."""

    def __init__(self, num_classes: int):
        self.num_classes = num_classes
        self.matrix = np.zeros((num_classes, num_classes), np.int64)

    def update(self, pred: np.ndarray, target: np.ndarray):
        pred = np.asarray(pred).reshape(-1)
        target = np.asarray(target).reshape(-1)
        valid = (target >= 0) & (target < self.num_classes)
        idx = target[valid] * self.num_classes + pred[valid]
        self.matrix += np.bincount(
            idx, minlength=self.num_classes**2
        ).reshape(self.num_classes, self.num_classes)

    @property
    def overall_accuracy(self) -> float:
        return float(np.trace(self.matrix)) / max(self.matrix.sum(), 1)

    @property
    def class_accuracy(self) -> np.ndarray:
        denom = np.maximum(self.matrix.sum(1), 1)
        return np.diag(self.matrix) / denom

    @property
    def mean_accuracy(self) -> float:
        present = self.matrix.sum(1) > 0
        return float(self.class_accuracy[present].mean()) if present.any() else 0.0

    @property
    def iou(self) -> np.ndarray:
        inter = np.diag(self.matrix).astype(np.float64)
        union = self.matrix.sum(1) + self.matrix.sum(0) - np.diag(self.matrix)
        return inter / np.maximum(union, 1)

    @property
    def miou(self) -> float:
        present = (self.matrix.sum(1) + self.matrix.sum(0)) > 0
        return float(self.iou[present].mean()) if present.any() else 0.0

    @property
    def kappa(self) -> float:
        """Cohen's kappa (Hyper-spectrum OA/AA/kappa report)."""
        n = self.matrix.sum()
        if n == 0:
            return 0.0
        po = np.trace(self.matrix) / n
        pe = float((self.matrix.sum(0) * self.matrix.sum(1)).sum()) / (n * n)
        return (po - pe) / max(1 - pe, 1e-12)


class CumulativeEnsemble:
    """Running-mean prediction ensemble across epochs — AST's checkpoint
    ensemble (``Audio/src/traintest.py:322-338`` ``validate_ensemble``:
    cum_predictions = mean of every epoch's validation predictions so
    far; its stats are the 'cum_stats' reported next to per-epoch ones).
    """

    def __init__(self):
        self.cum: np.ndarray | None = None
        self.n = 0

    def update(self, predictions: np.ndarray) -> np.ndarray:
        """Fold in one epoch's predictions; returns the current mean."""
        predictions = np.asarray(predictions, np.float64)
        if self.cum is None:
            self.cum = predictions.copy()
        else:
            self.cum = (self.cum * self.n + predictions) / (self.n + 1)
        self.n += 1
        return self.cum


def average_precision(scores: np.ndarray, targets: np.ndarray) -> float:
    """AP for one class (AST ``calculate_stats`` building block)."""
    order = np.argsort(-scores)
    t = targets[order]
    tp = np.cumsum(t)
    precision = tp / np.arange(1, len(t) + 1)
    pos = t.sum()
    if pos == 0:
        return float("nan")
    return float((precision * t).sum() / pos)


def auc_roc(scores: np.ndarray, targets: np.ndarray) -> float:
    """Binary ROC-AUC by rank statistic."""
    pos = scores[targets > 0]
    neg = scores[targets <= 0]
    if len(pos) == 0 or len(neg) == 0:
        return float("nan")
    ranks = np.argsort(np.argsort(np.concatenate([pos, neg])))
    return float(
        (ranks[: len(pos)].sum() - len(pos) * (len(pos) - 1) / 2)
        / (len(pos) * len(neg))
    )


def audio_stats(scores: np.ndarray, targets: np.ndarray) -> Dict[str, float]:
    """Per-class AP/AUC averaged + accuracy (``utilities/stats.py``)."""
    aps, aucs = [], []
    for c in range(scores.shape[1]):
        aps.append(average_precision(scores[:, c], targets[:, c]))
        aucs.append(auc_roc(scores[:, c], targets[:, c]))
    acc = float(
        (scores.argmax(1) == targets.argmax(1)).mean()
    )
    return {
        "mAP": float(np.nanmean(aps)),
        "AUC": float(np.nanmean(aucs)),
        "acc": acc,
    }


def regression_metrics(pred: np.ndarray, true: np.ndarray) -> Dict[str, float]:
    """Time-Series metric set (MAE/MSE/RMSE/MAPE/MSPE)."""
    err = pred - true
    mae = float(np.mean(np.abs(err)))
    mse = float(np.mean(err**2))
    denom = np.where(np.abs(true) > 1e-8, true, 1e-8)
    return {
        "mae": mae,
        "mse": mse,
        "rmse": float(np.sqrt(mse)),
        "mape": float(np.mean(np.abs(err / denom))),
        "mspe": float(np.mean((err / denom) ** 2)),
    }
