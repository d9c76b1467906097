"""Segmentation evaluation metrics from a confusion matrix (port of
fedml_tpu/core/seg_metrics.py).

Parity: fedml_api/distributed/fedseg/utils.py (Evaluator with
pixel-accuracy / class-accuracy / mIoU / FWIoU) and the per-class metric
keeper in FedSegAggregator.py:105-186 (`EvaluationMetricsKeeper`).

The confusion matrix is one ``torch.bincount`` on the device; the metrics
derive from it on the host, in numpy, as in the JAX package.  The counts
are int64 (the JAX package sums f32 counts, exact only up to 2^24 pixels);
the metrics read them as float64.
"""
from __future__ import annotations

import numpy as np
import torch


def confusion_matrix(pred: torch.Tensor, label: torch.Tensor,
                     mask: torch.Tensor, num_classes: int) -> torch.Tensor:
    """[C, C] int64 counts; rows = true class, cols = predicted.  Pixels
    with mask 0 or a label outside [0, C) (VOC's void 255) are left out,
    the reference Evaluator's ``(gt >= 0) & (gt < num_class)`` mask
    (fedseg utils.py Evaluator._generate_matrix)."""
    lab = label.reshape(-1).long()
    valid = (mask.reshape(-1) > 0) & (lab >= 0) & (lab < num_classes)
    idx = lab * num_classes + pred.reshape(-1).long()
    idx = torch.where(valid, idx, torch.full_like(idx, num_classes ** 2))
    counts = torch.bincount(idx, minlength=num_classes ** 2 + 1)
    return counts[:-1].reshape(num_classes, num_classes)


def pixel_accuracy(cm: np.ndarray) -> float:
    return float(np.diag(cm).sum() / np.maximum(cm.sum(), 1.0))


def pixel_accuracy_class(cm: np.ndarray) -> float:
    per = np.diag(cm) / np.maximum(cm.sum(axis=1), 1.0)
    return float(np.nanmean(per))


def mean_iou(cm: np.ndarray) -> float:
    inter = np.diag(cm)
    union = cm.sum(axis=1) + cm.sum(axis=0) - inter
    iou = inter / np.maximum(union, 1.0)
    present = cm.sum(axis=1) > 0
    return float(iou[present].mean()) if present.any() else 0.0


def frequency_weighted_iou(cm: np.ndarray) -> float:
    freq = cm.sum(axis=1) / np.maximum(cm.sum(), 1.0)
    inter = np.diag(cm)
    union = cm.sum(axis=1) + cm.sum(axis=0) - inter
    iou = inter / np.maximum(union, 1.0)
    return float((freq[freq > 0] * iou[freq > 0]).sum())


class EvaluationMetricsKeeper:
    """Round-indexed best-metric tracker (FedSegAggregator.py:105-186)."""

    def __init__(self):
        self.history: list[dict] = []
        self.best: dict[str, float] = {}

    def update(self, round_idx: int, metrics: dict) -> None:
        entry = dict(metrics, round=round_idx)
        self.history.append(entry)
        for k, v in metrics.items():
            if isinstance(v, (int, float)) and v > self.best.get(k, -np.inf):
                self.best[k] = float(v)

    def summary(self) -> dict:
        return {"best": dict(self.best), "rounds": len(self.history)}
