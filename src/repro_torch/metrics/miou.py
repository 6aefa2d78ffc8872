"""Mean Intersection-over-Union, computed exactly as the paper (§4.1):
per-class IoU = TP / (TP + FP + FN), averaged over classes; scores measured
*relative to the teacher's labels*."""
from __future__ import annotations

import numpy as np


def confusion(pred: np.ndarray, target: np.ndarray, n_classes: int) -> np.ndarray:
    idx = (target.reshape(-1).astype(np.int64) * n_classes + pred.reshape(-1)).astype(np.int64)
    return np.bincount(idx, minlength=n_classes * n_classes).reshape(n_classes, n_classes)


def miou_from_confusion(cm: np.ndarray) -> float:
    tp = np.diag(cm).astype(np.float64)
    fp = cm.sum(axis=0) - tp
    fn = cm.sum(axis=1) - tp
    union = tp + fp + fn
    present = union > 0
    if not present.any():
        return 1.0
    return float((tp[present] / union[present]).mean())


def miou(pred: np.ndarray, target: np.ndarray, n_classes: int) -> float:
    return miou_from_confusion(confusion(pred, target, n_classes))
