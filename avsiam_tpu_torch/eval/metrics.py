"""Evaluation metrics of the port: classification statistics and the loop's
meters.

Counterpart of ``avsiam_tpu/eval/metrics.py`` (``d_prime``,
``calculate_stats``, ``mean_ap``, ``mean_auc``, ``AverageMeter``;
src/utilities/stats.py). The JAX package calls scikit-learn; the port
computes the same numbers in numpy and scipy, which the card's host has,
as scikit-learn 1.9 does:

- ``binary_curve``: the scores sorted descending (stable), one threshold
  per distinct score, the true and false positives at each in float64;
- ``precision_recall_curve``: precision tps / (tps + fps) (0 where both
  are 0) and recall tps / tps[-1] (1 everywhere without positives),
  reversed, with the point (recall 0, precision 1) appended;
- ``average_precision``: the step-wise sum -Σ Δrecall · precision, tied
  scores one step, clipped at 0;
- ``roc_curve``: collinear points dropped (a point is kept where the
  second difference of fps or tps is nonzero, and at both ends), (0, 0)
  prepended; ``roc_auc`` its trapezoidal area.

Column k of the targets must be binary (0/1). A column with one class
gives ``auc``, the curves' fields -1, as the JAX package's fallback does.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
from scipy import stats as _scipy_stats
from scipy.integrate import trapezoid


def d_prime(auc: float) -> float:
    """src/utilities/stats.py:6-9."""
    return _scipy_stats.norm().ppf(auc) * np.sqrt(2.0)


def _binary(y_true) -> np.ndarray:
    y = np.asarray(y_true).ravel()
    if not np.isin(np.unique(y), (0, 1)).all():
        raise ValueError("the targets of a class must be 0 or 1")
    return y == 1


def binary_curve(y_true, y_score) -> Tuple[np.ndarray, np.ndarray,
                                           np.ndarray]:
    """(fps, tps, thresholds) at each distinct score, in decreasing score
    order (scikit-learn's ``confusion_matrix_at_thresholds``)."""
    pos = _binary(y_true)
    score = np.asarray(y_score).ravel()
    if not np.isfinite(score).all():
        raise ValueError("scores must be finite")
    order = np.argsort(-score, kind="stable")
    score, pos = score[order], pos[order].astype(np.float64)
    idx = np.concatenate([np.nonzero(np.diff(score))[0], [pos.size - 1]])
    tps = np.cumsum(pos, dtype=np.float64)[idx]
    fps = 1 + idx.astype(np.float64) - tps
    return fps, tps, score[idx]


def precision_recall_curve(y_true, y_score):
    """(precision, recall, thresholds), recall decreasing."""
    fps, tps, thresholds = binary_curve(y_true, y_score)
    ps = tps + fps
    precision = np.where(ps != 0, tps / np.where(ps != 0, ps, 1), 0.0)
    recall = np.ones_like(tps) if tps[-1] == 0 else tps / tps[-1]
    return (np.concatenate([precision[::-1], [1.0]]),
            np.concatenate([recall[::-1], [0.0]]), thresholds[::-1])


def average_precision(y_true, y_score) -> float:
    precision, recall, _ = precision_recall_curve(y_true, y_score)
    return float(max(0.0, -np.sum(np.diff(recall) * precision[:-1])))


def roc_curve(y_true, y_score):
    """(fpr, tpr, thresholds) with collinear points dropped and (0, 0)
    first; NaN rates where a class is absent."""
    fps, tps, thresholds = binary_curve(y_true, y_score)
    if fps.size > 2:
        keep = np.concatenate([[True], np.logical_or(np.diff(fps, 2),
                                                     np.diff(tps, 2)), [True]])
        fps, tps, thresholds = fps[keep], tps[keep], thresholds[keep]
    tps = np.concatenate([[0.0], tps])
    fps = np.concatenate([[0.0], fps])
    thresholds = np.concatenate([[np.inf], thresholds.astype(np.float64)])
    fpr = np.full(fps.shape, np.nan) if fps[-1] <= 0 else fps / fps[-1]
    tpr = np.full(tps.shape, np.nan) if tps[-1] <= 0 else tps / tps[-1]
    return fpr, tpr, thresholds


def roc_auc(y_true, y_score) -> float:
    """The area under the ROC curve; NaN with one class."""
    if np.unique(np.asarray(y_true)).size != 2:
        return float("nan")
    fpr, tpr, _ = roc_curve(y_true, y_score)
    return float(trapezoid(tpr, fpr))


def accuracy(target_ids, output_ids) -> float:
    return float(np.mean(np.asarray(target_ids) == np.asarray(output_ids)))


def calculate_stats(output: np.ndarray, target: np.ndarray,
                    sample_curves_every: int = 1000) -> List[Dict]:
    """Per-class statistics (src/utilities/stats.py:11-69): for each class
    its AP, ROC AUC, the precision, recall, false positive and false
    negative rate curves sampled every ``sample_curves_every`` points, and
    the argmax accuracy over all classes. output, target: [N, classes]."""
    acc = accuracy(np.argmax(target, 1), np.argmax(output, 1))
    out = []
    s = sample_curves_every
    for k in range(target.shape[-1]):
        ap = average_precision(target[:, k], output[:, k])
        auc = roc_auc(target[:, k], output[:, k])
        if np.isnan(auc):  # one class: the reference's fallback
            out.append({"precisions": -1, "recalls": -1, "AP": ap,
                        "fpr": -1, "fnr": -1, "auc": -1, "acc": acc})
            continue
        precisions, recalls, _ = precision_recall_curve(target[:, k],
                                                        output[:, k])
        fpr, tpr, _ = roc_curve(target[:, k], output[:, k])
        out.append({"precisions": precisions[0::s], "recalls": recalls[0::s],
                    "AP": ap, "fpr": fpr[0::s], "fnr": 1.0 - tpr[0::s],
                    "auc": auc, "acc": acc})
    return out


def mean_ap(stats: List[Dict]) -> float:
    return float(np.mean([s["AP"] for s in stats]))


def mean_auc(stats: List[Dict]) -> float:
    return float(np.mean([s["auc"] for s in stats]))


class AverageMeter:
    """Parity: src/utilities/util.py AverageMeter (val/avg/sum/count)."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.val = 0.0
        self.avg = 0.0
        self.sum = 0.0
        self.count = 0

    def update(self, val, n: int = 1):
        self.val = val
        self.sum += val * n
        self.count += n
        self.avg = self.sum / self.count
