"""Classification metrics and score utilities (host numpy).

A host copy of ``action_detection_tpu/ops/metrics.py``. The two metrics
that the JAX package takes from scikit-learn (``video_mean_ap``,
``mean_class_accuracy``) are written out in numpy here: the machines the
port runs on have no scikit-learn. They follow sklearn's
``average_precision_score(average="macro")`` and ``confusion_matrix``
step for step (``tests/test_torch_port_eval.py`` holds them against it).
"""

from __future__ import annotations

import numpy as np


def softmax(raw_score: np.ndarray, T: float = 1.0) -> np.ndarray:
    """Numerically-stable softmax over the last axis with temperature ``T``."""
    raw_score = np.asarray(raw_score)
    exp_s = np.exp((raw_score - raw_score.max(axis=-1)[..., None]) * T)
    return exp_s / exp_s.sum(axis=-1)[..., None]


def top_k_hit(label_set, scores: np.ndarray, k: int = 3):
    """Whether any ground-truth label is in the top-k predictions."""
    idx = np.argsort(scores)[-k:]
    return len(label_set.intersection(idx)) > 0, 1


def top_k_accuracy(score_dict, video_list, k: int) -> float:
    """Video-level top-k accuracy over a DB video list."""
    video_labels = [set(i.num_label for i in v.instances) for v in video_list]
    hits = np.array([top_k_hit(lb, score_dict[v.id], k=k)
                     for v, lb in zip(video_list, video_labels) if v.id in score_dict])
    totals = hits.sum(axis=0).astype(float)
    return totals[0] / totals[1]


def binary_average_precision(y_true: np.ndarray, y_score: np.ndarray) -> float:
    """Uninterpolated AP of one class: ``sum_n (R_n - R_{n-1}) P_n`` over the
    distinct score thresholds, in decreasing order (sklearn's step
    integral; a class with no positive scores 0)."""
    y_true = np.asarray(y_true, dtype=np.float64)
    y_score = np.asarray(y_score)
    order = np.argsort(y_score, kind="stable")[::-1]
    y_score, y_true = y_score[order], y_true[order]
    distinct = np.where(np.diff(y_score))[0]
    threshold_idxs = np.concatenate([distinct, [y_true.size - 1]])
    tps = np.cumsum(y_true)[threshold_idxs]
    fps = 1 + threshold_idxs.astype(np.float64) - tps
    precision = tps / (tps + fps)
    recall = (np.ones_like(tps) if tps[-1] == 0 else tps / tps[-1])
    precision = np.concatenate([precision[::-1], [1.0]])
    recall = np.concatenate([recall[::-1], [0.0]])
    return float(max(0.0, -np.sum(np.diff(recall) * precision[:-1])))


def video_mean_ap(score_dict, video_list) -> float:
    """Macro-averaged AP of video-level multi-label classification."""
    avail_labels = [set(i.num_label for i in v.instances)
                    for v in video_list if v.id in score_dict]
    pred = np.array([score_dict[v.id] for v in video_list if v.id in score_dict])
    gt = np.zeros(pred.shape)
    for i in range(pred.shape[0]):
        gt[i, list(avail_labels[i])] = 1
    return float(np.mean([binary_average_precision(gt[:, c], pred[:, c])
                          for c in range(pred.shape[1])]))


def mean_class_accuracy(scores: np.ndarray, labels: np.ndarray) -> float:
    """Mean of per-class accuracies (balanced accuracy) over the classes
    that occur in ``labels`` or in the predictions."""
    labels = np.asarray(labels)
    pred = np.argmax(scores, axis=1)
    classes = np.unique(np.concatenate([labels, pred]))
    cf = np.zeros((len(classes), len(classes)))
    np.add.at(cf, (np.searchsorted(classes, labels),
                   np.searchsorted(classes, pred)), 1)
    with np.errstate(invalid="ignore", divide="ignore"):
        return float(np.mean(np.diag(cf) / cf.sum(axis=1)))


def top_k_acc(lb_set, scores: np.ndarray, k: int = 3):
    """(hits, total) of ground-truth labels found in the top-k predictions."""
    idx = np.argsort(scores)[-k:]
    return len(lb_set.intersection(idx)), len(lb_set)
