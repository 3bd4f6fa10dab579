"""Temporal interval overlap metrics (host numpy).

A verbatim host copy of ``action_detection_tpu/ops/iou.py``: the port cannot
import the reference's ``ops`` package, whose ``__init__`` pulls in jax.
Everything here is vectorized numpy working on ``(N, 2)`` interval arrays.
"""

from __future__ import annotations

import numpy as np


def temporal_iou(span_a, span_b) -> float:
    """IoU of two 1-D intervals ``(start, end)``; 0 when they do not overlap."""
    inter_left = max(span_a[0], span_b[0])
    inter_right = min(span_a[1], span_b[1])
    if inter_left >= inter_right:
        return 0.0
    union_left = min(span_a[0], span_b[0])
    union_right = max(span_a[1], span_b[1])
    return float(inter_right - inter_left) / float(union_right - union_left)


def overlap_over_b(span_a, span_b) -> float:
    """Length of the intersection divided by the length of ``span_b``."""
    inter_left = max(span_a[0], span_b[0])
    inter_right = min(span_a[1], span_b[1])
    if inter_left >= inter_right:
        return 0.0
    return float(inter_right - inter_left) / float(span_b[1] - span_b[0])


def temporal_iou_matrix(spans_a: np.ndarray, spans_b: np.ndarray) -> np.ndarray:
    """Pairwise IoU matrix between two interval sets.

    Args:
      spans_a: ``(N, 2)`` float array of (start, end).
      spans_b: ``(M, 2)`` float array of (start, end).

    Returns:
      ``(N, M)`` float array; entries are 0 where intervals are disjoint.
    """
    spans_a = np.asarray(spans_a, dtype=np.float64).reshape(-1, 2)
    spans_b = np.asarray(spans_b, dtype=np.float64).reshape(-1, 2)
    a0, a1 = spans_a[:, 0, None], spans_a[:, 1, None]
    b0, b1 = spans_b[None, :, 0], spans_b[None, :, 1]
    inter = np.minimum(a1, b1) - np.maximum(a0, b0)
    union = np.maximum(a1, b1) - np.minimum(a0, b0)
    iou = np.where(inter > 0, inter / union, 0.0)
    return iou


def overlap_over_b_matrix(spans_a: np.ndarray, spans_b: np.ndarray) -> np.ndarray:
    """Pairwise intersection-over-|b| matrix, ``(N, M)``."""
    spans_a = np.asarray(spans_a, dtype=np.float64).reshape(-1, 2)
    spans_b = np.asarray(spans_b, dtype=np.float64).reshape(-1, 2)
    a0, a1 = spans_a[:, 0, None], spans_a[:, 1, None]
    b0, b1 = spans_b[None, :, 0], spans_b[None, :, 1]
    inter = np.minimum(a1, b1) - np.maximum(a0, b0)
    blen = b1 - b0
    return np.where(inter > 0, inter / blen, 0.0)


def temporal_recall(gt_spans, est_spans, thresh: float = 0.5):
    """(hit, total) of ground-truth spans covered by any estimate at IoU>thresh."""
    gt = np.asarray(gt_spans, dtype=np.float64).reshape(-1, 2)
    if len(est_spans) == 0 or len(gt) == 0:
        return 0, len(gt)
    iou = temporal_iou_matrix(gt, np.asarray(est_spans, dtype=np.float64))
    hits = (iou > thresh).any(axis=1)
    return int(hits.sum()), len(gt)


def get_temporal_proposal_recall(pr_list, gt_list, thresh: float):
    """Dataset-level recall: per-video (all GT hit) and per-instance fractions."""
    infos = [temporal_recall(gt, pr, thresh=thresh) for pr, gt in zip(pr_list, gt_list)]
    per_video = float(np.sum([hit == total for hit, total in infos])) / max(len(infos), 1)
    total_inst = float(np.sum([total for _, total in infos]))
    per_inst = float(np.sum([hit for hit, _ in infos])) / max(total_inst, 1.0)
    return per_video, per_inst


def name_proposal(gt_spans, est_spans, thresh: float = 0.0):
    """Assign each estimated span the label of its best-overlapping GT span.

    Args:
      gt_spans: ``[(label, (start, end)), ...]``.
      est_spans: ``[(start, end), ...]``.

    Returns:
      ``[(label+1 or 0, best_iou, overlap_self, start, end), ...]`` with one
      entry per estimate (labels are shifted by +1; 0 means background).
    """
    out = []
    if len(gt_spans) == 0:
        return [(0, 0.0, 0.0, es[0], es[1]) for es in est_spans]
    gt_arr = np.asarray([g[1] for g in gt_spans], dtype=np.float64)
    gt_labels = [g[0] for g in gt_spans]
    est_arr = np.asarray([(e[0], e[1]) for e in est_spans], dtype=np.float64)
    if len(est_arr) == 0:
        return out
    iou = temporal_iou_matrix(est_arr, gt_arr)           # (N, M)
    ov_self = overlap_over_b_matrix(gt_arr, est_arr).T   # (N, M): inter / |est|
    best = iou.argmax(axis=1)
    for i, es in enumerate(est_spans):
        j = best[i]
        if iou[i, j] > thresh and iou[i, j] > 0:
            out.append((gt_labels[j] + 1, float(iou[i, j]), float(ov_self[i, j]),
                        es[0], es[1]))
        else:
            out.append((0, 0.0, 0.0, es[0], es[1]))
    return out
