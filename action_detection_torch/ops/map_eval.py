"""Detection mean average precision (ActivityNet-toolkit-compatible).

A host copy of ``action_detection_tpu/ops/map_eval.py`` (numpy; the AP
arrays are equal to the JAX package's, ``tests/test_torch_port_eval.py``):

* predictions are sorted by descending score,
* each prediction greedily matches the unmatched GT of the same video with the
  highest temporal IoU >= threshold (one match per GT),
* AP is computed with (ActivityNet-style) interpolated precision, normalized
  by the number of ground-truth instances.

The per-class sweep fans out on a thread pool (the work is numpy, which
releases the GIL).
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Sequence, Tuple

import numpy as np

from .iou import temporal_iou_matrix


def interpolated_prec_rec(prec: np.ndarray, rec: np.ndarray) -> float:
    """ActivityNet-style interpolated AP from precision/recall curves."""
    mprec = np.hstack([[0], prec, [0]])
    mrec = np.hstack([[0], rec, [1]])
    for i in range(len(mprec) - 1)[::-1]:
        mprec[i] = max(mprec[i], mprec[i + 1])
    idx = np.where(mrec[1:] != mrec[:-1])[0] + 1
    return float(np.sum((mrec[idx] - mrec[idx - 1]) * mprec[idx]))


def compute_average_precision_detection(
        ground_truth: Sequence[Tuple[str, float, float]],
        prediction: Sequence[Tuple[str, float, float, float]],
        tiou_thresholds: Sequence[float] = (0.5,)) -> np.ndarray:
    """AP of one class at each tIoU threshold.

    Args:
      ground_truth: ``(video_id, t_start, t_end)`` rows.
      prediction: ``(video_id, t_start, t_end, score)`` rows.
      tiou_thresholds: IoU thresholds to evaluate.

    Returns:
      ``(len(tiou_thresholds),)`` AP array.
    """
    tiou_thresholds = np.asarray(tiou_thresholds, dtype=np.float64)
    npos = len(ground_truth)
    ap = np.zeros(len(tiou_thresholds))
    if npos == 0 or len(prediction) == 0:
        return ap

    gt_by_vid: Dict[str, List[int]] = {}
    gt_spans = np.empty((npos, 2), dtype=np.float64)
    for i, (vid, ts, te) in enumerate(ground_truth):
        gt_by_vid.setdefault(vid, []).append(i)
        gt_spans[i] = (ts, te)

    pred = sorted(prediction, key=lambda x: -x[3])
    n_pred = len(pred)

    tp = np.zeros((len(tiou_thresholds), n_pred))
    fp = np.zeros((len(tiou_thresholds), n_pred))
    # per-threshold "this GT already matched" flags
    matched = np.zeros((len(tiou_thresholds), npos), dtype=bool)

    for pi, (vid, ts, te, _score) in enumerate(pred):
        gt_idx = gt_by_vid.get(vid)
        if not gt_idx:
            fp[:, pi] = 1
            continue
        ious = temporal_iou_matrix([[ts, te]], gt_spans[gt_idx])[0]
        order = np.argsort(-ious)
        for ti, thresh in enumerate(tiou_thresholds):
            hit = False
            for oj in order:
                if ious[oj] < thresh:
                    break
                gi = gt_idx[oj]
                if not matched[ti, gi]:
                    matched[ti, gi] = True
                    tp[ti, pi] = 1
                    hit = True
                    break
            if not hit:
                fp[ti, pi] = 1

    tp_cum = np.cumsum(tp, axis=1)
    fp_cum = np.cumsum(fp, axis=1)
    rec = tp_cum / npos
    prec = tp_cum / np.maximum(tp_cum + fp_cum, 1e-12)
    for ti in range(len(tiou_thresholds)):
        ap[ti] = interpolated_prec_rec(prec[ti], rec[ti])
    return ap


def map_sweep(gt_by_cls: Sequence, det_by_cls: Sequence,
              iou_range: Sequence[float], workers: int = 8) -> np.ndarray:
    """AP for every (class, IoU) pair; returns ``(num_class, len(iou_range))``.

    ``gt_by_cls[c]`` is a list of ``(vid, t_start, t_end)``; ``det_by_cls[c]``
    a list of ``(vid, t_start, t_end, score)``.
    """
    num_class = len(gt_by_cls)
    iou_range = list(iou_range)
    ap_values = np.zeros((num_class, len(iou_range)))

    def job(cls):
        return cls, compute_average_precision_detection(
            gt_by_cls[cls], det_by_cls[cls], iou_range)

    with ThreadPoolExecutor(max_workers=workers) as pool:
        for cls, aps in pool.map(job, range(num_class)):
            ap_values[cls, :] = aps
    return ap_values
