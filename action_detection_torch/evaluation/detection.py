"""Detection evaluation: score fusion -> detections -> NMS -> regression -> mAP.

A host copy of ``action_detection_tpu/evaluation/detection.py`` (numpy; the
per-class NMS runs in the C++ host library). The combined score is
``softmax(act)[:, 1:] * exp(comp)``; three filter modes (all-class / global
top-k / external-classifier top-k); per-class temporal NMS; boundary
regression in relative coordinates with clipping; AP fan-out over classes.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..ops.map_eval import map_sweep
from ..ops.metrics import softmax
from ..ops.nms import temporal_nms

ScoreTuple = Tuple[np.ndarray, np.ndarray, np.ndarray, Optional[np.ndarray]]


def merge_score_dicts(score_dicts: Sequence[Dict[str, ScoreTuple]],
                      weights: Optional[Sequence[float]] = None
                      ) -> Dict[str, ScoreTuple]:
    """Weighted multi-stream fusion of {vid: (rel_props, act, comp, reg)}."""
    if weights is None:
        weights = [1.0 / len(score_dicts)] * len(score_dicts)
    else:
        weights = list(np.asarray(weights, dtype=np.float64) / np.sum(weights))

    def merge_part(arrays, index):
        if arrays[0][index] is None:
            return None
        return np.sum([np.asarray(a[index]) * w for a, w in zip(arrays, weights)],
                      axis=0)

    out = {}
    for vid in score_dicts[0]:
        arrays = [sd[vid] for sd in score_dicts]
        out[vid] = (np.asarray(score_dicts[0][vid][0]),
                    merge_part(arrays, 1), merge_part(arrays, 2),
                    merge_part(arrays, 3))
    return out


def generate_detections(detection_scores: Dict[str, ScoreTuple], num_class: int,
                        top_k: int = 0, softmax_before_filter: bool = True,
                        cls_score_dict: Optional[Dict[str, np.ndarray]] = None,
                        cls_top_k: int = 1) -> List[Dict[str, np.ndarray]]:
    """Per-class {vid: (N, 5) [start, end, combined, loc, dur]} detections."""
    dataset_detections: List[Dict[str, np.ndarray]] = [dict() for _ in range(num_class)]

    for video_id, score_tp in detection_scores.items():
        rel_prop = np.asarray(score_tp[0])
        if rel_prop.ndim == 3:
            rel_prop = np.squeeze(rel_prop, 0)

        reg_scores = score_tp[3]
        if reg_scores is None:
            reg_scores = np.zeros((len(rel_prop), num_class, 2), dtype=np.float32)
        reg_scores = np.asarray(reg_scores).reshape(-1, num_class, 2)
        act = np.asarray(score_tp[1])
        comp = np.asarray(score_tp[2])

        if top_k <= 0 and cls_score_dict is None:
            combined = softmax(act)[:, 1:] * np.exp(comp)
            for i in range(num_class):
                dataset_detections[i][video_id] = np.concatenate((
                    rel_prop, combined[:, i][:, None],
                    reg_scores[:, i, 0][:, None], reg_scores[:, i, 1][:, None]),
                    axis=1)
        elif cls_score_dict is None:
            combined = softmax(act[:, 1:]) * np.exp(comp)
            keep_idx = np.argsort(combined.ravel())[-top_k:]
            for k in keep_idx:
                cls = k % num_class
                prop_idx = k // num_class
                row = np.array([[rel_prop[prop_idx, 0], rel_prop[prop_idx, 1],
                                 combined[prop_idx, cls],
                                 reg_scores[prop_idx, cls, 0],
                                 reg_scores[prop_idx, cls, 1]]])
                if video_id not in dataset_detections[cls]:
                    dataset_detections[cls][video_id] = row
                else:
                    dataset_detections[cls][video_id] = np.vstack(
                        [dataset_detections[cls][video_id], row])
        else:
            if softmax_before_filter:
                combined = softmax(act)[:, 1:] * np.exp(comp)
            else:
                combined = act[:, 1:] * np.exp(comp)
            # proposal-list video ids may be frame-directory paths; classifier
            # dict keys are bare names (reference eval_detection_results.py:135)
            key = os.path.splitext(os.path.basename(video_id))[0]
            video_cls_score = cls_score_dict.get(key, cls_score_dict.get(video_id))
            if video_cls_score is None:
                raise KeyError(f"no classifier scores for video '{video_id}'")
            for video_cls in np.argsort(video_cls_score)[-cls_top_k:]:
                dataset_detections[video_cls][video_id] = np.concatenate((
                    rel_prop, combined[:, video_cls][:, None],
                    reg_scores[:, video_cls, 0][:, None],
                    reg_scores[:, video_cls, 1][:, None]), axis=1)
    return dataset_detections


def apply_classwise_nms(dataset_detections: List[Dict[str, np.ndarray]],
                        nms_threshold: float) -> List[Dict[str, np.ndarray]]:
    return [{vid: temporal_nms(dets, nms_threshold)
             for vid, dets in cls_dets.items()}
            for cls_dets in dataset_detections]


def perform_regression(detections: np.ndarray) -> np.ndarray:
    """Apply (center shift, log duration) regression in relative coords."""
    t0, t1 = detections[:, 0], detections[:, 1]
    center, duration = (t0 + t1) / 2, (t1 - t0)
    new_center = center + duration * detections[:, 3]
    new_duration = duration * np.exp(detections[:, 4])
    return np.concatenate((
        np.clip(new_center - new_duration / 2, 0, 1)[:, None],
        np.clip(new_center + new_duration / 2, 0, 1)[:, None],
        detections[:, 2:]), axis=1)


def apply_regression(dataset_detections: List[Dict[str, np.ndarray]]
                     ) -> List[Dict[str, np.ndarray]]:
    return [{vid: perform_regression(dets) for vid, dets in cls_dets.items()}
            for cls_dets in dataset_detections]


def evaluate_detections(dataset_detections: List[Dict[str, np.ndarray]],
                        all_gt: Sequence, num_class: int,
                        iou_range: Sequence[float],
                        workers: int = 8) -> np.ndarray:
    """AP per (class, IoU). ``all_gt`` rows: (vid, cls0based, rel_s, rel_e)."""
    gt_by_cls = [[] for _ in range(num_class)]
    for vid, cls, s, e in all_gt:
        gt_by_cls[int(cls)].append((vid, float(s), float(e)))

    det_by_cls = []
    for cls in range(num_class):
        rows = []
        for vid, dets in dataset_detections[cls].items():
            rows.extend((vid, float(d[0]), float(d[1]), float(d[2]))
                        for d in np.asarray(dets))
        det_by_cls.append(rows)

    return map_sweep(gt_by_cls, det_by_cls, list(iou_range), workers=workers)


def format_map_table(iou_range: Sequence[float], ap_values: np.ndarray,
                     title: str = "Detection Performance") -> str:
    """Plain-text mAP@IoU table (the reference's AsciiTable report)."""
    map_iou = ap_values.mean(axis=0)
    header = ["IoU thresh"] + [f"{x:.02f}" for x in iou_range] + ["Average"]
    values = ["mean AP"] + [f"{x:.04f}" for x in map_iou] + [f"{map_iou.mean():.04f}"]
    w = max(len(c) for c in header + values) + 2
    line = "+" + "+".join("-" * w for _ in header) + "+"
    rows = ["|" + "|".join(c.center(w) for c in r) + "|" for r in (header, values)]
    return "\n".join([title, line, rows[0], line, rows[1], line])
