"""Video-level score aggregation and stream fusion (host numpy).

A host copy of ``action_detection_tpu/ops/aggregation.py``.
"""

from __future__ import annotations

import numpy as np

from .metrics import softmax


def default_aggregation_func(score_arr: np.ndarray, normalization: bool = True,
                             crop_agg=None) -> np.ndarray:
    """Mean over crops then frames of a ``(frame, crop, class)`` score array."""
    crop_agg = np.mean if crop_agg is None else crop_agg
    agg = crop_agg(score_arr, axis=1).mean(axis=0)
    return softmax(agg) if normalization else agg


def top_k_aggregation_func(score_arr: np.ndarray, k: int, normalization: bool = True,
                           crop_agg=None) -> np.ndarray:
    """Mean of the top-k per-class frame scores (after crop aggregation)."""
    crop_agg = np.mean if crop_agg is None else crop_agg
    agg = np.sort(crop_agg(score_arr, axis=1), axis=0)[-k:, :].mean(axis=0)
    return softmax(agg) if normalization else agg


def sliding_window_aggregation_func(score: np.ndarray, spans=(1, 2, 4, 8, 16),
                                    overlap: float = 0.2, norm: bool = True,
                                    fps: int = 1) -> np.ndarray:
    """Multi-scale sliding-window max pooling followed by top-k averaging."""
    frm_max = score.mean(axis=1)
    slide_score = []

    def top_k_pool(scores, k):
        return np.sort(scores, axis=0)[-k:, :].mean(axis=0)

    for t_span in spans:
        span = t_span * fps
        step = int(np.ceil(span * (1 - overlap)))
        local_agg = [frm_max[i: i + span].max(axis=0)
                     for i in range(0, frm_max.shape[0], step)]
        k = max(15, len(local_agg) // 4)
        slide_score.append(top_k_pool(np.array(local_agg), k))

    out_score = np.mean(slide_score, axis=0)
    return softmax(out_score) if norm else out_score


def tpp_aggregation_func(score: np.ndarray, num_class: int) -> np.ndarray:
    """Temporal-position-aware pooling: frame t votes with the class block of
    its pyramid stage (reference video_funcs.py:62-72, py3-fixed)."""
    crop_avg = score.mean(axis=1)
    stage = crop_avg.shape[1] // num_class
    length = score.shape[0]
    step = float(stage) / length
    out = np.zeros(num_class)
    for t in range(length):
        k = int(t * step)
        out += crop_avg[t, k * num_class: (k + 1) * num_class]
    return out / length


def default_fusion_func(major_score: np.ndarray, other_scores, fusion_weights,
                        norm: bool = True) -> np.ndarray:
    """Weighted sum fusion of multiple streams' scores."""
    assert len(other_scores) == len(fusion_weights)
    out_score = major_score
    for s, w in zip(other_scores, fusion_weights):
        out_score = out_score + s * w
    return softmax(out_score) if norm else out_score
