"""Temporal Actionness Grouping (TAG) and sliding-window proposal generation
(host).

A host copy of ``action_detection_tpu/ops/tag.py``. Frames are labeled
foreground by thresholding smoothed actionness probabilities; candidate
boxes then grow from each up-transition until the fraction of background
frames exceeds a tolerance. The box search runs in the C++ host library
(``utils/native.py:tag_box_search``) always; :func:`tag_box_search_plain`
is its numpy body, the plain version the tests hold it against. The
backward scan's fallback score includes one extra frame, as the reference's
search does (``sequence_funcs.py:134``).
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

from ..utils.native import tag_box_search
from .metrics import softmax


def gaussian_smooth(x: np.ndarray, bw: float) -> np.ndarray:
    """1-D gaussian filtering matching ``scipy.ndimage.gaussian_filter`` defaults."""
    from scipy.ndimage import gaussian_filter

    return gaussian_filter(x, bw)


def label_frame_by_threshold(score_mat: np.ndarray, cls_lst: Sequence[int],
                             bw=None, thresh=(0.05,), multicrop: bool = True):
    """Threshold per-frame foreground probabilities into binary frame labels.

    Args:
      score_mat: ``(frames, crops, C)`` if multicrop else ``(frames, C)`` raw scores.
      cls_lst: foreground class indices (the fg column used is ``cls + 1``).
      bw: optional gaussian smoothing bandwidth applied to the probabilities.
      thresh: list of thresholds; one labeling per (class, threshold) pair.

    Returns:
      ``[(cls, bool_labels, fg_raw_scores), ...]``.
    """
    f_score = score_mat.mean(axis=1) if multicrop else score_mat
    probs = softmax(f_score)

    out = []
    for cls in cls_lst:
        cls_score = probs[:, cls + 1] if bw is None else gaussian_smooth(probs[:, cls + 1], bw)
        for th in thresh:
            out.append((cls, cls_score > th, f_score[:, cls + 1]))
    return out


def build_box_by_search(frm_label_lst, tol: np.ndarray, min_len: int = 1):
    """Grow candidate boxes from labeled frame runs under background tolerances.

    For each tolerance ``t`` the search scans start transitions forward and end
    transitions backward using the signal ``cumsum(1-labels) - t*arange`` — a
    box closes when extending it would admit more than a ``t`` fraction of
    background frames.

    Returns ``[(start, end, cls, score), ...]`` where score is the sum of raw
    fg scores over the box.
    """
    boxes: List[Tuple[int, int, int, float]] = []
    tol = np.asarray(tol, dtype=np.float64)
    for cls, frm_labels, frm_scores in frm_label_lst:
        labels = np.asarray(frm_labels).astype(np.int64)
        length = len(labels)
        diff = np.zeros(length + 1, dtype=np.int64)
        diff[1:-1] = labels[1:] - labels[:-1]
        diff[0] = labels[0]
        diff[length] = -labels[-1]

        up = np.nonzero(diff == 1)[0]
        down = np.nonzero(diff == -1)[0]
        assert len(up) == len(down), f"{len(up)} != {len(down)}"
        if len(up) == 0:
            continue
        boxes.extend((int(s), int(e), cls, float(sc)) for s, e, sc in
                     tag_box_search(labels, frm_scores, up, down, tol))
    return boxes


def tag_box_search_plain(labels, scores, up, down, tol) -> np.ndarray:
    """:func:`~..utils.native.tag_box_search` in numpy: the plain version.
    Returns ``(rows, 3)`` float64 ``[start, end, score]``."""
    labels = np.asarray(labels, dtype=np.int64)
    scores = np.asarray(scores, dtype=np.float64)
    length = len(labels)
    cs = np.cumsum(1 - labels).astype(np.float64)
    score_prefix = np.concatenate([[0.0], np.cumsum(scores)])

    def span_score(a: int, b: int) -> float:
        return float(score_prefix[min(b, length)] - score_prefix[a])

    rows = []
    for t in np.asarray(tol, dtype=np.float64):
        signal = cs - t * np.arange(length, dtype=np.float64)
        # forward: from each start, close at the first later start whose
        # signal exceeds ours (too much background in between)
        for x in range(len(up)):
            s = signal[up[x]]
            for y in range(x + 1, len(up)):
                if signal[up[y]] > s:
                    rows.append((up[x], down[y - 1] + 1,
                                 span_score(up[x], down[y - 1] + 1)))
                    break
            else:
                rows.append((up[x], down[-1] + 1,
                             span_score(up[x], down[-1] + 1)))
        # backward: from each end, open at the last earlier end whose
        # signal falls below ours
        for x in range(len(down) - 1, -1, -1):
            s = signal[down[x]] if down[x] < length else signal[-1] - t
            for y in range(x - 1, -1, -1):
                if signal[down[y]] < s:
                    rows.append((up[y + 1], down[x] + 1,
                                 span_score(up[y + 1], down[x] + 1)))
                    break
            else:
                rows.append((up[0], down[x] + 1,
                             span_score(0, down[x] + 1 + 1)))
    return np.asarray(rows, dtype=np.float64).reshape(-1, 3)


def gen_exponential_sw_proposal(video_duration: float, time_step: float = 1,
                                max_level: int = 8, overlap: float = 0.4):
    """Multi-scale sliding windows with spans ``2^0..2^(max_level-1)`` seconds.

    Windows keeping less than one second inside the video are dropped.
    """
    spans = [2 ** x for x in range(max_level)]
    pr = []
    for t_span in spans:
        span = t_span * time_step
        step = int(np.ceil(span * (1 - overlap)))
        pr.extend((float(i), float(i + t_span))
                  for i in np.arange(0, video_duration, step))

    def valid(span):
        return min(video_duration, span[1]) - span[0] >= 1

    return [p for p in pr if valid(p)]
