"""1-D (temporal) non-maximal suppression (host).

A host copy of ``action_detection_tpu/ops/nms.py``. The suppression runs in
the C++ host library (``utils/native.py:nms_indices``) always: the JAX
package falls back to numpy when its library is missing, the port raises
instead. :func:`temporal_nms_indices_plain` is that numpy body, kept as the
plain version the tests hold the library against.

``duration_offset`` selects the interval-length convention: 0.0 for
continuous spans (the evaluation path, relative coordinates), 1.0 for
inclusive frame indices (TAG proposal generation).
"""

from __future__ import annotations

import numpy as np

from ..utils.native import nms_indices


def temporal_nms_indices(starts: np.ndarray, ends: np.ndarray, scores: np.ndarray,
                         thresh: float, duration_offset: float = 0.0) -> np.ndarray:
    """Greedy temporal NMS; returns kept indices in descending-score order."""
    if len(scores) == 0:
        return np.empty((0,), dtype=np.int64)
    return nms_indices(starts, ends, scores, float(thresh),
                       float(duration_offset))


def temporal_nms_indices_plain(starts: np.ndarray, ends: np.ndarray,
                               scores: np.ndarray, thresh: float,
                               duration_offset: float = 0.0) -> np.ndarray:
    """:func:`temporal_nms_indices` in numpy: the plain version."""
    starts = np.asarray(starts, dtype=np.float64)
    ends = np.asarray(ends, dtype=np.float64)
    scores = np.asarray(scores, dtype=np.float64)
    if len(scores) == 0:
        return np.empty((0,), dtype=np.int64)
    durations = ends - starts + duration_offset
    # kind="stable": ties visit the larger original index first, identically
    # in numpy and in the C++ library
    order = scores.argsort(kind="stable")[::-1]
    keep = []
    while order.size > 0:
        i = order[0]
        keep.append(i)
        rest = order[1:]
        if rest.size == 0:
            break
        inter = (np.minimum(ends[i], ends[rest]) - np.maximum(starts[i], starts[rest])
                 + duration_offset)
        iou = inter / (durations[i] + durations[rest] - inter)
        order = rest[iou <= thresh]
    return np.asarray(keep, dtype=np.int64)


def temporal_nms(dets: np.ndarray, thresh: float, score_col: int = 2,
                 duration_offset: float = 0.0) -> np.ndarray:
    """NMS over a detection array with rows ``[start, end, ..., score at score_col, ...]``.

    Returns the kept rows (descending score), matching the row-filter behavior
    of the reference eval path.
    """
    dets = np.asarray(dets)
    if len(dets) == 0:
        return dets
    keep = temporal_nms_indices(dets[:, 0], dets[:, 1], dets[:, score_col], thresh,
                                duration_offset=duration_offset)
    return dets[keep, :]


def temporal_nms_tuples(bboxes, thresh: float, score_ind: int = 3):
    """NMS over ``[(start, end, cls, score), ...]`` tuple lists (TAG path),
    with the inclusive frame-index duration convention."""
    if len(bboxes) == 0:
        return []
    arr = np.asarray([[b[0], b[1], b[score_ind]] for b in bboxes], dtype=np.float64)
    keep = temporal_nms_indices(arr[:, 0], arr[:, 1], arr[:, 2], thresh,
                                duration_offset=1.0)
    return [bboxes[i] for i in keep]
