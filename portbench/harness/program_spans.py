"""The program's own spans in a traced window, for the readers of the
``program_span`` metrics: those that ``action_detection_torch/utils/
meters.py`` records while the profiler runs (``score.build``,
``score.item``, ``frames.wait``, ``chunk.stack``, ``chunk.h2d``,
``chunk.launch``, ``pack.finish``), on the clock of the profiler's events
(``time.time_ns``). A program without that recorder, or a window in which
it recorded nothing, gives None, and the readers then report nothing.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

from . import trace as tr


def window_spans(run) -> Optional[list]:
    """Every span the program recorded within ``run.window_ns``, or None
    where it recorded none (untraced, or a program without spans)."""
    try:
        from action_detection_torch.utils.meters import spans_between
    except ImportError:
        return None
    return spans_between(*run.window_ns) or None


def spans_named(run, names: Sequence[str]) -> Optional[list]:
    """``(start_ns, end_ns)`` of the window's spans named one of
    ``names`` (maybe none), or None where the program recorded nothing."""
    spans = window_spans(run)
    if spans is None:
        return None
    return [(s.start_ns, s.end_ns) for s in spans if s.name in names]


def ms_per_chunk(run, name: str) -> Optional[float]:
    """Milliseconds in the span ``name`` per chunk the window's scorers
    scored on the device."""
    spans = spans_named(run, (name,))
    if spans is None or not run.scorers or not run.chunks:
        return None
    return sum(b - a for a, b in spans) / 1e6 / run.chunks


def ms_per_call(run, name: str) -> Optional[float]:
    """Milliseconds in the span ``name`` per ``score_videos`` call of the
    window."""
    spans = spans_named(run, (name,))
    if spans is None:
        return None
    return sum(b - a for a, b in spans) / 1e6 / len(run.calls)


def overlap_ns(xs: List[Tuple[int, int]], ys: List[Tuple[int, int]]) -> int:
    """Length of the intersection of two sorted lists of disjoint
    ``(start, end)`` intervals."""
    i = j = total = 0
    while i < len(xs) and j < len(ys):
        a = max(xs[i][0], ys[j][0])
        b = min(xs[i][1], ys[j][1])
        if b > a:
            total += b - a
        if xs[i][1] < ys[j][1]:
            i += 1
        else:
            j += 1
    return total


def idle_within_ns(run, names: Sequence[str]) -> Optional[int]:
    """Nanoseconds of the window in which the device was idle (no device
    interval covers it) while the host was inside one of the spans
    ``names`` (their union); None without device intervals or spans."""
    spans = spans_named(run, names)
    if not run.intervals or spans is None:
        return None
    lo, hi = run.window_ns
    held = tr.union([(a, b, "") for a, b in spans], lo, hi)
    return overlap_ns(tr.gaps(run.intervals, lo, hi), held)
