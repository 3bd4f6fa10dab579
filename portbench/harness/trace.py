"""What a traced run reads from the profiler: the device's operations as
intervals, their union (the busy time), the idle gaps between them, and
the breakdown the result line carries.

The profiler records device activity alone (``ProfilerActivity.CUDA``:
kernels, copies and sets), so tracing costs the host little; its events'
timestamps are nanoseconds on the wall clock (``time.time_ns``), which the
harness's own spans use too. The interval arithmetic is a copy of
``_device_intervals`` and ``_busy_us`` in the repository's
``chip_smoke.py``.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

Interval = Tuple[int, int, str]     # start ns, end ns, name


def device_intervals(prof) -> List[Interval]:
    """Every device-side event of a finished ``torch.profiler.profile``,
    read from the profiler's raw results (no tree is built)."""
    from torch.autograd import DeviceType

    out = []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA:
            start = e.start_ns()
            out.append((start, start + e.duration_ns(), e.name()))
    return out


def union(intervals: Sequence[Interval], lo: int = None,
          hi: int = None) -> List[Tuple[int, int]]:
    """The union of the intervals as sorted disjoint ``(start, end)``,
    clipped to ``[lo, hi]`` where given."""
    merged: List[List[int]] = []
    for a, b, _ in sorted(intervals):
        if lo is not None:
            a = max(a, lo)
        if hi is not None:
            b = min(b, hi)
        if b <= a:
            continue
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return [(a, b) for a, b in merged]


def busy_ns(intervals: Sequence[Interval], lo: int = None,
            hi: int = None) -> int:
    """Length of the union of the intervals within ``[lo, hi]``."""
    return sum(b - a for a, b in union(intervals, lo, hi))


def gaps(intervals: Sequence[Interval], lo: int, hi: int
         ) -> List[Tuple[int, int]]:
    """The idle stretches of ``[lo, hi]``: where no interval covers it."""
    out, at = [], lo
    for a, b in union(intervals, lo, hi):
        if a > at:
            out.append((at, a))
        at = max(at, b)
    if hi > at:
        out.append((at, hi))
    return out


def time_by_name(intervals: Sequence[Interval], match: str = None) -> dict:
    """Device seconds summed by operation name (those whose name holds
    ``match`` where given)."""
    out: dict = {}
    for a, b, name in intervals:
        if match is None or match in name:
            out[name] = out.get(name, 0.0) + (b - a) / 1e9
    return out


def label_gap(a: int, b: int, host_spans: dict) -> str:
    """What the host was doing in an idle gap ``[a, b)``: the names of the
    harness's spans that overlap it and how many, or nothing."""
    parts = []
    for name, spans in host_spans.items():
        n = sum(1 for s, e in spans if s < b and e > a)
        if n:
            parts.append(f"{name} x{n}")
    return ", ".join(parts) or "no harness span"


def breakdown(intervals: Sequence[Interval], lo: int, hi: int,
              host_spans: dict, top: int = 10) -> dict:
    """``{"device_ops": [[name, s]], "idle_gaps": [[label, s]]}``: the
    device operations that took most time in all, and the longest idle
    gaps of the window, each labelled by its offset into the window and
    the host spans that overlap it."""
    ops = sorted(time_by_name([i for i in intervals
                               if i[1] > lo and i[0] < hi]).items(),
                 key=lambda kv: -kv[1])[:top]
    idle = sorted(gaps(intervals, lo, hi), key=lambda g: g[0] - g[1])[:top]
    return {"device_ops": [[n[:120], s] for n, s in ops],
            "idle_gaps": [[f"at {(a - lo) / 1e9:.3f} s: "
                           + label_gap(a, b, host_spans), (b - a) / 1e9]
                          for a, b in idle]}
