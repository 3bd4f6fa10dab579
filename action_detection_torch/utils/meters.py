"""Observability: meters, step timing, a device trace and host spans.

Port of ``action_detection_tpu/utils/meters.py``: ``AverageMeter`` and
``MeterBank`` give the reference's ``val (avg)`` print style.
:class:`StepTimer` times each train step on the device (CUDA events, read
once at the end; the host clock on the CPU), and :func:`device_trace`
writes a ``torch.profiler`` trace (``--trace_dir``).

Spans (:func:`span_begin`, :func:`span_end`, :func:`spans_between`) time
the host's work at the scoring path's layer boundaries: ``score.build``
and ``score.item`` (``infer/features.py:fan_out``), ``frames.wait``
(``data/pipeline.py:iter_windowed_decode``), ``chunk.stack`` (a chunk
built in its staging slot), ``chunk.h2d`` (its copy enqueued on the
staging ring's copy stream, a wait for the slot's last copy included),
``chunk.launch`` (the model step enqueued) (``infer/features.py``) and
``pack.finish`` (pooling and readback) (``infer/scorer.py``). They are recorded only while a torch
profiler is active in the process: a span site reads
``profiler._is_profiler_enabled`` (torch's own flag) and does nothing more
when it is False. Their clock is ``time.time_ns()``, the clock of the
profiler's events, so a span and the device activity it caused line up on
one time axis.
"""

from __future__ import annotations

import contextlib
import itertools
import os
import threading
import time
from typing import Dict, List, NamedTuple, Optional

from torch.autograd import profiler


class AverageMeter:
    """Tracks current value, running sum and average."""

    def __init__(self):
        self.reset()

    def reset(self) -> None:
        self.val = 0.0
        self.avg = 0.0
        self.sum = 0.0
        self.count = 0

    def update(self, val: float, n: int = 1) -> None:
        self.val = val
        self.sum += val * n
        self.count += n
        self.avg = self.sum / self.count

    def __format__(self, spec: str) -> str:
        return f"{self.val:{spec}} ({self.avg:{spec}})"


class MeterBank:
    """Named AverageMeters with one-line formatting."""

    def __init__(self):
        self._meters: Dict[str, AverageMeter] = {}

    def update(self, metrics: Dict[str, float], n: int = 1) -> None:
        for k, v in metrics.items():
            self._meters.setdefault(k, AverageMeter()).update(float(v), n)

    def __getitem__(self, name: str) -> AverageMeter:
        return self._meters.setdefault(name, AverageMeter())

    def line(self, keys=None, fmt: str = ".4f") -> str:
        keys = keys or list(self._meters)
        return " ".join(f"{k} {self._meters[k]:{fmt}}" for k in keys
                        if k in self._meters)


class StepTimer:
    """Device time of each step: a pair of CUDA events around it on a CUDA
    device (read in :meth:`ms`, after the run, so timing adds no
    synchronization), the host clock (after the step returns) elsewhere."""

    def __init__(self, device):
        import torch

        self.cuda = torch.device(device).type == "cuda"
        self._events: List[tuple] = []
        self._host: List[float] = []

    @contextlib.contextmanager
    def step(self):
        import torch

        if self.cuda:
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            yield
            b.record()
            self._events.append((a, b))
        else:
            t0 = time.perf_counter()
            yield
            self._host.append((time.perf_counter() - t0) * 1e3)

    def ms(self) -> List[float]:
        """Every step's milliseconds so far, in order."""
        if not self.cuda:
            return list(self._host)
        import torch

        torch.cuda.synchronize()
        return [a.elapsed_time(b) for a, b in self._events]


@contextlib.contextmanager
def device_trace(log_dir: Optional[str]):
    """``torch.profiler`` trace (CPU and CUDA activity) of the body, written
    as ``<log_dir>/trace.json`` (chrome trace format, for Perfetto or
    chrome://tracing) and a kernel table ``<log_dir>/kernels.txt``. A no-op
    when ``log_dir`` is falsy."""
    if not log_dir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
    sort = ("self_cuda_time_total" if torch.cuda.is_available()
            else "self_cpu_time_total")
    with open(os.path.join(log_dir, "kernels.txt"), "w") as f:
        f.write(prof.key_averages().table(sort_by=sort, row_limit=60))


class Span(NamedTuple):
    """One recorded span: ``parent`` is the ``id`` of the span that was
    open on the same thread when it began, ``item`` the index of the
    fan-out's work item it served (None outside one)."""
    name: str
    start_ns: int
    end_ns: int
    thread: int
    parent: Optional[int]
    item: Optional[int]
    id: int


#: every span recorded in the process, in the order they ended, as the
#: plain tuples of :class:`Span`'s fields (cheaper to make)
_SPANS: List[tuple] = []
_ids = itertools.count()


class _OpenSpans(threading.local):
    def __init__(self):
        self.stack: List[tuple] = []


_open = _OpenSpans()


def span_begin(name: str, item: Optional[int] = None) -> tuple:
    """Open the span ``name`` on this thread; its work item is ``item``, or
    else its parent's. Call it only where ``profiler._is_profiler_enabled``
    holds, and hand what it returns to :func:`span_end`::

        sp = profiler._is_profiler_enabled and span_begin("chunk.h2d")
        ...
        if sp:
            span_end(sp)
    """
    stack = _open.stack
    parent = stack[-1] if stack else None
    if item is None and parent is not None:
        item = parent[3]
    sp = (name, next(_ids), parent[1] if parent else None, item,
          time.time_ns())
    stack.append(sp)
    return sp


def span_end(sp: tuple) -> None:
    """Close ``sp`` (and any span opened inside it that an exception left
    open) and record it."""
    end = time.time_ns()
    stack = _open.stack
    while stack and stack.pop() is not sp:
        pass
    name, sid, parent, item, start = sp
    _SPANS.append((name, start, end, threading.get_ident(), parent, item,
                   sid))


def spans_between(lo_ns: int, hi_ns: int) -> List[Span]:
    """The recorded spans that lie within ``[lo_ns, hi_ns]`` (nanoseconds
    of ``time.time_ns()``)."""
    return [Span._make(s) for s in list(_SPANS)
            if s[1] >= lo_ns and s[2] <= hi_ns]
