"""Training observability: meters, timers, step timing and a device trace.

Port of ``action_detection_tpu/utils/meters.py``: ``AverageMeter`` and
``MeterBank`` give the reference's ``val (avg)`` print style; ``Timer``
accumulates wall clock. :class:`StepTimer` times each train step on the
device (CUDA events, read once at the end; the host clock on the CPU), and
:func:`device_trace` writes a ``torch.profiler`` trace (``--trace_dir``).
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, List, Optional


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


class Timer:
    """Accumulating wall-clock timer usable as a context manager."""

    def __init__(self):
        self.total = 0.0
        self.count = 0
        self._t0: Optional[float] = None

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.total += time.perf_counter() - self._t0
        self.count += 1
        self._t0 = None

    @property
    def avg(self) -> float:
        return self.total / max(self.count, 1)


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
