"""One run of one cell, from set-up to the result line; ``run.py`` adds the
look for a card around it, and the CPU tests drive it without one.

Untraced, the metrics are the cell's end-to-end ones, from the host's
clock: ``setup_s`` (process start to the window's first call) and those
of the job (``Job.end_to_end``). Traced, they are the cell's per-layer ones, each read by its
own reader from the traced window (``registry.read_metrics``), with the
device's busy and window seconds and the breakdown. Either way the
comparison with the reference runs once the window has closed, the peak
memory has been read and the program's state is freed.
"""

from __future__ import annotations

import math
import shutil
import subprocess
import sys
import tempfile
import time

import torch

from . import trace as tr
from .registry import Cell, job_class, read_metrics


def card(device: torch.device) -> str:
    """The card's name and power limit, as ``nvidia-smi`` reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", f"--id={device.index or 0}",
             "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30)
        return out.stdout.strip() or out.stderr.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi did not run: {e!r}"


def execute(root: str, cell: Cell, seed: int, seconds: float, trace: bool,
            device, start: float) -> dict:
    """The result object of one run (``start``: ``perf_counter`` at the
    process's start). The key ``checks`` comes last: each number compared
    with its limit. The job is the one the cell's traffic mix names."""
    job_cls = job_class(root, cell.traffic["job"])
    device = torch.device(device)
    workdir = tempfile.mkdtemp(prefix="portbench-")
    try:
        job = job_cls(cell.config, cell.traffic, seed, device, workdir,
                      trace)
        setup_s = time.perf_counter() - start
        print("setup phases (s): " + ", ".join(
            f"{k} {v:.3f}" for k, v in job.phases.items())
            + f"; before the job {setup_s - sum(job.phases.values()):.3f}",
            file=sys.stderr, flush=True)
        run = job.window(seconds)
        peak = (torch.cuda.max_memory_allocated(device)
                if device.type == "cuda" else 0)
        dev = {"platform": "gpu" if device.type == "cuda" else device.type,
               "kind": (torch.cuda.get_device_name(device)
                        if device.type == "cuda" else "cpu"),
               "count": 1, "memory_peak_bytes": int(peak)}
        extra = {}
        if trace:
            metrics = read_metrics(root, cell.per_layer, run)
            lo, hi = run.window_ns
            dev["busy_s"] = run.busy_s
            dev["window_s"] = (hi - lo) / 1e9
            extra["breakdown"] = tr.breakdown(run.intervals, lo, hi,
                                              job.host_spans(run))
        else:
            measured = dict(job.end_to_end(run), setup_s=setup_s)
            metrics = {m["name"]: {"value": measured[m["name"]],
                                   "unit": m["unit"]}
                       for m in cell.end_to_end}
        job.close()
        t0 = time.perf_counter()
        checks = job.check(run)
        print(f"the comparison took {time.perf_counter() - t0:.3f} s",
              file=sys.stderr, flush=True)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    correct = all(c["limit"] is not None and math.isfinite(c["value"])
                  and c["value"] <= c["limit"]
                  for c in checks.values())
    out = {"correct": correct, "attempted": job.attempted(run),
           "failed": job.failed(run, checks), "metrics": metrics,
           "device": dev, **extra,
           "card": card(device) if device.type == "cuda" else "cpu",
           "checks": checks}
    return out


def print_result(result: dict) -> None:
    """The result as the last line of standard output, then each number
    compared beside its limit as the last lines of standard error."""
    import json

    print(json.dumps(result), flush=True)
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr, flush=True)
