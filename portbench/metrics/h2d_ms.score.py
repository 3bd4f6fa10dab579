"""H2D copy (``infer/scorer.py``): device milliseconds of host-to-device
copies per chunk scored, from the profiler's ``Memcpy HtoD`` events."""


def read(run):
    if not run.intervals or not run.chunks:
        return None
    lo, hi = run.window_ns
    ns = sum(b - a for a, b, name in run.intervals
             if name.startswith("Memcpy HtoD") and a >= lo and b <= hi)
    return ns / 1e6 / run.chunks if ns else None
