"""Host frames layer (``data/pipeline.py``, ``data/image.py``,
``csrc/jpeg_decode.cpp``): milliseconds spent inside the provider's
``load`` per sampled tick, summed over the decode threads (the traced
run's wrapping provider times each load). Near 0 where the frames come
decoded."""


def read(run):
    if not run.load_spans or not run.ticks:
        return None
    lo, hi = run.window_ns
    ns = sum(e - s for s, e in run.load_spans if s >= lo and e <= hi)
    return ns / 1e6 / run.ticks
