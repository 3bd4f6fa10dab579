"""Host frames (``data/pipeline.py:iter_windowed_decode``): milliseconds
a chunk that the scoring thread waits for frames not decoded yet
(``frames.wait``), from the program's spans."""

from portbench.harness.program_spans import ms_per_chunk


def read(run):
    return ms_per_chunk(run, "frames.wait")
