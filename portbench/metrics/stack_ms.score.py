"""Scorer (``infer/scorer.py:score_video_pack``): milliseconds a chunk
that the scoring thread spends building it on the host (``chunk.stack``:
``np.stack`` and the padding), from the program's spans."""

from portbench.harness.program_spans import ms_per_chunk


def read(run):
    return ms_per_chunk(run, "chunk.stack")
