"""H2D copy (``infer/scorer.py:ProposalScorer._to_device``): milliseconds
a chunk that the scoring thread is blocked in the pageable copy
(``chunk.h2d``), its wait for the stream included, from the program's
spans. ``h2d_ms.score`` is the copy's device time."""

from portbench.harness.program_spans import ms_per_chunk


def read(run):
    return ms_per_chunk(run, "chunk.h2d")
