"""Model step (``infer/scorer.py:ProposalScorer._score_chunk``):
milliseconds a chunk that the scoring thread spends enqueueing the model
step (``chunk.launch``), from the program's spans."""

from portbench.harness.program_spans import ms_per_chunk


def read(run):
    return ms_per_chunk(run, "chunk.launch")
