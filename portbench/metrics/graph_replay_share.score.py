"""Model step (``infer/scorer.py:ProposalScorer._score_chunk``): the share
of the chunks the window's scorers scored on the device whose model step
ran as a replay of a captured CUDA graph, ``100 * replays / (device_ticks
/ chunk_ticks)`` of the scorers' own counters (``scorer.graph_replays``),
in percent; nothing where the scorers keep no such counter."""


def read(run):
    scorers = run.scorers or ()
    if not scorers or any(not hasattr(s, "graph_replays") for s in scorers):
        return None
    if not run.chunks:
        return None
    return 100.0 * sum(s.graph_replays for s in scorers) / run.chunks
