"""Scoring entry (``infer/features.py:fan_out``): milliseconds a
``score_videos`` call spends building its scorers (``score.build``: the
fused heads, the int8 tree copied to the card), from the program's spans."""

from portbench.harness.program_spans import ms_per_call


def read(run):
    return ms_per_call(run, "score.build")
