"""Scorer (``infer/scorer.py:score_video_pack``): milliseconds a
``score_videos`` call spends after its last chunk (``pack.finish``: the
concat, each video's row gather, STPP pooling and the readback, the
device's drain included), from the program's spans."""

from portbench.harness.program_spans import ms_per_call


def read(run):
    return ms_per_call(run, "pack.finish")
