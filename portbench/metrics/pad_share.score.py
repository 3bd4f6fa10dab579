"""Scorer layer (``infer/scorer.py``): the share of the ticks scored on the
device that are padding, ``1 - real_ticks / device_ticks`` of the window's
scorers' own counters, in percent."""


def read(run):
    if not run.scorers or not run.device_ticks:
        return None
    return 100.0 * (1.0 - run.real_ticks / run.device_ticks)
