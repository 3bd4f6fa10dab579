"""Model step (``infer/features.py`` -> ``models/backbones/*_int8.py``):
the share of the card's peaks that the scored ticks' model work takes of
the window, in percent. Each conv and head of the configuration's layer
table counts at its precision's dense peak (bf16 stem twice a tick, int8
trunk ten times, float32 heads once), whatever implements it; only real
ticks count, not padding."""

from portbench.harness.layers import peak_seconds_per_tick


def read(run):
    if not run.ticks:
        return None
    return 100.0 * run.ticks * peak_seconds_per_tick(run.config) \
        / run.window_s
