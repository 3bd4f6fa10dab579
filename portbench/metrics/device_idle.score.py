"""Device: the share of the traced window in which no operation ran on the
card, ``1 - busy / window``, in percent."""


def read(run):
    if not run.intervals:
        return None
    lo, hi = run.window_ns
    return 100.0 * (1.0 - run.busy_s / ((hi - lo) / 1e9))
