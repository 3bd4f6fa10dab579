"""Model step: device busy milliseconds (the union of every device
operation's interval in the traced window) per chunk scored."""


def read(run):
    if not run.intervals or not run.chunks:
        return None
    return run.busy_s * 1e3 / run.chunks
