"""Device: milliseconds a chunk in which the card was idle while the
scoring thread was feeding it: the traced window's idle time (where no
device interval runs, as ``device_idle.score`` takes it) within the union
of the program's ``frames.wait``, ``chunk.stack``, ``chunk.h2d`` and
``chunk.launch`` spans. The rest of the idle time lies at the calls'
edges (scorer builds, ``pack.finish``, between work items)."""

from portbench.harness.program_spans import idle_within_ns

FEEDING = ("frames.wait", "chunk.stack", "chunk.h2d", "chunk.launch")


def read(run):
    ns = idle_within_ns(run, FEEDING)
    if ns is None or not run.scorers or not run.chunks:
        return None
    return ns / 1e6 / run.chunks
