"""H2D copy (``infer/scorer.py``): the share of the chunks staged through
the scorers' rings of reused host buffers that needed no new buffer,
``100 * (1 - allocated / staged)`` of the window's scorers' own counters
(``scorer.staging``), in percent; nothing where the scorers keep no such
counters."""


def read(run):
    rings = [getattr(s, "staging", None) for s in run.scorers or ()]
    if not rings or any(r is None for r in rings):
        return None
    staged = sum(r.staged for r in rings)
    if not staged:
        return None
    return 100.0 * (1.0 - sum(r.allocated for r in rings) / staged)
