"""The job of the traffic mixes whose ``job`` is ``score``: the port's
proposal scoring (``portbench/harness/score.py``)."""

from portbench.harness.score import ScoringJob as Job  # noqa: F401
