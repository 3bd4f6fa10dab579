"""The benchmark's CPU tests: run them from the root of the checkout with
``python -m pytest portbench/tests -q``. They need no card: where a test
drives a run, it skips the run's look for a card and runs the scoring job
on the CPU at a tiny size (the port's kernels run their plain versions
there)."""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

#: a tiny mix: two short videos a call of 4-tick chunks, short shots so
#: that a video's ticks read several fixtures
TINY_MIX = {"lengths": [31, 43], "proposals": [4, 6], "groups": 1,
            "sequences": 2, "shot_frames": [3, 7], "frames_seed": 9,
            "warmup_frames": 13,
            "compare_videos": 4}


def tiny_cell(config: str, traffic: str):
    """A cell of the configuration file ``config`` and the traffic mix
    ``traffic`` (by name, as ``BENCHMARK.json`` names them), cut to
    :data:`TINY_MIX` and 4-tick chunks."""
    import json

    from portbench.harness.registry import Cell

    with open(os.path.join(ROOT, "portbench", "configs",
                           config + ".json")) as f:
        cfg = json.load(f)
    with open(os.path.join(ROOT, "portbench", "traffic",
                           traffic + ".json")) as f:
        mix = json.load(f)
    cfg["chunk_ticks"] = 4
    mix.update(TINY_MIX)
    return Cell(f"{config}.{traffic}", 1, cfg, mix, [], [])
