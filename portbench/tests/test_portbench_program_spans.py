"""The readers of the program's spans (``harness/program_spans.py`` and
the ``program_span`` metrics) on made-up spans and device intervals,
worked out by hand; nothing without spans; and one traced run of the
scoring job on the CPU at a tiny size, in which every one of them reads
a number."""

import importlib.util
import os

import pytest

from conftest import ROOT, tiny_cell
from portbench.harness import program_spans as ps
from portbench.harness import trace as tr
from portbench.harness.score import Call, ScoreRun

from action_detection_torch.utils import meters
from action_detection_torch.utils.meters import Span

NEW = ("scorer_build_ms.score", "frames_wait_ms.score", "stack_ms.score",
       "h2d_block_ms.score", "launch_ms.score", "pack_finish_ms.score",
       "idle_feeding_ms.score")
MS = 10 ** 6


def _reader(name):
    path = os.path.join(ROOT, "portbench", "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(name.replace(".", "_"),
                                                  path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


class _Scorer:
    def __init__(self, device_ticks, real_ticks):
        self.device_ticks, self.real_ticks = device_ticks, real_ticks


def _span(name, a_ms, b_ms, item=0, parent=None):
    return Span(name, a_ms * MS, b_ms * MS, 1, parent, item, 0)


#: two calls over [0, 200] ms, two 64-tick chunks; the spans of the
#: first call, one build span outside the window
SPANS = [
    _span("score.build", 0, 10, None),
    _span("score.item", 10, 90),
    _span("frames.wait", 10, 12),
    _span("chunk.stack", 12, 15),
    _span("chunk.h2d", 15, 25),
    _span("chunk.launch", 25, 29),
    _span("frames.wait", 29, 30),
    _span("chunk.stack", 30, 33),
    _span("chunk.h2d", 33, 50),
    _span("chunk.launch", 50, 55),
    _span("pack.finish", 55, 90),
    _span("score.build", 100, 106, None),
    _span("score.build", 250, 260, None),
]
#: the device busy over [14, 20], [22, 40] and [45, 95] ms
INTERVALS = [(14 * MS, 20 * MS, "k"), (22 * MS, 40 * MS, "k"),
             (30 * MS, 35 * MS, "copy"), (45 * MS, 95 * MS, "k")]


def _run(intervals=INTERVALS):
    calls = [Call(["a"], 60, 0.0, 0.1, 0, 100 * MS, {}),
             Call(["b"], 40, 0.1, 0.2, 100 * MS, 200 * MS, {})]
    return ScoreRun({"chunk_ticks": 64}, calls, scorers=[_Scorer(128, 100)],
                    intervals=intervals)


def test_overlap_of_two_interval_lists():
    xs = [(0, 10), (20, 30), (40, 50)]
    ys = [(5, 25), (28, 45), (60, 70)]
    assert ps.overlap_ns(xs, ys) == 5 + 5 + 2 + 5
    assert ps.overlap_ns(xs, []) == 0
    assert ps.overlap_ns([(0, 100)], xs) == 30


def test_readers_by_hand(monkeypatch):
    monkeypatch.setattr(meters, "_SPANS", list(SPANS))
    run = _run()
    assert _reader("scorer_build_ms.score")(run) == pytest.approx(16 / 2)
    assert _reader("frames_wait_ms.score")(run) == pytest.approx(3 / 2)
    assert _reader("stack_ms.score")(run) == pytest.approx(6 / 2)
    assert _reader("h2d_block_ms.score")(run) == pytest.approx(27 / 2)
    assert _reader("launch_ms.score")(run) == pytest.approx(9 / 2)
    assert _reader("pack_finish_ms.score")(run) == pytest.approx(35 / 2)
    # feeding held [10, 55] ms; the device was idle there over [10, 14],
    # [20, 22] and [40, 45]
    assert _reader("idle_feeding_ms.score")(run) == pytest.approx(11 / 2)


def test_no_wait_reads_zero_where_other_spans_were_recorded(monkeypatch):
    monkeypatch.setattr(meters, "_SPANS", [s for s in SPANS
                                           if s.name != "frames.wait"])
    assert _reader("frames_wait_ms.score")(_run()) == 0.0


def test_new_readers_find_nothing_without_a_trace(monkeypatch):
    monkeypatch.setattr(meters, "_SPANS", list(SPANS))
    calls = [Call(["a"], 60, 0.0, 1.0, 10 ** 12, 2 * 10 ** 12, {})]
    run = ScoreRun({"chunk_ticks": 64}, calls,
                   scorers=[_Scorer(64, 60)], intervals=[])
    for name in NEW:
        assert _reader(name)(run) is None, name
    # spans but no device intervals: the device readers find nothing
    assert _reader("idle_feeding_ms.score")(_run([])) is None


def test_a_program_without_the_recorder_gives_nothing(monkeypatch):
    import sys

    monkeypatch.setitem(sys.modules, "action_detection_torch.utils.meters",
                        None)
    for name in NEW:
        assert _reader(name)(_run()) is None, name


def _cpu_intervals(prof):
    """The CPU run's operations in place of the card's (the CPU is the
    device there)."""
    from torch.autograd import DeviceType

    out = []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CPU:
            start = e.start_ns()
            out.append((start, start + e.duration_ns(), e.name()))
    return out


def test_a_traced_cpu_run_reads_every_new_metric(monkeypatch):
    import json

    from portbench.harness.execute import execute

    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        entries = {m["name"]: m for m in json.load(f)["per_layer"]}
    cell = tiny_cell("ssn_bninception_rgb_thumos14", "score_thumos14_decoded")
    cell.per_layer = [entries[n] for n in NEW]
    monkeypatch.setattr(tr, "device_intervals", _cpu_intervals)
    result = execute(ROOT, cell, 5, 0.01, True, "cpu", 0.0)
    assert result["correct"], result["checks"]
    assert sorted(result["metrics"]) == sorted(NEW)
    for name, m in result["metrics"].items():
        assert m["value"] >= 0.0, (name, m)
    for name in ("stack_ms.score", "h2d_block_ms.score", "launch_ms.score",
                 "pack_finish_ms.score", "scorer_build_ms.score"):
        assert result["metrics"][name]["value"] > 0.0, name
