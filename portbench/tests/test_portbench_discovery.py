"""A configuration, a traffic mix, a job, a per-layer or end-to-end metric
and a cell added as new files and new ``BENCHMARK.json`` entries are found
by name, with no edit to a file that is there."""

import json
import os
import shutil

from conftest import ROOT
from portbench.harness.registry import load_cell, read_metrics


def _checkout(tmp_path):
    """A copy of the benchmark's files: ``BENCHMARK.json`` and the data
    folders of ``portbench``."""
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    for sub in ("configs", "traffic", "metrics"):
        shutil.copytree(os.path.join(ROOT, "portbench", sub),
                        tmp_path / "portbench" / sub)
    return tmp_path


def test_new_files_and_entries_are_found(tmp_path):
    root = _checkout(tmp_path)
    before = {p: open(p, "rb").read() for p in map(str, root.rglob("*"))
              if os.path.isfile(p)}
    with open(root / "BENCHMARK.json") as f:
        bench = json.load(f)

    cfg = json.load(open(root / "portbench/configs/"
                         "ssn_bninception_rgb_thumos14.json"))
    cfg.update(name="ssn_bninception_rgb_thumos14_k5", num_class=5)
    (root / "portbench/configs/new_cfg.json").write_text(json.dumps(cfg))
    mix = json.load(open(root / "portbench/traffic/"
                         "score_thumos14_decoded.json"))
    mix.update(name="score_short", lengths=[100, 200], proposals=[3, 4])
    (root / "portbench/traffic/score_short.json").write_text(json.dumps(mix))
    (root / "portbench/metrics/calls.score.py").write_text(
        "def read(run):\n    return len(run.calls)\n")
    (root / "portbench/metrics/nothing.score.py").write_text(
        "def read(run):\n    return None\n")

    bench["configs"].append({"name": cfg["name"], "source": "x",
                             "file": "portbench/configs/new_cfg.json",
                             "reduced": [], "why": "x"})
    bench["workloads"].append({"name": "k5.score_short",
                               "config": cfg["name"],
                               "traffic": "score_short", "chips": 1,
                               "why": "x"})
    for name in ("calls.score", "nothing.score"):
        bench["per_layer"].append({"name": name, "unit": "calls",
                                   "better": "higher",
                                   "source": "host_clock", "layer": "x",
                                   "moves": "score_ticks_per_s"})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))

    cell = load_cell(str(root), "k5.score_short")
    assert cell.config["num_class"] == 5
    assert cell.traffic["lengths"] == [100, 200]
    assert [m["name"] for m in cell.end_to_end] == ["score_ticks_per_s",
                                                    "setup_s"]
    names = [m["name"] for m in cell.per_layer]
    # metrics listed for other cells are not this cell's; the new ones,
    # with no list, are every cell's that reports what they move
    assert names == ["calls.score", "nothing.score"]

    class Run:
        calls = [1, 2, 3]

    got = read_metrics(str(root), cell.per_layer, Run())
    assert got == {"calls.score": {"value": 3.0, "unit": "calls"}}
    old = load_cell(str(root), "bni_thumos14.score_decoded")
    assert "calls.score" in [m["name"] for m in old.per_layer]
    assert "k1_roofline.score" in [m["name"] for m in old.per_layer]
    for path, data in before.items():
        if not path.endswith("BENCHMARK.json"):
            assert open(path, "rb").read() == data, path


JOB = '''
class Run:
    def __init__(self, items, seconds):
        self.items, self.seconds = items, seconds


class Job:
    def __init__(self, config, mix, seed, device, workdir, trace=False):
        self.mix, self.phases = mix, {"nothing": 0.0}

    def window(self, seconds):
        return Run(self.mix["items"], 2.0)

    def end_to_end(self, run):
        return {"items_per_s": run.items / run.seconds}

    def host_spans(self, run):
        return {}

    def close(self):
        pass

    def check(self, run):
        return {"items_lost": {"value": 0.0, "limit": 0.0}}

    def attempted(self, run):
        return run.items

    def failed(self, run, checks):
        return 0
'''


def test_a_new_job_and_its_metric_are_found(tmp_path):
    """A job of another kind (a training job's place) with an end-to-end
    metric of its own arrives as a job file, a mix naming it, a cell and
    the metric's entry; the run reports it."""
    from portbench.harness.execute import execute

    root = _checkout(tmp_path)
    (root / "portbench/jobs").mkdir()
    (root / "portbench/jobs/count.py").write_text(JOB)
    (root / "portbench/traffic/count_ten.json").write_text(json.dumps(
        {"name": "count_ten", "job": "count", "items": 10}))
    with open(root / "BENCHMARK.json") as f:
        bench = json.load(f)
    bench["workloads"].append({"name": "bni.count_ten",
                               "config": bench["configs"][0]["name"],
                               "traffic": "count_ten", "chips": 1,
                               "why": "x"})
    # the scoring rate, now that a cell does not report it, lists its cells
    for m in bench["end_to_end"]:
        if m["name"] == "score_ticks_per_s":
            m["workloads"] = ["bni_thumos14.score_decoded"]
    bench["end_to_end"].append({"name": "items_per_s", "unit": "items/s",
                                "better": "higher", "bound": 0.05,
                                "source": "host_clock",
                                "workloads": ["bni.count_ten"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))

    cell = load_cell(str(root), "bni.count_ten")
    assert sorted(m["name"] for m in cell.end_to_end) == ["items_per_s",
                                                          "setup_s"]
    result = execute(str(root), cell, 1, 0.01, False, "cpu", 0.0)
    assert result["correct"] and result["attempted"] == 10
    assert result["metrics"]["items_per_s"] == {"value": 5.0,
                                                "unit": "items/s"}
    assert set(result["metrics"]) == {"items_per_s", "setup_s"}
    # the scoring cell does not report the new job's metric
    old = load_cell(str(root), "bni_thumos14.score_decoded")
    assert "items_per_s" not in [m["name"] for m in old.end_to_end]
