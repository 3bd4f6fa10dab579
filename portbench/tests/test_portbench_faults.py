"""The comparison that decides ``correct`` fails what it must: the control
(the reference at the precisions one step below the configuration's, in
the program's place) and a run whose timed path is broken underneath.
Each drives a tiny run on the CPU, past the run's look for a card."""

import pytest

from conftest import ROOT, tiny_cell
from portbench.harness.execute import execute
from portbench.harness.faults import FAULTS

#: BN-Inception on THUMOS14-like JPEG frames and handed over decoded, and
#: Inception-v3 (whose cell is not in the benchmark yet) on
#: ActivityNet-like ones
BNI = "ssn_bninception_rgb_thumos14"
CELLS = [(BNI, "score_thumos14_jpeg"), (BNI, "score_thumos14_decoded"),
         ("ssn_inceptionv3_rgb_anet12", "score_anet12_jpeg")]
#: Inception-v3 has no network at its stated precisions yet: its float32
#: comparison cannot tell half of the crops from int8's rounding (PERF.md)
BROKEN = [(name, fault) for name in CELLS for fault in FAULTS
          if not (fault == "half_crops" and name[0] != BNI)]


def _run(name, seed):
    return execute(ROOT, tiny_cell(*name), seed, 0.01, False, "cpu", 0.0)


@pytest.mark.parametrize("name", CELLS)
def test_a_sound_run_is_correct(name):
    result = _run(name, 3)
    assert result["attempted"] == 2
    assert result["correct"], result["checks"]


@pytest.mark.parametrize("name,fault", BROKEN)
def test_a_broken_timed_path_is_not_correct(name, fault, monkeypatch):
    FAULTS[fault](monkeypatch.setattr)
    result = _run(name, 3)
    assert not result["correct"], result["checks"]


@pytest.mark.parametrize("name", CELLS)
def test_the_control_is_not_correct(name, tmp_path):
    from portbench.harness.compare import control_gap
    from portbench.harness.score import ScoringJob

    cell = tiny_cell(*name)
    job = ScoringJob(cell.config, cell.traffic, 3, "cpu", str(tmp_path))
    run = job.window(0.01)
    job.close()
    gap = control_gap(job, run.calls[0].videos)
    assert gap > cell.config["limits"]["score_gap"]
