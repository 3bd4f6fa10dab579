"""The reproduction recipes on the port
(``action_detection_torch/scripts/reproduce_{thumos14,anet12}.sh``)
against the JAX package's (``scripts/reproduce_*.sh``) on the CPU, each
script run as written with ``bash``:

* on a synthetic dataset (``tests/recipe_db.py``: normalized TAG lists in
  the working directory, frame directories linking to the committed JPEG
  frames) and a ``python`` shim first on ``PATH`` that appends the small
  sizes to each CLI (``--arch TinyConv --epochs 1 -b 2 --tem 1 --dropout
  0``, ``--frame_interval 30``; the port's ``--device cpu``, the JAX CLIs'
  one device) and reads the checkpoint each recipe names under
  BNInception under TinyConv's name: argparse takes a flag's last
  occurrence, so neither script gains a knob;
* ``$FLOW_INIT`` is a seeded reference-format ``.pth`` of a TinyConv RGB
  backbone, which both packages' ``--init_weights`` read (and convert to
  Flow's 10 input channels);
* each package seeds its own heads and backbone its own way, so the shim
  also starts each ``ssn_train`` from one seeded checkpoint at epoch 0
  (``--resume``, a flax msgpack both packages read: the port's SSN through
  ``jax_from_state_dict`` and its msgpack writer), as the training CLI
  parity tests do; the two packages then train the same model;
* held: the twin's steps are the JAX script's, CLI for CLI, with the same
  flags; both write equal proposal lists; the twin's ``.pt`` checkpoints
  score with the port (finite pickles of every test video); the fused
  mAP tables the two scripts print agree within 0.005 (``PERF.md`` §2's
  bound) at every IoU threshold.

The ActivityNet recipe (``slow``: each recipe pair takes ~75 s on the
CPU) is the same check on ActivityNet v1.2's lists
(100 classes, IoU 0.5:0.95, ``${KINETICS:+--kinetics_pretrain}`` unset;
its ground truth of three classes the start checkpoints favour, so that
its mAP is not 0 on both sides).
"""

import os
import pickle
import subprocess

import numpy as np
import pytest

from action_detection_torch.models import SSN, jax_from_state_dict, seeded_init
from action_detection_torch.train import flax_msgpack

from tests.recipe_db import (DATASETS, map_row, recipe_steps,
                             write_flow_init, write_python_shim,
                             write_recipe_db)
from tests.test_torch_port_int8 import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPTS = {"thumos14": "reproduce_thumos14.sh",
           "activitynet1.2": "reproduce_anet12.sh"}
#: the small sizes the shim appends: (side, cli) -> flags
TRAIN = ["--arch", "TinyConv", "--epochs", "1", "-b", "2", "--tem", "1",
         "--dropout", "0", "-j", "1", "--print-freq", "1"]
TEST = ["--arch", "TinyConv", "--frame_interval", "30", "--test_batchsize",
        "8"]
EXTRA = {("port", "ssn_train"): TRAIN + ["--device", "cpu"],
         ("port", "ssn_test"): TEST + ["--device", "cpu"],
         ("port", "eval_detection_results"): ["-j", "1"],
         ("jax", "ssn_train"): TRAIN + ["--gpus", "0"],
         ("jax", "ssn_test"): TEST + ["--devices", "0"],
         ("jax", "eval_detection_results"): ["-j", "1"]}
#: ActivityNet keeps the top 60 (proposal, class) pairs of a video's
#: 100 classes: its ground truth is of classes 1-3, which the start
#: checkpoints favour, so that its mAP is not 0 on both sides
FAVOURED = {"activitynet1.2": 3}
LAUNCHERS = ("gen_proposal_list.py", "ssn_train.py", "ssn_test.py",
             "eval_detection_results.py")


def write_start(path: str, num_class: int, modality: str, seed: int,
                favoured: int = 0) -> None:
    """A seeded TinyConv SSN of ``modality`` at epoch 0 as a flax
    ``checkpoint.msgpack``; its activity logits of classes 1..``favoured``
    raised by 4."""
    sd = seeded_init(SSN(num_class=num_class, base_model="TinyConv",
                         modality=modality), seed=seed).state_dict()
    sd["activity_fc.bias"][1:favoured + 1] += 4.0
    params, stats = jax_from_state_dict(sd, "TinyConv")
    with open(path, "wb") as f:
        f.write(flax_msgpack.serialize({
            "epoch": np.int64(0), "arch": "TinyConv",
            "best_loss": np.float64(np.inf),
            "reg_stats": np.zeros((2, 2), np.float32), "params": params,
            "batch_stats": stats, "extra": {}}))


def run_recipe(script: str, cwd: str, frames: str, shim_dir: str,
               flow_init: str) -> str:
    """``bash script frames work`` in ``cwd`` with the shim first on
    ``PATH``; returns its output (raises with it on failure)."""
    env = dict(os.environ, PATH=shim_dir + os.pathsep + os.environ["PATH"],
               PYTHONPATH=ROOT, FLOW_INIT=flow_init, OMP_NUM_THREADS="1")
    env.pop("KINETICS", None)
    proc = subprocess.run(["bash", script, frames, "work"], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=600)
    out = proc.stdout + proc.stderr
    assert proc.returncode == 0, out[-4000:]
    return out


def both_recipes(tmp_path, dataset: str) -> dict:
    """The port's twin and the JAX script on one dataset: each side's
    working directory and output."""
    frames = str(tmp_path / "frames")
    sides = {}
    extra = dict(EXTRA)
    for i, modality in enumerate(("RGB", "Flow")):
        start = str(tmp_path / f"start_{modality}.msgpack")
        write_start(start, DATASETS[dataset][3], modality, seed=10 + i,
                    favoured=FAVOURED.get(dataset, 0))
        for side in ("port", "jax"):
            extra[(side, "ssn_train", modality)] = ["--resume", start]
    write_python_shim(str(tmp_path / "bin"), extra,
                      rename=("BNInception", "TinyConv"))
    flow_init = str(tmp_path / "flow_init.pth")
    write_flow_init(flow_init, "TinyConv")
    for side, script in (
            ("port", os.path.join(ROOT, "action_detection_torch", "scripts",
                                  SCRIPTS[dataset])),
            ("jax", os.path.join(ROOT, "scripts", SCRIPTS[dataset]))):
        cwd = str(tmp_path / side)
        write_recipe_db(cwd, frames, dataset,
                        classes=FAVOURED.get(dataset, 0))
        if side == "jax":   # the JAX script runs its launchers from cwd
            for name in LAUNCHERS:
                os.symlink(os.path.join(ROOT, name), os.path.join(cwd, name))
        sides[side] = (cwd, run_recipe(script, cwd, frames,
                                       str(tmp_path / "bin"), flow_init))
    return sides


def check_recipes(sides: dict, dataset: str) -> None:
    (port_dir, port_out), (jax_dir, jax_out) = sides["port"], sides["jax"]
    # the same steps, CLI for CLI, with the same flags
    steps = recipe_steps(port_out)
    assert [s["cli"] for s in steps] == [
        "gen_proposal_list", "ssn_train", "ssn_train", "ssn_test",
        "ssn_test", "eval_detection_results"]
    # equal proposal lists
    lists = sorted(f for f in os.listdir(os.path.join(jax_dir, "data"))
                   if not f.endswith("_normalized_proposal_list.txt"))
    assert len(lists) == 2
    for name in lists:
        with open(os.path.join(port_dir, "data", name)) as f:
            got = f.read()
        with open(os.path.join(jax_dir, "data", name)) as f:
            assert got == f.read(), name
    # the twin's checkpoints, scored by the port
    for modality in ("rgb", "flow"):
        assert os.path.isfile(os.path.join(
            port_dir, f"ssn_{dataset}_TinyConv_{modality}_checkpoint.pt"))
        with open(os.path.join(port_dir, "work",
                               f"scores_{modality}.pkl"), "rb") as f:
            scores = pickle.load(f)
        assert len(scores) == 2 and all(
            np.isfinite(a).all() for v in scores.values() for a in v)
    # the fused mAP tables agree within 0.005 at every threshold
    got, want = map_row(port_out), map_row(jax_out)
    assert len(got) == len(want) == (10 if dataset == "thumos14" else 11)
    print(f"{dataset} mAP: port {got}, JAX {want}")
    assert got[-1] > 0
    np.testing.assert_allclose(got, want, atol=0.005)


def test_thumos14_recipe_matches_the_jax_recipe(tmp_path):
    sides = both_recipes(tmp_path, "thumos14")
    check_recipes(sides, "thumos14")
    # the Flow run read FLOW_INIT, on each side
    for _, out in sides.values():
        assert "cross-modality first conv: 3 -> 10 channels" in out


@pytest.mark.slow   # ~75 s: both recipes cost ~150 s at TinyConv
def test_anet12_recipe_matches_the_jax_recipe(tmp_path):
    check_recipes(both_recipes(tmp_path, "activitynet1.2"),
                  "activitynet1.2")


@pytest.mark.parametrize("dataset", sorted(SCRIPTS))
def test_twin_has_the_jax_scripts_steps_and_flags(dataset):
    """Each twin runs the JAX script's commands in order, with the same
    arguments: only the launcher (``python X.py`` -> ``python -m
    action_detection_torch.cli.X``) and the checkpoint suffix (``.msgpack``
    -> ``.pt``) differ, and it adds no variable the JAX script lacks
    (beyond the repository root it finds)."""
    def commands(path):
        with open(path) as f:
            text = f.read().replace("\\\n", " ")
        return [" ".join(line.split()[1:]).split("#")[0].strip()
                for line in text.splitlines()
                if line.startswith("python ")], text

    port, port_text = commands(os.path.join(
        ROOT, "action_detection_torch", "scripts", SCRIPTS[dataset]))
    jax, jax_text = commands(os.path.join(ROOT, "scripts", SCRIPTS[dataset]))
    port = [c.replace("-m action_detection_torch.cli.", "", 1)
            .replace("checkpoint.pt", "checkpoint.msgpack") for c in port]
    jax = [c.replace(".py", "", 1) for c in jax]
    assert port == jax and len(port) >= 5

    def knobs(text):
        return {w.split("}")[0].split(":")[0].split("+")[0]
                for w in text.split("${")[1:]}
    assert knobs(port_text) - {"PYTHONPATH"} == knobs(jax_text)
    assert "--device" not in port_text
