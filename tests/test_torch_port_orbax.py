"""The port's reader of the JAX package's orbax checkpoint directories
(``train/checkpoint.py:read_orbax``, through ``tensorstore``) against
``action_detection_tpu/train/checkpoint.py:load_checkpoint_orbax`` on the
CPU:

* directories written by JAX's ``save_checkpoint_orbax`` read as the tree
  ``load_checkpoint_orbax`` returns: keys, dtypes, bfloat16 bits, the 0-d
  ``epoch`` and ``best_loss`` as Python scalars, an empty ``batch_stats``,
  a missing ``ARCH`` sidecar as ``""``;
* the committed directory (``tests/fixtures/torch_port_orbax``, written by
  :func:`write_fixture`: a TinyConv SSN with bfloat16 parameters and
  float32 batch statistics) still reads to the tensor digests committed
  beside it;
* ``ssn_test`` scores that directory to the pickle of the same checkpoint
  saved as a msgpack.

``python -m tests.test_torch_port_orbax`` writes the fixture anew.
"""

import hashlib
import json
import os
import pickle
import shutil

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from action_detection_tpu.models import SSN as JSSN
from action_detection_tpu.train.checkpoint import (
    load_checkpoint_orbax as j_load_orbax)
from action_detection_tpu.train.checkpoint import (
    save_checkpoint as j_save_checkpoint)
from action_detection_tpu.train.checkpoint import (
    save_checkpoint_orbax as j_save_orbax)

from action_detection_torch.cli.ssn_test import main as ssn_test
from action_detection_torch.train import load_checkpoint
from action_detection_torch.train.checkpoint import read_file, read_orbax

from tests.test_datasets import write_proposal_list
from tests.test_torch_port_checkpoints import _same
from tests.test_torch_port_int8 import (  # noqa: F401 (fixture)
    _jitter, one_torch_thread)

FIXTURE_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "fixtures", "torch_port_orbax")
FIXTURE = os.path.join(FIXTURE_DIR, "ssn_tinyconv")
REG_STATS = np.array([[0.01, -0.02], [0.1, 0.2]], np.float32)


def _tinyconv_tree(seed: int = 4):
    """A TinyConv SSN's flax params (bfloat16) and batch statistics
    (float32, jittered)."""
    jm = JSSN(num_class=20, base_model="TinyConv", dropout=0.0)
    v = _jitter(jm.init({"params": jax.random.PRNGKey(seed)},
                        jnp.zeros((1, 9, 32, 32, 3)), jnp.ones((1, 2)),
                        train=False), seed=seed)
    v = jax.device_get(v)
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float32).astype(jnp.bfloat16),
        v["params"])
    return params, v["batch_stats"]


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out


def _leaf_digest(a) -> dict:
    """dtype, shape and sha256 of a leaf's bytes (a bfloat16 tensor's as
    uint16)."""
    if isinstance(a, torch.Tensor):
        dtype, a = str(a.dtype).split(".")[-1], a.view(torch.uint16).numpy()
    else:
        a = np.asarray(a)
        dtype = str(a.dtype)
    return {"dtype": dtype, "shape": list(a.shape), "sha256": hashlib.sha256(
        np.ascontiguousarray(a).tobytes()).hexdigest()}


def tree_digests(tree: dict) -> dict:
    """The digests of a tree the port read: each array leaf by its dotted
    path, and the scalars and ``arch`` as they are."""
    out = {k: _leaf_digest(v) for k, v in _flat(
        {"params": tree["params"], "batch_stats": tree["batch_stats"],
         "reg_stats": tree["reg_stats"]}).items()}
    out.update(epoch=tree["epoch"], best_loss=tree["best_loss"],
               arch=tree["arch"])
    return out


def write_fixture(directory: str = FIXTURE) -> None:
    """The committed directory, by JAX's ``save_checkpoint_orbax``, and
    ``digests.json`` beside it (the port's read of it)."""
    params, stats = _tinyconv_tree()
    if os.path.exists(directory):
        shutil.rmtree(directory)
    j_save_orbax(directory, params, REG_STATS, batch_stats=stats, epoch=7,
                 arch="TinyConv", best_loss=0.375)
    with open(os.path.join(os.path.dirname(directory), "digests.json"),
              "w") as f:
        json.dump(tree_digests(read_orbax(directory)), f, indent=1,
                  sort_keys=True)
        f.write("\n")


def _orbax_case(tmp_path, case: str) -> str:
    if case == "committed":
        return FIXTURE
    params, stats = _tinyconv_tree(seed=9)
    d = str(tmp_path / "ck")
    if case == "empty_batch_stats_no_arch":
        j_save_orbax(d, params, REG_STATS, epoch=2, arch="TinyConv")
        os.remove(os.path.join(d, "ARCH"))
    else:   # float32 parameters, an infinite best_loss
        j_save_orbax(d, jax.tree_util.tree_map(
            lambda a: np.asarray(a, np.float32), params), REG_STATS,
            batch_stats=stats, epoch=0, arch="resnet18")
    return d


@pytest.mark.parametrize("case", ["committed", "empty_batch_stats_no_arch",
                                  "float32"])
def test_reads_the_tree_of_load_checkpoint_orbax(tmp_path, case):
    d = _orbax_case(tmp_path, case)
    want = j_load_orbax(d)
    kind, got = read_file(d)
    assert kind == "orbax"
    _same(got, want)
    if case == "empty_batch_stats_no_arch":
        assert got["batch_stats"] == {} and got["arch"] == ""
    assert isinstance(got["epoch"], int)
    assert isinstance(got["best_loss"], float)


def test_committed_fixture_reads_to_its_digests():
    with open(os.path.join(FIXTURE_DIR, "digests.json")) as f:
        want = json.load(f)
    got = tree_digests(read_orbax(FIXTURE))
    assert got == want
    assert want["params.activity_fc.kernel"]["dtype"] == "bfloat16"
    assert want["batch_stats.backbone.conv1_7x7_s2_bn.mean"]["dtype"] == \
        "float32"


def test_load_checkpoint_reads_orbax_as_the_same_msgpack(tmp_path):
    """``load_checkpoint`` of the directory equals that of its tree saved
    by JAX as a msgpack: the state dict tensor for tensor, reg_stats, arch,
    epoch and best_loss."""
    msgpack = str(tmp_path / "w.msgpack")
    tree = j_load_orbax(FIXTURE)
    j_save_checkpoint(msgpack, tree["params"], tree["reg_stats"],
                      batch_stats=tree["batch_stats"], epoch=tree["epoch"],
                      arch=tree["arch"], best_loss=tree["best_loss"])
    got, want = load_checkpoint(FIXTURE), load_checkpoint(msgpack)
    assert (got["arch"], got["epoch"], got["best_loss"]) == \
        (want["arch"], want["epoch"], want["best_loss"]) == \
        ("TinyConv", 7, 0.375)
    np.testing.assert_array_equal(got["reg_stats"], want["reg_stats"])
    assert set(got["state_dict"]) == set(want["state_dict"])
    for k, t in want["state_dict"].items():
        assert torch.equal(got["state_dict"][k], t), k


def test_ssn_test_scores_orbax_as_the_msgpack(tmp_path, monkeypatch):
    """The port's ssn_test (TinyConv, synthetic frames, float path) on the
    committed orbax directory writes the pickle it writes on the same
    checkpoint saved as a msgpack, exactly."""
    monkeypatch.chdir(tmp_path)
    write_proposal_list(tmp_path / "thumos14_tag_test_proposal_list.txt",
                        n_videos=2, seed=7)
    tree = j_load_orbax(FIXTURE)
    j_save_checkpoint("w.msgpack", tree["params"], tree["reg_stats"],
                      batch_stats=tree["batch_stats"], arch="TinyConv")
    common = ["--arch", "TinyConv", "--synthetic_data", "--prop_file_dir",
              str(tmp_path), "--frame_interval", "30", "--test_batchsize",
              "8", "--device", "cpu"]
    ssn_test(["thumos14", "RGB", FIXTURE, "o.pkl"] + common)
    ssn_test(["thumos14", "RGB", "w.msgpack", "m.pkl"] + common)
    with open("o.pkl", "rb") as f:
        got = pickle.load(f)
    with open("m.pkl", "rb") as f:
        ref = pickle.load(f)
    assert set(got) == set(ref) and len(got) == 2
    for vid in ref:
        for g, r in zip(got[vid], ref[vid]):
            np.testing.assert_array_equal(g, r)
        assert np.isfinite(got[vid][1]).all()


if __name__ == "__main__":
    write_fixture()
