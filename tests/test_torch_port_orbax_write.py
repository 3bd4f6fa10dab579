"""The port's writer of the JAX package's orbax checkpoint directories
(``train/checkpoint.py:save_checkpoint_orbax``, through ``tensorstore``)
and its mapping back to flax trees (``models/convert.py:
jax_from_state_dict``), against the JAX package on the CPU:

* ``state_dict_from_jax(jax_from_state_dict(sd, arch))`` is ``sd`` bit for
  bit, for a seeded port SSN of TinyConv, BNInception, InceptionV3 (75^2),
  ResNet-18 and VGG-11 and for the binary model (BNInception);
* ``jax_from_state_dict`` of the state dict of a JAX-initialized tree is
  that tree: the same scopes and leaves, bit-equal (VGG-11: a tree of the
  JAX model's shapes, ``jax.eval_shape``, its 100M-weight fc layers
  constant);
* a directory the port writes reads back through the JAX package's
  ``load_checkpoint_orbax`` and ``load_checkpoint``, and the port's
  ``read_orbax``: bit-equal float32 trees (of float32 or bfloat16
  tensors), ``epoch``,
  ``arch``, ``best_loss``, ``reg_stats``; an empty ``batch_stats``; it
  replaces an older directory atomically;
* the JAX package's ``ssn_test`` scores it to the pickle the port's
  ``ssn_test`` writes from a ``.pt`` of the same weights (TinyConv);
* without tensorstore the writer raises ``ImportError`` naming it.
"""

import os
import pickle
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from action_detection_tpu.cli.ssn_test import main as j_ssn_test
from action_detection_tpu.models import SSN as JSSN
from action_detection_tpu.models import BinaryClassifier as JBinary
from action_detection_tpu.models import jitted_init
from action_detection_tpu.train.checkpoint import (
    load_checkpoint as j_load_checkpoint)
from action_detection_tpu.train.checkpoint import (
    load_checkpoint_orbax as j_load_orbax)

from action_detection_torch.cli.ssn_test import main as ssn_test
from action_detection_torch.models import (SSN, BinaryClassifier,
                                           jax_from_state_dict, seeded_init,
                                           state_dict_from_jax)
from action_detection_torch.train import save_checkpoint
from action_detection_torch.train.checkpoint import (read_orbax,
                                                     save_checkpoint_orbax)

from tests.test_datasets import write_proposal_list
from tests.test_torch_port_int8 import (  # noqa: F401 (fixture)
    _jitter, one_torch_thread)
from tests.test_torch_port_train_optim import SEG

REG_STATS = np.array([[0.01, -0.02], [0.1, 0.2]], np.float32)
#: arch -> input size of the JAX init (InceptionV3's smallest is 75)
SIZES = {"TinyConv": 32, "BNInception": 64, "InceptionV3": 75,
         "resnet18": 64}
#: a VGG-11 tensor this large is a constant (expand of one seeded value)
BIG = 1 << 20


def _port_model(arch: str):
    if arch == "binary":
        return BinaryClassifier(num_class=2, base_model="BNInception",
                                dropout=0.0)
    return SSN(num_class=3, base_model=arch, dropout=0.0, **SEG)


def _vgg_state_dict(seed: int) -> dict:
    """VGG-11 SSN's state dict names and shapes, seeded values; the
    fc layers (over ``BIG`` elements) an expanded constant each, so no
    400 MB tensor is made."""
    with torch.device("meta"):
        meta = _port_model("vgg11").state_dict()
    rng = np.random.RandomState(seed)
    sd = {}
    for k, t in meta.items():
        if t.dtype == torch.int64:
            sd[k] = torch.tensor(0)
        elif t.numel() > BIG:
            sd[k] = torch.tensor(np.float32(rng.randn())).expand(t.shape)
        else:
            sd[k] = torch.from_numpy(rng.randn(*t.shape).astype(np.float32))
    return sd


@pytest.mark.parametrize("arch", ["TinyConv", "BNInception", "InceptionV3",
                                  "resnet18", "vgg11", "binary"])
def test_state_dict_round_trips_through_the_flax_trees(arch):
    """port -> flax -> port is the identity, and the trees have the JAX
    layout: every backbone leaf under ``backbone``, the heads at the top,
    BN statistics only in ``batch_stats``."""
    if arch == "vgg11":
        sd = _vgg_state_dict(3)
    else:
        sd = seeded_init(_port_model(arch), seed=3).state_dict()
    params, stats = jax_from_state_dict(sd, "BNInception" if arch == "binary"
                                        else arch)
    heads = {"classifier_fc"} if arch == "binary" else {
        "activity_fc", "completeness_fc", "regressor_fc"}
    assert set(params) == {"backbone"} | heads
    # VGG-11 has no BN: no statistics at all
    assert set(stats) == (set() if arch == "vgg11" else {"backbone"})
    back = state_dict_from_jax(params, stats)
    assert set(back) == set(sd)
    for k, t in sd.items():
        assert back[k].dtype == t.dtype and torch.equal(back[k], t), k


def _jax_tree(arch: str, seed: int = 0):
    """A JAX-initialized SSN (binary: BinaryClassifier) tree, BN statistics
    jittered; VGG-11's from ``jax.eval_shape`` (seeded values, the fc
    layers constant)."""
    if arch == "vgg11":
        jm = JSSN(num_class=3, base_model=arch, dropout=0.0, **SEG)
        shapes = jax.eval_shape(lambda: jm.init(
            {"params": jax.random.PRNGKey(0)}, jnp.zeros((1, 3, 224, 224, 3)),
            jnp.ones((1, 2)), train=False))
        rng = np.random.RandomState(seed)

        def fill(s):
            if np.prod(s.shape) > BIG:
                return np.broadcast_to(np.float32(rng.randn()), s.shape)
            return rng.randn(*s.shape).astype(np.float32)
        return jax.tree_util.tree_map(fill, shapes)
    if arch == "binary":
        jm = JBinary(num_class=2, base_model="BNInception", dropout=0.0)
        args = (jnp.zeros((1, 5, 64, 64, 3)),)
    else:
        hw = SIZES[arch]
        jm = JSSN(num_class=3, base_model=arch, dropout=0.0, **SEG)
        args = (jnp.zeros((1, 3, hw, hw, 3)), jnp.ones((1, 2)))
    v = jitted_init(jm, {"params": jax.random.PRNGKey(seed)}, *args,
                    train=False)
    return jax.device_get(_jitter(v, seed=seed))


@pytest.mark.parametrize("arch", ["TinyConv", "BNInception", "InceptionV3",
                                  "resnet18", "vgg11", "binary"])
def test_jax_tree_round_trips(arch):
    """flax -> port -> flax is the identity: the JAX model's own tree comes
    back with its structure and bit-equal leaves."""
    tree = _jax_tree(arch)
    sd = state_dict_from_jax(tree["params"], tree.get("batch_stats"))
    params, stats = jax_from_state_dict(sd, "BNInception" if arch == "binary"
                                        else arch)
    for got, want in ((params, tree["params"]),
                      (stats, tree.get("batch_stats", {}))):
        assert (jax.tree_util.tree_structure(got)
                == jax.tree_util.tree_structure(jax.tree_util.tree_map(
                    np.asarray, want)))
        for g, w in zip(jax.tree_util.tree_leaves(got),
                        jax.tree_util.tree_leaves(want)):
            w = np.asarray(w)
            assert g.dtype == w.dtype == np.float32 and g.shape == w.shape
            np.testing.assert_array_equal(g, w)


def _same_tree(got, want):
    assert jax.tree_util.tree_structure(got) == \
        jax.tree_util.tree_structure(want)
    for g, w in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(want)):
        g, w = np.asarray(g), np.asarray(w)
        assert g.dtype == w.dtype and g.shape == w.shape
        assert g.tobytes() == w.tobytes()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_jax_reads_the_port_directory(tmp_path, dtype):
    """The JAX package's ``load_checkpoint_orbax`` and ``load_checkpoint``
    read the port's directory to its trees and metadata; the port's
    ``read_orbax`` too; a bfloat16 state dict is written widened to
    float32, exactly."""
    sd = seeded_init(_port_model("TinyConv"), seed=5).state_dict()
    if dtype == "bfloat16":
        sd = {k: t.to(torch.bfloat16) if t.is_floating_point() else t
              for k, t in sd.items()}
    d = str(tmp_path / "ck")
    save_checkpoint_orbax(d, sd, REG_STATS, arch="TinyConv", epoch=7,
                          best_loss=0.375)
    params, stats = jax_from_state_dict(sd, "TinyConv")
    assert sorted(os.listdir(d)) == ["ARCH", "_CHECKPOINT_METADATA",
                                     "_METADATA", "d", "manifest.ocdbt"]
    for load in (j_load_orbax, j_load_checkpoint):
        j = load(d)
        assert (j["epoch"], j["arch"], j["best_loss"]) == (7, "TinyConv",
                                                           0.375)
        np.testing.assert_array_equal(j["reg_stats"], REG_STATS)
        assert j["reg_stats"].dtype == np.float32
        # float32 leaves (bfloat16 tensors widened exactly)
        _same_tree(j["params"], params)
        _same_tree(j["batch_stats"], stats)
    r = read_orbax(d)
    assert (r["epoch"], r["arch"], r["best_loss"]) == (7, "TinyConv", 0.375)
    back = state_dict_from_jax(r["params"], r["batch_stats"])
    assert set(back) == set(sd)
    for k, t in sd.items():
        assert torch.equal(back[k].to(t.dtype), t), k


def test_empty_batch_stats_and_replacing_a_directory(tmp_path):
    """A model without BN (its ``batch_stats`` empty, a ``Dict`` orbax
    skips) reads back with an empty ``batch_stats``; a second save
    replaces the first, and leaves no ``.tmp_ocp`` behind."""
    sd = {"activity_fc.weight": torch.ones(4, 3),
          "activity_fc.bias": torch.zeros(4)}
    d = str(tmp_path / "ck")
    save_checkpoint_orbax(d, sd, REG_STATS, arch="a", epoch=1)
    save_checkpoint_orbax(d, {k: 2 * v for k, v in sd.items()}, REG_STATS,
                          arch="b", epoch=2)
    assert not os.path.exists(d + ".tmp_ocp")
    j = j_load_orbax(d)
    assert j["batch_stats"] == {} and (j["epoch"], j["arch"]) == (2, "b")
    np.testing.assert_array_equal(j["params"]["activity_fc"]["kernel"],
                                  np.full((3, 4), 2, np.float32))
    assert j["best_loss"] == float("inf")
    assert read_orbax(d)["batch_stats"] == {}


def test_jax_ssn_test_scores_the_port_directory(tmp_path, monkeypatch):
    """The JAX package's ``ssn_test`` on the port's orbax directory writes
    the pickle the port's ``ssn_test`` writes from a ``.pt`` of the same
    weights (TinyConv, synthetic frames, float path), within the 0.12
    scoring bound (measured far below it)."""
    monkeypatch.chdir(tmp_path)
    write_proposal_list(tmp_path / "thumos14_tag_test_proposal_list.txt",
                        n_videos=2, seed=7)
    model = seeded_init(SSN(num_class=20, base_model="TinyConv",
                            dropout=0.0), seed=8)
    with torch.no_grad():     # heads far from zero: scores that differ
        for head in ("activity_fc", "completeness_fc", "regressor_fc"):
            getattr(model, head).weight.mul_(300.0)
    sd = model.state_dict()
    save_checkpoint_orbax("ck", sd, REG_STATS, arch="TinyConv")
    save_checkpoint("w.pt", sd, REG_STATS, arch="TinyConv")
    common = ["--arch", "TinyConv", "--synthetic_data", "--prop_file_dir",
              str(tmp_path), "--frame_interval", "30", "--test_batchsize",
              "8"]
    j_ssn_test(["thumos14", "RGB", "ck", "j.pkl"] + common
               + ["--devices", "0"])
    ssn_test(["thumos14", "RGB", "w.pt", "p.pkl"] + common
             + ["--device", "cpu"])
    with open("j.pkl", "rb") as f:
        want = pickle.load(f)
    with open("p.pkl", "rb") as f:
        got = pickle.load(f)
    assert set(got) == set(want) and len(got) == 2
    worst = 0.0
    for vid in want:
        for g, w in zip(got[vid], want[vid]):
            assert g.shape == w.shape
            worst = max(worst, float(np.abs(g - w).max()))
    print(f"max |d| {worst:.2e}")
    assert worst < 0.12


def test_without_tensorstore_raises_importerror_naming_it(tmp_path,
                                                          monkeypatch):
    monkeypatch.setitem(sys.modules, "tensorstore", None)
    d = str(tmp_path / "ck")
    with pytest.raises(ImportError, match="tensorstore"):
        save_checkpoint_orbax(d, {"activity_fc.bias": torch.zeros(2)},
                              REG_STATS)
    assert not os.path.exists(d) and not os.path.exists(d + ".tmp_ocp")
