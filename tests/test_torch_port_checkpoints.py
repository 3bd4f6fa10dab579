"""Port parity, checkpoint interop, against the JAX package on the CPU:

* the port's pure-Python msgpack reader against
  ``flax.serialization.msgpack_restore`` and its writer against
  ``msgpack_serialize`` (the same bytes, read back by flax): a JAX
  checkpoint, bfloat16 leaves, numpy scalars, empty dicts, every msgpack
  length and integer form, and a chunked leaf (``MAX_CHUNK_SIZE`` patched
  down);
* ``load_checkpoint`` on the port's ``.pt``, a JAX ``checkpoint.msgpack``,
  a port-written msgpack and reference ``.pth.tar`` files (``module.``
  keys, numpy ``reg_stats``, no ``num_batches_tracked``; torch's zip
  format, and its older format with numpy 1's names): the same weights;
  what it refuses, by name;
* ``ssn_test`` and ``binary_test`` on each format: pickles equal to the
  port's on the ``.pt``, and within 1e-4 of the JAX CLI on the
  ``.pth.tar`` (the bound of tests/test_torch_port_scorer.py:check_cli);
* ``--use_reference`` from ``$ADT_MODEL_CACHE``, and its error naming the
  missing file;
* ``--init_weights`` from a JAX msgpack and from a torchvision ResNet dump
  (``fc.*`` left out; RGB and the Flow first conv): what the JAX
  ``apply_init_weights`` grafts.
"""

import dataclasses
import datetime
import os
import pickle

import numpy as np
import pytest
import torch

import flax.serialization as fser
import jax
import jax.numpy as jnp

from action_detection_tpu import config as jconfig
from action_detection_tpu.cli.binary_test import main as j_binary_test
from action_detection_tpu.cli.ssn_test import main as j_ssn_test
from action_detection_tpu.models import SSN as JSSN
from action_detection_tpu.models.convert import (
    convert_torch_ssn_checkpoint as j_convert_ssn)
from action_detection_tpu.train import TrainState
from action_detection_tpu.train import load_checkpoint as j_load_checkpoint
from action_detection_tpu.train import save_checkpoint as j_save_checkpoint
from action_detection_tpu.train.init_weights import (
    apply_init_weights as j_apply_init_weights)

from action_detection_torch import config
from action_detection_torch.cli.binary_test import main as binary_test
from action_detection_torch.cli.ssn_test import main as ssn_test
from action_detection_torch.models import (SSN, BinaryClassifier,
                                           seeded_init, state_dict_from_jax)
from action_detection_torch.train import (flax_msgpack, load_checkpoint,
                                          save_checkpoint)
from action_detection_torch.train.init_weights import apply_init_weights

from tests.test_datasets import write_proposal_list
from tests.test_torch_port_binary import binary_checkpoints
from tests.test_torch_port_int8 import (  # noqa: F401 (fixture)
    _jitter, one_torch_thread)

REG_STATS = np.array([[0.01, -0.02], [0.1, 0.2]], np.float32)


def _bf16(a):
    return np.asarray(jnp.asarray(a, jnp.bfloat16))


def _same(got, want, path="") -> None:
    """The port's tree equals flax's: dicts key for key, arrays in dtype,
    shape and bits (bfloat16: a torch tensor against flax's ml_dtypes
    array), scalars in type and value."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), path
        for k in want:
            _same(got[k], want[k], f"{path}/{k}")
    elif isinstance(got, torch.Tensor):
        assert got.dtype == torch.bfloat16 and str(want.dtype) == "bfloat16"
        np.testing.assert_array_equal(got.view(torch.uint16).numpy(),
                                      np.asarray(want).view(np.uint16))
    elif isinstance(want, np.ndarray):
        assert isinstance(got, np.ndarray) and got.dtype == want.dtype, path
        np.testing.assert_array_equal(got, want)
    else:
        assert type(got) is type(want) and got == want, (path, got, want)


def _to_port(tree):
    """flax's tree with its bfloat16 arrays as torch tensors, the form the
    port's reader returns and its writer takes."""
    if isinstance(tree, dict):
        return {k: _to_port(v) for k, v in tree.items()}
    if isinstance(tree, np.ndarray) and str(tree.dtype) == "bfloat16":
        return torch.from_numpy(tree.view(np.uint16).copy()).view(
            torch.bfloat16)
    return tree


def _jax_checkpoint_tree(tmp_path):
    path = str(tmp_path / "j.msgpack")
    rng = np.random.RandomState(0)
    j_save_checkpoint(path, {"backbone": {"conv1": {
        "kernel": rng.randn(3, 3, 3, 8).astype(np.float32)}}},
        REG_STATS, batch_stats={"backbone": {"bn": {
            "mean": np.zeros(8, np.float32), "var": np.ones(8, np.float32)}}},
        epoch=4, arch="resnet18", best_loss=0.5)
    with open(path, "rb") as f:
        return fser.msgpack_restore(f.read())


TREES = {
    "jax_checkpoint": _jax_checkpoint_tree,
    "bf16": lambda _: {"w": _bf16(np.arange(12.0).reshape(3, 4) / 7),
                       "v": {"b": _bf16(-np.arange(3.0))}},
    "numpy_scalars": lambda _: {
        "epoch": np.int64(7), "best_loss": np.float64(0.25),
        "f32": np.float32(1.5), "u8": np.uint8(200), "flag": np.bool_(True),
        "i16": np.int16(-300)},
    "empty_dicts": lambda _: {"params": {}, "batch_stats": {},
                              "extra": {"a": {}}},
    "msgpack_forms": lambda _: {
        "ints": [0, 127, 128, 255, 256, 65535, 65536, 2 ** 32 - 1, 2 ** 32,
                 -1, -32, -33, -128, -129, -32768, -32769, -2 ** 31 - 1],
        "s": "x" * 31, "s8": "y" * 40, "s16": "z" * 300, "b8": b"\0" * 9,
        "b16": b"\1" * 300, "f": 1.25, "t": True, "n": None,
        "map16": {str(i): i for i in range(20)}, "list16": list(range(20)),
        "arr": np.arange(70000, dtype=np.int32)},
    "chunked": lambda _: {"a": {"w": np.arange(70.0, dtype=np.float32
                                               ).reshape(10, 7)},
                          "b16": _bf16(np.arange(45.0).reshape(9, 5)),
                          "small": np.ones(3, np.float32)},
}


@pytest.fixture
def small_chunks(request, monkeypatch):
    """flax's and the port's chunk size patched down to 64 bytes for the
    ``chunked`` case."""
    if request.node.callspec.params["case"] == "chunked":
        monkeypatch.setattr(fser, "MAX_CHUNK_SIZE", 64)
        monkeypatch.setattr(flax_msgpack, "MAX_CHUNK_SIZE", 64)


@pytest.mark.parametrize("case", sorted(TREES))
def test_msgpack_reader_matches_flax(case, tmp_path, small_chunks):
    tree = TREES[case](tmp_path)
    data = fser.msgpack_serialize(tree)
    if case == "chunked":
        assert b"__msgpack_chunked_array__" in data
    _same(flax_msgpack.restore(data), fser.msgpack_restore(data))


@pytest.mark.parametrize("case", sorted(TREES))
def test_msgpack_writer_is_read_back_by_flax(case, tmp_path, small_chunks):
    """The writer's bytes are flax's bytes for the same tree, and flax reads
    them back to the tree."""
    tree = TREES[case](tmp_path)
    data = flax_msgpack.serialize(_to_port(tree))
    assert data == fser.msgpack_serialize(tree)
    _same(flax_msgpack.restore(data), fser.msgpack_restore(data))


def _reference_pth(path, state_dict, legacy=False, arch="TinyConv"):
    """A reference-style SSN checkpoint: DataParallel's ``module.`` on every
    key, no ``num_batches_tracked`` (older torch), numpy ``reg_stats``. The
    older (non-zip) format is written with numpy 1's module names, as
    checkpoints of that era carry them."""
    sd = {"module." + k: v for k, v in state_dict.items()
          if not k.endswith("num_batches_tracked")}
    torch.save({"epoch": 80, "arch": arch, "state_dict": sd,
                "best_loss": 0.125, "reg_stats": REG_STATS.copy()}, path,
               _use_new_zipfile_serialization=not legacy)
    if legacy:
        with open(path, "rb") as f:
            data = f.read()
        assert b"numpy._core.multiarray" in data
        with open(path, "wb") as f:
            f.write(data.replace(b"numpy._core.multiarray",
                                 b"numpy.core.multiarray"))


def _flax_tree(model):
    """The JAX package's tree of a port model (its own converter on the
    port's state dict)."""
    return j_convert_ssn({"state_dict": model.state_dict()}, "TinyConv")


@pytest.mark.parametrize("fmt", ["pt", "jax_msgpack", "port_msgpack",
                                 "reference_pth_tar", "reference_legacy"])
def test_load_checkpoint_reads_every_format(tmp_path, fmt):
    model = seeded_init(SSN(num_class=20, base_model="TinyConv"), seed=3)
    path = str(tmp_path / {"pt": "w.pt", "jax_msgpack": "w.msgpack",
                           "port_msgpack": "w.msgpack"}.get(fmt, "w.pth.tar"))
    ck = _flax_tree(model)
    if fmt == "pt":
        save_checkpoint(path, model.state_dict(), REG_STATS, arch="TinyConv",
                        epoch=80, best_loss=0.125)
    elif fmt == "jax_msgpack":
        j_save_checkpoint(path, ck["params"], REG_STATS,
                          batch_stats=ck["batch_stats"], epoch=80,
                          arch="TinyConv", best_loss=0.125)
    elif fmt == "port_msgpack":
        with open(path, "wb") as f:
            f.write(flax_msgpack.serialize({
                "epoch": np.int64(80), "arch": "TinyConv",
                "best_loss": np.float64(0.125), "reg_stats": REG_STATS,
                "params": ck["params"], "batch_stats": ck["batch_stats"],
                "extra": {}}))
    else:
        _reference_pth(path, model.state_dict(),
                       legacy=fmt == "reference_legacy")
    got = load_checkpoint(path)
    assert (got["arch"], got["epoch"], got["best_loss"]) == ("TinyConv", 80,
                                                             0.125)
    np.testing.assert_array_equal(got["reg_stats"], REG_STATS)
    want = model.state_dict()
    assert set(got["state_dict"]) == set(want)
    for k, t in want.items():
        assert torch.equal(got["state_dict"][k], t), k
    SSN(num_class=20, base_model="TinyConv").load_state_dict(
        got["state_dict"])


def test_load_checkpoint_refuses_by_name(tmp_path):
    """An orbax directory, a file of no known format and a pickle of
    anything but tensors, containers, numbers and numpy arrays are refused;
    nothing of the last is executed."""
    with pytest.raises(ValueError, match="orbax"):
        load_checkpoint(str(tmp_path))
    (tmp_path / "notes.txt").write_text("weights")
    with pytest.raises(ValueError, match="not a checkpoint the port reads"):
        load_checkpoint(str(tmp_path / "notes.txt"))
    torch.save({"state_dict": {}, "when": datetime.date(2017, 1, 1)},
               str(tmp_path / "odd.pth"))
    with pytest.raises(pickle.UnpicklingError, match="datetime"):
        load_checkpoint(str(tmp_path / "odd.pth"))


def _load(path):
    with open(path, "rb") as f:
        return pickle.load(f)


def test_ssn_test_scores_every_format_as_the_pt(tmp_path, monkeypatch):
    """The port's ssn_test (TinyConv, synthetic frames, float path) on a
    JAX msgpack and on a reference .pth.tar writes the pickle it writes on
    the same weights as .pt, exactly; the JAX CLI on the .pth.tar agrees
    within 1e-4."""
    monkeypatch.chdir(tmp_path)
    write_proposal_list(tmp_path / "thumos14_tag_test_proposal_list.txt",
                        n_videos=2, seed=7)
    jm = JSSN(num_class=20, base_model="TinyConv", dropout=0.0)
    v = _jitter(jm.init({"params": jax.random.PRNGKey(4)},
                        jnp.zeros((1, 9, 32, 32, 3)), jnp.ones((1, 2)),
                        train=False), seed=4)
    rng = np.random.RandomState(5)
    params = jax.tree_util.tree_map_with_path(
        lambda p, a: (a * 300.0 + rng.randn(*a.shape).astype(np.float32)
                      * (p[-1].key == "bias") if p[0].key.endswith("_fc")
                      else a), jax.device_get(v["params"]))
    stats = jax.device_get(v["batch_stats"])
    sd = state_dict_from_jax(params, stats)
    j_save_checkpoint("w.msgpack", params, REG_STATS, batch_stats=stats,
                      arch="TinyConv")
    save_checkpoint("w.pt", sd, REG_STATS, arch="TinyConv")
    _reference_pth("w.pth.tar", sd)
    common = ["--arch", "TinyConv", "--synthetic_data", "--prop_file_dir",
              str(tmp_path), "--frame_interval", "30", "--test_batchsize",
              "8"]
    for name in ("w.pt", "w.msgpack", "w.pth.tar"):
        ssn_test(["thumos14", "RGB", name, name + ".pkl"] + common
                 + ["--device", "cpu"])
    j_ssn_test(["thumos14", "RGB", "w.pth.tar", "j.pkl"] + common
               + ["--devices", "0"])
    ref = _load("w.pt.pkl")
    assert len(ref) == 2
    for name in ("w.msgpack.pkl", "w.pth.tar.pkl"):
        got = _load(name)
        assert set(got) == set(ref)
        for vid in ref:
            for g, r in zip(got[vid], ref[vid]):
                np.testing.assert_array_equal(g, r)
    jref = _load("j.pkl")
    for vid in jref:
        for g, r in zip(ref[vid], jref[vid]):
            np.testing.assert_allclose(g, r, rtol=0, atol=1e-4)
        assert np.abs(jref[vid][1]).max() > 1e-2


def test_binary_test_scores_every_format_as_the_pt(tmp_path, monkeypatch):
    """binary_test (TinyConv) on the JAX msgpack, the port .pt and a
    reference-style .pth.tar of one actionness model: equal pickles; the
    JAX CLI on the .pth.tar within 1e-4."""
    monkeypatch.chdir(tmp_path)
    write_proposal_list(tmp_path / "thumos14_sw_test_proposal_list.txt",
                        n_videos=2, seed=2)
    _, _, params, stats = binary_checkpoints(tmp_path)
    _reference_pth("b.pth.tar", state_dict_from_jax(params, stats))
    args = ["thumos14", "RGB", "testing"]
    common = ["--arch", "TinyConv", "--synthetic_data", "--prop_file_dir",
              str(tmp_path), "--frame_interval", "40", "--test_batchsize",
              "4"]
    for name in ("b.pt", "b.msgpack", "b.pth.tar"):
        binary_test(args + [name, name + ".pkl"] + common
                    + ["--device", "cpu"])
    j_binary_test(args + ["b.pth.tar", "j.pkl"] + common)
    ref = _load("b.pt.pkl")
    for name in ("b.msgpack.pkl", "b.pth.tar.pkl"):
        got = _load(name)
        assert set(got) == set(ref)
        for vid in ref:
            np.testing.assert_array_equal(got[vid], ref[vid])
    jref = _load("j.pkl")
    assert set(jref) == set(ref)
    for vid in jref:
        np.testing.assert_allclose(ref[vid], jref[vid], rtol=0, atol=1e-4)


def test_reference_table_and_cache_match_jax(tmp_path, monkeypatch):
    """Every published reference URL equals the JAX package's; a missing
    combination raises KeyError in both; an uncached file raises
    FileNotFoundError naming its path in the cache."""
    monkeypatch.setenv("ADT_MODEL_CACHE", str(tmp_path))
    for dataset, inits in config.REFERENCE_MODELS.items():
        for init, archs in inits.items():
            for arch, mods in archs.items():
                for modality in mods:
                    args = (dataset, modality, init, arch)
                    assert config.get_reference_model_url(*args) == \
                        jconfig.get_reference_model_url(*args)
                    name = os.path.join(str(tmp_path), mods[modality]
                                        .rsplit("/", 1)[-1])
                    for fn in (config.resolve_reference_checkpoint,
                               jconfig.resolve_reference_checkpoint):
                        with pytest.raises(FileNotFoundError,
                                           match=name.replace(".", r"\.")):
                            fn(*args)
    for args in (("activitynet1.2", "RGB", "Kinetics", "BNInception"),
                 ("thumos14", "RGB", "ImageNet", "resnet101")):
        for fn in (config.get_reference_model_url,
                   jconfig.get_reference_model_url):
            with pytest.raises(KeyError):
                fn(*args)


def test_use_reference_scores_the_cached_checkpoint(tmp_path, monkeypatch,
                                                    capsys):
    """ssn_test --use_reference finds the published THUMOS14 BNInception
    RGB checkpoint under its file name in $ADT_MODEL_CACHE (a fabricated
    reference .pth.tar here) and writes the pickle of scoring that file
    directly; --use_kinetics_reference, not cached, raises naming its
    path, and so does binary_test --use_reference."""
    monkeypatch.chdir(tmp_path)
    cache = tmp_path / "cache"
    cache.mkdir()
    monkeypatch.setenv("ADT_MODEL_CACHE", str(cache))
    write_proposal_list(tmp_path / "thumos14_tag_test_proposal_list.txt",
                        n_videos=1, seed=3)
    model = seeded_init(SSN(num_class=20, base_model="BNInception"), seed=0)
    url = config.get_reference_model_url("thumos14", "RGB", "ImageNet",
                                         "BNInception")
    cached = str(cache / url.rsplit("/", 1)[-1])
    _reference_pth(cached, model.state_dict())
    common = ["--synthetic_data", "--prop_file_dir", str(tmp_path),
              "--no_int8", "--frame_interval", "300", "--test_batchsize",
              "2", "--device", "cpu"]
    ssn_test(["thumos14", "RGB", "ignored.pt", "ref.pkl", "--use_reference"]
             + common)
    assert f"using reference model: {cached}" in capsys.readouterr().out
    ssn_test(["thumos14", "RGB", cached, "direct.pkl"] + common)
    ref, direct = _load("ref.pkl"), _load("direct.pkl")
    assert set(ref) == set(direct) and len(ref) == 1
    for vid in ref:
        for a, b in zip(ref[vid], direct[vid]):
            np.testing.assert_array_equal(a, b)
    missing = str(cache / config.get_reference_model_url(
        "thumos14", "RGB", "Kinetics", "BNInception").rsplit("/", 1)[-1])
    with pytest.raises(FileNotFoundError, match=missing.replace(".", r"\.")):
        ssn_test(["thumos14", "RGB", "ignored.pt", "k.pkl",
                  "--use_kinetics_reference"] + common)
    flow = str(cache / config.get_reference_model_url(
        "thumos14", "Flow", "ImageNet", "BNInception").rsplit("/", 1)[-1])
    with pytest.raises(FileNotFoundError, match=flow.replace(".", r"\.")):
        binary_test(["thumos14", "Flow", "testing", "ignored.pt", "b.pkl",
                     "--use_reference"] + common)


@dataclasses.dataclass
class _Args:
    init_weights: str = ""
    kinetics_pretrain: bool = False
    arch: str = "TinyConv"
    modality: str = "RGB"


def _jax_init(tm, args):
    """The JAX apply_init_weights on the JAX tree of the port model ``tm``,
    as the port's state dict."""
    ck = j_convert_ssn({"state_dict": tm.state_dict()}, args.arch)
    state = TrainState(step=0, params=ck["params"],
                       batch_stats=ck["batch_stats"], opt_state=None)
    new = j_apply_init_weights(state, args, None, j_load_checkpoint)
    return state_dict_from_jax(new.params, new.batch_stats)


def test_init_weights_from_a_jax_msgpack_match_jax(tmp_path):
    """--init_weights of a JAX checkpoint.msgpack grafts its backbone
    weights and running statistics, as the JAX CLI does, and leaves the
    heads."""
    src = seeded_init(SSN(num_class=20, base_model="TinyConv"), seed=8)
    ck = _flax_tree(src)
    path = str(tmp_path / "init.msgpack")
    j_save_checkpoint(path, ck["params"], REG_STATS,
                      batch_stats=ck["batch_stats"], arch="TinyConv")
    tm = seeded_init(SSN(num_class=3, base_model="TinyConv"), seed=2)
    args = _Args(init_weights=path)
    want = _jax_init(tm, args)
    before = {k: t.clone() for k, t in tm.state_dict().items()}
    apply_init_weights(tm, args, None)
    got = tm.state_dict()
    for k, w in want.items():
        if w.is_floating_point():
            assert torch.equal(got[k], w), k
            src_k = src.state_dict().get(k)
            if k.startswith("base_model."):
                assert torch.equal(got[k], src_k), k
            else:
                assert torch.equal(got[k], before[k]), k


@pytest.mark.parametrize("modality", ["RGB", "Flow"])
def test_init_weights_from_a_torchvision_resnet_dump_match_jax(
        tmp_path, modality):
    """A torchvision-style ResNet-18 ImageNet dump (bare keys, the 1000-way
    ``fc``) as --init_weights: every backbone weight and statistic grafted
    as the JAX CLI grafts it (for Flow, ``conv1`` through the
    cross-modality mean, 3 -> 10 channels); ``fc.*`` is left out."""
    from tests.test_torch_port_resnet_vgg import torchvision_state

    dump = dict(torchvision_state("resnet18", seed=6))
    dump["fc.weight"] = torch.randn(1000, 512)
    dump["fc.bias"] = torch.randn(1000)
    path = str(tmp_path / "resnet18-imagenet.pth")
    torch.save(dump, path)
    tm = seeded_init(SSN(num_class=3, base_model="resnet18",
                         modality=modality), seed=2)
    args = _Args(init_weights=path, arch="resnet18", modality=modality)
    want = _jax_init(tm, args)
    apply_init_weights(tm, args, None)
    got = tm.state_dict()
    assert "base_model.fc.weight" in want and "base_model.fc.weight" not in got
    for k, t in got.items():
        if t.is_floating_point():
            assert torch.equal(t, want[k]), k
    c = 3 if modality == "RGB" else 10
    assert got["base_model.conv1.weight"].shape[1] == c
