"""Port parity, the training CLIs end to end: the port's ``ssn_train`` and
``binary_train`` against the JAX CLIs on TinyConv, synthetic frames,
dropout 0 (the dropout masks come from different generators), one host
thread. Both resume from the same start weights (a JAX msgpack written by
the JAX ``save_checkpoint`` and its ``state_dict_from_jax`` twin as
``.pt``, both at epoch 0) and train one epoch of three steps (``binary``:
one) with validation: the final checkpoints' weights agree within 1e-4 of
each tensor's largest value, and the validation loss (the checkpoints'
``best_loss``) within 1e-5 relative. The port's checkpoints then score
through its ``ssn_test`` and ``binary_test`` on the CPU. Both CLIs train
ResNet and VGG; each refusal of the training CLIs names its ROADMAP
item."""

import os
import pickle

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from action_detection_tpu.cli.binary_train import main as j_binary_train
from action_detection_tpu.cli.ssn_train import main as j_ssn_train
from action_detection_tpu.models import SSN as JSSN
from action_detection_tpu.models import BinaryClassifier as JBinary
from action_detection_tpu.models import jitted_init
from action_detection_tpu.train import load_checkpoint as j_load_checkpoint
from action_detection_tpu.train import save_checkpoint as j_save_checkpoint

from action_detection_torch.cli import binary_test, binary_train, ssn_test
from action_detection_torch.cli import ssn_train
from action_detection_torch.models import state_dict_from_jax
from action_detection_torch.train import load_checkpoint, save_checkpoint

from tests.test_datasets import write_proposal_list
from tests.test_torch_port_int8 import (  # noqa: F401 (fixture)
    _jitter, one_torch_thread)

COMMON = ["--arch", "TinyConv", "--synthetic_data", "--dropout", "0", "-j",
          "1", "--print-freq", "1", "--epochs", "1"]


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    d = tmp_path_factory.mktemp("train_cli")
    for task in ("tag", "sw"):
        write_proposal_list(d / f"thumos14_{task}_val_proposal_list.txt",
                            n_videos=3)
        write_proposal_list(d / f"thumos14_{task}_test_proposal_list.txt",
                            n_videos=2, seed=7)
    return d


def _start(model, x, path, reg_stats):
    """Seeded flax weights (jittered BN statistics) saved as the JAX CLI's
    msgpack and as the port's .pt, both at epoch 0."""
    v = _jitter(jitted_init(model, {"params": jax.random.PRNGKey(0)}, *x,
                            train=False), seed=3)
    params = jax.device_get(v["params"])
    stats = jax.device_get(v["batch_stats"])
    j_save_checkpoint(path + ".msgpack", params, reg_stats,
                      batch_stats=stats, epoch=0, arch="TinyConv")
    save_checkpoint(path + ".pt", state_dict_from_jax(params, stats),
                    reg_stats, arch="TinyConv", epoch=0)


def _compare(jax_ckpt, port_ckpt):
    j = j_load_checkpoint(jax_ckpt)
    want = state_dict_from_jax(j["params"], j["batch_stats"])
    t = load_checkpoint(port_ckpt)
    got = t["state_dict"]
    assert set(got) == set(want)
    assert t["epoch"] == int(j["epoch"]) == 1
    for k, w in want.items():
        if not w.is_floating_point():
            continue
        err = (got[k] - w).abs().max().item()
        assert err <= 1e-4 * w.abs().max().item(), (k, err)
    np.testing.assert_allclose(t["best_loss"], float(j["best_loss"]),
                               rtol=1e-5)
    return t


def test_ssn_train_cli_matches_jax_cli(workdir, monkeypatch):
    monkeypatch.chdir(workdir)
    reg = np.asarray([[0.01, -0.02], [0.1, 0.2]])
    _start(JSSN(num_class=20, base_model="TinyConv", dropout=0.0),
           (jnp.zeros((1, 9, 32, 32, 3)), jnp.ones((1, 2))), "start", reg)
    args = ["thumos14", "RGB", *COMMON, "-b", "2", "--tem", "2",
            "--prop_file_dir", str(workdir), "--clip-gradient", "40"]
    j_ssn_train(args + ["--resume", "start.msgpack", "--gpus", "0",
                        "--snapshot_pref", "jax"])
    stats = ssn_train.main(args + ["--resume", "start.pt", "--device", "cpu",
                                   "--snapshot_pref", "port"])
    assert len(stats.step_ms) == 3 and stats.images == 2 * 8 * 9
    t = _compare("ssnjax_thumos14_TinyConv_rgb_checkpoint.msgpack",
                 "ssnport_thumos14_TinyConv_rgb_checkpoint.pt")
    assert t["best_loss"] == stats.val_losses[-1]
    assert os.path.exists("ssnport_thumos14_TinyConv_rgb_model_best.pt")

    res = ssn_test.main(["thumos14", "RGB",
                         "ssnport_thumos14_TinyConv_rgb_checkpoint.pt",
                         "scores.pkl", "--arch", "TinyConv",
                         "--synthetic_data", "--prop_file_dir", str(workdir),
                         "--device", "cpu", "--frame_interval", "30",
                         "--test_batchsize", "8"])
    with open("scores.pkl", "rb") as f:
        scores = pickle.load(f)
    assert len(res) == len(scores) == 2
    for rel, act, comp, reg_out in scores.values():
        assert act.shape[1] == 21 and reg_out.shape[1:] == (20, 2)
        assert np.isfinite(act).all() and np.isfinite(reg_out).all()


def test_ssn_train_cli_matches_jax_cli_on_jpeg_frames(workdir, monkeypatch):
    """One ``ssn_train`` step on JPEG frame directories (``--data_root``,
    links to the committed fixtures; the TSN multi-scale augmentation on
    real pixels): the port's decoder against PIL under the JAX CLI, the
    checkpoints within 1e-4 of each tensor's largest value."""
    from tests.test_torch_port_jpeg import link_frames

    monkeypatch.chdir(workdir)
    root = str(workdir / "frames")
    if not os.path.isdir(root):
        for vid in ("video_0", "video_1", "video_2"):
            link_frames(root, vid, 600, "RGB")
    reg = np.asarray([[0.01, -0.02], [0.1, 0.2]])
    _start(JSSN(num_class=20, base_model="TinyConv", dropout=0.0),
           (jnp.zeros((1, 9, 32, 32, 3)), jnp.ones((1, 2))), "jstart", reg)
    common = [c for c in COMMON if c != "--synthetic_data"]
    args = ["thumos14", "RGB", *common, "--data_root", root, "-b", "2",
            "--tem", "1", "--prop_file_dir", str(workdir), "--clip-gradient",
            "40"]
    j_ssn_train(args + ["--resume", "jstart.msgpack", "--gpus", "0",
                        "--snapshot_pref", "jaxjpeg"])
    stats = ssn_train.main(args + ["--resume", "jstart.pt", "--device",
                                   "cpu", "--snapshot_pref", "portjpeg"])
    assert len(stats.step_ms) == 1 and stats.images == 2 * 8 * 9
    _compare("ssnjaxjpeg_thumos14_TinyConv_rgb_checkpoint.msgpack",
             "ssnportjpeg_thumos14_TinyConv_rgb_checkpoint.pt")


def test_ssn_train_evaluate_and_resume_epoch(workdir, monkeypatch, capsys):
    """--evaluate validates and writes nothing; --resume starts at the saved
    epoch: no step is left of --epochs 1, one epoch (of one step, at --tem
    1) of --epochs 2, which keeps the smaller best_loss."""
    monkeypatch.chdir(workdir)
    base = ["thumos14", "RGB", *COMMON, "-b", "2", "--tem", "1",
            "--prop_file_dir", str(workdir), "--device", "cpu"]
    first = ssn_train.main(base + ["--snapshot_pref", "re"])
    ckpt = "ssnre_thumos14_TinyConv_rgb_checkpoint.pt"
    assert len(first.step_ms) == 1 and load_checkpoint(ckpt)["epoch"] == 1
    stats = ssn_train.main(base + ["--evaluate", "--resume", ckpt,
                                   "--snapshot_pref", "ev"])
    assert len(stats.val_losses) == 1 and not stats.step_ms
    assert not os.path.exists("ssnev_thumos14_TinyConv_rgb_checkpoint.pt")
    capsys.readouterr()
    stats = ssn_train.main(base + ["--resume", ckpt, "--snapshot_pref", "re"])
    assert "(epoch 1)" in capsys.readouterr().out and not stats.step_ms
    stats = ssn_train.main(base + ["--resume", ckpt, "--epochs", "2",
                                   "--snapshot_pref", "re"])
    assert len(stats.step_ms) == 1
    ck = load_checkpoint(ckpt)
    assert ck["epoch"] == 2
    assert ck["best_loss"] == min(first.best_loss, stats.val_losses[-1])


def test_binary_train_cli_matches_jax_cli(workdir, monkeypatch):
    monkeypatch.chdir(workdir)
    _start(JBinary(num_class=2, base_model="TinyConv", dropout=0.0),
           (jnp.zeros((1, 5, 32, 32, 3)),), "bstart", np.zeros((2, 2)))
    args = ["thumos14", "RGB", *COMMON, "-b", "2",
            "--prop_file_dir", str(workdir)]
    j_binary_train(args + ["--resume", "bstart.msgpack", "--gpus", "0",
                           "--snapshot_pref", "jax"])
    stats = binary_train.main(args + ["--resume", "bstart.pt", "--device",
                                      "cpu", "--snapshot_pref", "port"])
    assert len(stats.step_ms) == 1 and stats.images == 2 * 12 * 5
    ckpt = "ssnport_thumos14_TinyConv_rgb_binary_checkpoint.pt"
    _compare("ssnjax_thumos14_TinyConv_rgb_binary_checkpoint.msgpack", ckpt)
    act = binary_test.main(["thumos14", "RGB", "testing", ckpt, "act.pkl",
                            "--arch", "TinyConv", "--synthetic_data",
                            "--prop_file_dir", str(workdir), "--device",
                            "cpu", "--frame_interval", "30",
                            "--test_batchsize", "8"])
    assert sorted(act) == ["video_0", "video_1"]
    assert all(a.shape[1:] == (10, 2) and np.isfinite(a).all()
               for a in act.values())


@pytest.mark.parametrize("cli,arch,flags", [
    (ssn_train, "resnet18", ["--remat"]), (binary_train, "resnet18",
                                           ["--bf16"]),
    (ssn_train, "vgg11", []), (binary_train, "vgg11", ["--bf16"])])
def test_training_clis_train_resnet_and_vgg(tmp_path, monkeypatch, cli, arch,
                                            flags):
    """``--arch resnet18``/``vgg11`` at 224^2, one step of one video (3
    segments a proposal), validation, a checkpoint whose state dict is the
    model's (f32, ``--bf16``, ``--remat``)."""
    from action_detection_torch.models import SSN, BinaryClassifier

    monkeypatch.chdir(tmp_path)
    for task in ("tag", "sw"):
        write_proposal_list(tmp_path / f"thumos14_{task}_val_proposal_list.txt",
                            n_videos=1)
        write_proposal_list(
            tmp_path / f"thumos14_{task}_test_proposal_list.txt",
            n_videos=1, seed=7)
    stats = cli.main(["thumos14", "RGB", "--arch", arch, "--synthetic_data",
                      "--dropout", "0", "-j", "1", "--epochs", "1", "-b", "1",
                      "--tem", "1", "--num_body_segments", "1",
                      "--num_aug_segments", "1", "--prop_file_dir",
                      str(tmp_path), "--device", "cpu"] + flags)
    assert len(stats.step_ms) == 1 and np.isfinite(stats.best_loss)
    binary = cli is binary_train
    ck = load_checkpoint(f"ssn_thumos14_{arch}_rgb"
                         f"{'_binary' if binary else ''}_checkpoint.pt")
    model = (BinaryClassifier(num_class=2, base_model=arch) if binary
             else SSN(num_class=20, base_model=arch))
    assert set(ck["state_dict"]) == set(model.state_dict())
    assert ck["arch"] == arch and ck["epoch"] == 1


@pytest.mark.parametrize("cli", [ssn_train, binary_train])
@pytest.mark.parametrize("extra,error,item", [
    pytest.param(["RGB", "--gpus", "0", "1"], ValueError,
                 r"device indices \[1\] out of range: 1 local devices",
                 id="extra0-Data parallel"),
    pytest.param(["RGB", "--coordinator_address", "localhost:1234"],
                 SystemExit, "the multi-host flags go together",
                 id="extra1-Data parallel"),
    pytest.param(["RGB", "--num_processes", "2", "--process_id", "0"],
                 SystemExit, "the multi-host flags go together",
                 id="extra2-Data parallel"),
])
def test_training_refusals_name_their_item(cli, extra, error, item):
    """The data-parallel flags the training CLIs refuse, before any data is
    read: several ``--gpus`` where the device (the CPU) is one (the JAX
    package's ``select_devices`` error), and a multi-host flag without the
    other two."""
    with pytest.raises(error, match=item):
        cli.main(["thumos14", *extra, "--device", "cpu"])


@pytest.mark.parametrize("cli", [ssn_train, binary_train])
def test_training_on_cuda_without_a_card_raises(cli, monkeypatch, workdir):
    """The default --device cuda on a machine whose torch sees no card is
    an error, never a run on the CPU."""
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["thumos14", "RGB", "--arch", "TinyConv",
                  "--synthetic_data", "--prop_file_dir", str(workdir)])


def test_ssn_train_trace_dir_writes_a_profile(workdir, monkeypatch):
    """--trace_dir traces the second step of the first epoch with
    torch.profiler (a chrome trace and a kernel table) and times it like
    the others."""
    monkeypatch.chdir(workdir)
    stats = ssn_train.main(["thumos14", "RGB", *COMMON, "-b", "2", "--tem",
                            "2", "--prop_file_dir", str(workdir), "--device",
                            "cpu", "--trace_dir", "trace",
                            "--snapshot_pref", "tr"])
    assert len(stats.step_ms) == 3
    assert os.path.getsize(os.path.join("trace", "trace.json")) > 0
    with open(os.path.join("trace", "kernels.txt")) as f:
        assert "conv" in f.read()
