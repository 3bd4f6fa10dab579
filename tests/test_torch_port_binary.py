"""Port parity, dense actionness: ``BinaryDataset`` (test ticks and the
training sampler), ``BinaryClassifier`` with flax weights carried across by
``state_dict_from_jax``, and the ``binary_test`` CLI against the JAX CLI on
the same checkpoints and frames (float TinyConv within 1e-4; BNInception
int8-e2e with the shared stem within the int8 bound of
``check_int8_slice``; the ActivityNet 100-way head), with the plain kernels
in place of K1-K3 on the CPU."""

import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from action_detection_tpu.cli.binary_test import main as jax_main
from action_detection_tpu.data.binary_dataset import BinaryDataset as JBinaryDataset
from action_detection_tpu.models import BinaryClassifier as JBinaryClassifier
from action_detection_tpu.models import jitted_init
from action_detection_tpu.train import save_checkpoint as jax_save

from action_detection_torch.cli.binary_test import main as port_main
from action_detection_torch.data.binary_dataset import BinaryDataset
from action_detection_torch.models import BinaryClassifier, state_dict_from_jax
from action_detection_torch.ops.tag import (build_box_by_search,
                                            label_frame_by_threshold)
from action_detection_torch.train import save_checkpoint

from tests.test_datasets import write_proposal_list
from tests.test_torch_port_int8 import (  # noqa: F401 (fixture)
    _jitter, one_torch_thread)


def append_empty_video(path, vid="video_empty"):
    """A one-frame video with a GT instance: kept by ``exclude_empty``, no
    test ticks."""
    with open(path, "a") as f:
        f.write(f"# 99\n{vid}\n1\n1\n1\n1 0 1\n0\n")


def binary_checkpoints(d, arch="TinyConv", num_class=2, size=32, seed=0,
                       modality="RGB"):
    """A seeded flax BinaryClassifier (jittered BN, an O(1)-logit head) saved
    as the JAX CLI's msgpack and as the port's .pt. Returns both paths and
    the flax trees."""
    c_in = 3 if modality == "RGB" else 10
    model = JBinaryClassifier(num_class=num_class, base_model=arch,
                              modality=modality, dropout=0.0)
    v = _jitter(jitted_init(model, {"params": jax.random.PRNGKey(seed)},
                            jnp.zeros((1, 5, size, size, c_in)), train=False),
                seed=seed)
    params = dict(jax.device_get(v["params"]))
    stats = jax.device_get(v["batch_stats"])
    rng = np.random.RandomState(seed + 1)
    k = np.asarray(params["classifier_fc"]["kernel"])
    params["classifier_fc"] = {
        "kernel": (rng.randn(*k.shape) / np.sqrt(k.shape[0])).astype(np.float32),
        "bias": (0.1 * rng.randn(num_class)).astype(np.float32)}
    jpath, ppath = str(d / "b.msgpack"), str(d / "b.pt")
    jax_save(jpath, params, np.zeros((2, 2)), batch_stats=stats, arch=arch)
    save_checkpoint(ppath, state_dict_from_jax(params, stats), None, arch=arch)
    return jpath, ppath, params, stats


def _load(path):
    with open(path, "rb") as f:
        return pickle.load(f)


def _run_both(d, monkeypatch, args):
    """The JAX and the port ``binary_test`` on the same arguments (the
    port's on the CPU); returns both pickles."""
    monkeypatch.chdir(d)
    jax_main(args[:3] + ["b.msgpack", "j.pkl"] + args[3:])
    port_main(args[:3] + ["b.pt", "p.pkl"] + args[3:] + ["--device", "cpu"])
    ref, got = _load(d / "j.pkl"), _load(d / "p.pkl")
    # the JAX CLI fans videos out over its 8 virtual CPU devices, so its key
    # order varies; the port's follows the list
    assert set(got) == set(ref)
    for vid in ref:
        assert got[vid].shape == ref[vid].shape
        assert got[vid].dtype == np.float32
    return ref, got


def _sampler_fixture(path):
    write_proposal_list(path, n_videos=5, seed=1)
    with open(path, "a") as f:
        # only GT and fg proposals (no bg of its own: the dataset pool,
        # 12 deep, serves), short proposals (sample_duration < 1), and a video
        # without GT (excluded)
        f.write("# 5\nvideo_fg_only\n400\n1\n1\n2 50 200\n2\n"
                "2 0.9000 0.9500 45 205\n2 0.7500 0.9000 60 190\n")
        f.write("# 6\nvideo_short\n300\n1\n1\n1 10 13\n3\n"
                "1 0.8000 0.9000 10 14\n0 0.0000 0.0000 200 203\n"
                "0 0.0000 0.0000 250 290\n")
        f.write("# 7\nvideo_no_gt\n300\n1\n0\n1\n0 0.0000 0.0000 20 90\n")
    append_empty_video(path)
    return str(path)


@pytest.mark.parametrize("dataset", ["thumos14", "activitynet1.2"])
def test_actionness_configs_match_jax(dataset):
    """Every field of the port's actionness constants equals the JAX
    package's dataset_actionness_cfg.yaml (action_detection_tpu/config.py:
    get_actionness_configs)."""
    from dataclasses import asdict

    from action_detection_tpu.config import get_actionness_configs as jax_cfg

    from action_detection_torch.config import get_actionness_configs

    got, ref = get_actionness_configs(dataset), jax_cfg(dataset)
    assert asdict(got) == asdict(ref)
    np.testing.assert_array_equal(got.iou_range, ref.iou_range)
    s, r = got.sampling, ref.sampling
    assert ((s.fg_per_video, s.bg_per_video, s.incomplete_per_video)
            == (r.fg_per_video, r.bg_per_video, r.incomplete_per_video)
            == (3, 9, 0))
    with pytest.raises(ValueError, match="unknown dataset"):
        get_actionness_configs("ucf101")


@pytest.mark.parametrize("new_length,interval", [(1, 5), (5, 6)])
def test_binary_dataset_matches_jax(tmp_path, new_length, interval):
    """Pools, test ticks and seeded training samples exactly equal to the
    JAX package's (one RandomState each, same seed)."""
    pf = _sampler_fixture(tmp_path / "props.txt")
    ds = BinaryDataset(pf, new_length=new_length, test_interval=interval)
    ref = JBinaryDataset(pf, new_length=new_length, test_interval=interval)
    assert [v.id for v in ds.video_list] == [v.id for v in ref.video_list]
    assert "video_no_gt" not in ds.video_dict
    assert len(ds) == len(ref) == 8
    for pool, rpool in ((ds.fg_pool, ref.fg_pool), (ds.bg_pool, ref.bg_pool)):
        assert [(v, p.start_frame, p.end_frame) for v, p in pool] == \
            [(v, p.start_frame, p.end_frame) for v, p in rpool]
    for i in range(len(ds)):
        t, r = ds.get_test_sample(i), ref.get_test_sample(i)
        assert (t.video_id, t.num_frames) == (r.video_id, r.num_frames)
        np.testing.assert_array_equal(t.frame_ticks, r.frame_ticks)
    assert len(ds.get_test_sample(7).frame_ticks) == 0     # the empty video
    for shift in (True, False):
        rng, rrng = np.random.RandomState(3), np.random.RandomState(3)
        for i in range(2 * len(ds)):
            s = ds.get_training_sample(i, rng, random_shift=shift)
            r = ref.get_training_sample(i, rrng, random_shift=shift)
            assert s.video_id == r.video_id
            assert s.frame_video_ids == r.frame_video_ids
            np.testing.assert_array_equal(s.frame_indices, r.frame_indices)
            np.testing.assert_array_equal(s.labels, r.labels)


@pytest.mark.parametrize("modality", ["RGB", "Flow"])
def test_binary_classifier_matches_flax(tmp_path, modality):
    """TinyConv BinaryClassifier, flax weights carried across: the training
    forward (course mean) and the per-frame logits within 1e-4; the flax
    tree maps onto every parameter and buffer of the module."""
    _, _, params, stats = binary_checkpoints(tmp_path, modality=modality)
    model = BinaryClassifier(num_class=2, base_model="TinyConv",
                             modality=modality, dropout=0.0)
    sd = state_dict_from_jax(params, stats)
    assert set(sd) == set(model.state_dict())
    model.load_state_dict(sd)
    model.eval()
    jm = JBinaryClassifier(num_class=2, base_model="TinyConv",
                           modality=modality, dropout=0.0)
    v = {"params": params, "batch_stats": stats}
    c_in = 3 if modality == "RGB" else 10
    x = np.random.RandomState(2).randn(3, 5, 32, 32, c_in).astype(np.float32)
    ref = np.asarray(jm.apply(v, jnp.asarray(x), train=False))
    ref_frames = np.asarray(jm.apply(v, jnp.asarray(x[0]),
                                     method=JBinaryClassifier.score_frames))
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
        got_frames = model.score_frames(torch.from_numpy(x[0])).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4)
    np.testing.assert_allclose(got_frames, ref_frames, rtol=0, atol=1e-4)
    assert np.abs(ref_frames).max() > 0.05


def test_binary_classifier_train_mode_keeps_bn_frozen():
    model = BinaryClassifier(base_model="TinyConv", dropout=0.5).train()
    assert model.training and model.classifier_fc.training
    assert not any(m.training for m in model.base_model.modules()
                   if isinstance(m, torch.nn.BatchNorm2d))
    g = torch.Generator().manual_seed(0)
    out = model(torch.randn(2, 5, 32, 32, 3), generator=g)
    assert out.shape == (2, 2)


@pytest.mark.parametrize("dataset,subset,num_class", [
    ("thumos14", "testing", 2), ("thumos14", "validation", 2),
    ("activitynet1.2", "validation", 100)])
def test_binary_test_cli_float_matches_jax_cli(tmp_path, monkeypatch,
                                               dataset, subset, num_class):
    """TinyConv (float, synthetic frames): per-crop logits within 1e-4 of
    the JAX CLI's, the same keys and (T, 10, K) shapes, an empty video
    included. The ActivityNet head is 100 wide and TAG labeling reads it
    at class column 1, as tests/test_cli_e2e.py checks for JAX."""
    lists = ({"testing": "thumos14_sw_test", "validation": "thumos14_sw_val"}
             if dataset == "thumos14" else
             {"validation": "activitynet1.2_sw_val"})
    path = tmp_path / f"{lists[subset]}_proposal_list.txt"
    write_proposal_list(path, n_videos=2, seed=7)
    append_empty_video(path)
    binary_checkpoints(tmp_path, num_class=num_class)
    ref, got = _run_both(tmp_path, monkeypatch, [
        dataset, "RGB", subset, "--arch", "TinyConv", "--synthetic_data",
        "--prop_file_dir", str(tmp_path), "--frame_interval", "30",
        "--test_batchsize", "8"])
    assert list(got) == ["video_0", "video_1", "video_empty"]
    assert got["video_0"].shape == (20, 10, num_class)
    assert got["video_empty"].shape == (0, 10, num_class)
    for vid in ref:
        np.testing.assert_allclose(got[vid], ref[vid], rtol=0, atol=1e-4)
    assert np.abs(ref["video_0"]).max() > 0.05
    if num_class == 100:
        labeled = label_frame_by_threshold(got["video_0"].mean(axis=1), [0],
                                           bw=3, thresh=[0.005, 0.01],
                                           multicrop=False)
        assert isinstance(build_box_by_search(labeled, np.array([0.0, 0.3])),
                          list)


def test_binary_test_cli_float_matches_jax_cli_on_jpeg_frames(tmp_path,
                                                              monkeypatch):
    """TinyConv (float) on JPEG frame directories (``--data_root``, links
    to the committed fixtures): the port's decoder against PIL under the
    JAX CLI, per-crop logits within 1e-4."""
    from tests.test_torch_port_jpeg import link_frames

    write_proposal_list(tmp_path / "thumos14_sw_test_proposal_list.txt",
                        n_videos=2, seed=7)
    for vid in ("video_0", "video_1"):
        link_frames(str(tmp_path / "frames"), vid, 600, "RGB")
    binary_checkpoints(tmp_path)
    ref, got = _run_both(tmp_path, monkeypatch, [
        "thumos14", "RGB", "testing", "--arch", "TinyConv", "--data_root",
        str(tmp_path / "frames"), "--prop_file_dir", str(tmp_path),
        "--frame_interval", "30", "--test_batchsize", "8"])
    assert list(got) == ["video_0", "video_1"]
    for vid in ref:
        assert got[vid].shape == (20, 10, 2)
        np.testing.assert_allclose(got[vid], ref[vid], rtol=0, atol=1e-4)
    assert np.abs(ref["video_0"]).max() > 0.05


def test_binary_test_cli_int8_sharedstem_matches_jax_cli(tmp_path,
                                                         monkeypatch):
    """BNInception with the CLI defaults (int8-e2e, shared stem, 10 device
    crops) at 64^2 on the color-coded frames of tests/test_int8.py: per-crop
    logits within the int8 bound of check_int8_slice (max |delta| over the
    largest |logit| < 0.12); the same keys and shapes, an empty video
    included."""
    from action_detection_torch.data import pipeline as ppipe
    from action_detection_torch.models import ssn as pssn
    from action_detection_tpu.data import pipeline as jpipe
    from action_detection_tpu.models import backbones as jbackbones

    from tests.test_int8 import ColorCodedProvider, write_detection_fixture
    from tests.test_torch_port_scorer import ArrayProvider

    path = tmp_path / "thumos14_sw_test_proposal_list.txt"
    _, gt_by = write_detection_fixture(str(path), n_videos=2)
    append_empty_video(path)
    gt_by["video_empty"] = []
    binary_checkpoints(tmp_path, arch="BNInception", size=64)

    def small(get):
        def get_small(*a, **kw):
            net, dim, spec = get(*a, **kw)
            return net, dim, spec.__class__(64, spec.mean, spec.std,
                                            spec.bgr, spec.div255)
        return get_small

    monkeypatch.setattr(jbackbones, "get_backbone",
                        small(jbackbones.get_backbone))
    monkeypatch.setattr(pssn, "get_backbone", small(pssn.get_backbone))
    monkeypatch.setattr(jpipe, "SyntheticFrameProvider",
                        lambda modality: ColorCodedProvider(gt_by))
    monkeypatch.setattr(ppipe, "SyntheticFrameProvider",
                        lambda modality: ArrayProvider(
                            ColorCodedProvider(gt_by)))
    ref, got = _run_both(tmp_path, monkeypatch, [
        "thumos14", "RGB", "testing", "--synthetic_data", "--prop_file_dir",
        str(tmp_path), "--frame_interval", "40", "--test_batchsize", "4"])
    assert got["video_0"].shape == (15, 10, 2)
    assert got["video_empty"].shape == (0, 10, 2)
    delta = max(float(np.abs(got[v] - ref[v]).max() / np.abs(ref[v]).max())
                for v in ("video_0", "video_1"))
    print(f"binary_test int8-e2e shared-stem, port vs JAX: max normalized "
          f"per-crop logit delta {delta:.5f}")
    assert delta < 0.12, delta


@pytest.mark.parametrize("flags,named", [
    pytest.param(["Flow", "--devices", "0", "1"],
                 r"device indices \[1\] out of range: 1 local devices",
                 id="flags0-scoring on several devices"),
])
def test_binary_test_refuses_unported_by_name(flags, named):
    """Several ``--devices`` where the device (the CPU) is one: the JAX
    package's ``select_devices`` error, before any weights are read."""
    with pytest.raises(ValueError, match=named):
        port_main(["thumos14", flags[0], "testing", "w.pt", "s.pkl",
                   "--device", "cpu"] + flags[1:])


@pytest.mark.parametrize("flags,error,match", [
    (["--test_crops", "5"], ValueError, "unsupported number of crops 5"),
    (["--shared_stem", "--host_crops"], SystemExit, "--shared_stem requires"),
    (["--shared_stem", "--test_crops", "1"], SystemExit,
     "--shared_stem requires"),
    (["--shared_stem", "--int8_mode", "perlayer"], SystemExit,
     "--shared_stem requires"),
])
def test_binary_test_refuses_what_the_jax_cli_refuses(flags, error, match):
    """A crop count other than 1 or 10 (the JAX CLI's ValueError) and an
    explicit ``--shared_stem`` off its path (int8-e2e, 10 device crops)
    refuse before any weights are read."""
    with pytest.raises(error, match=match):
        port_main(["thumos14", "RGB", "testing", "w.pt", "s.pkl",
                   "--device", "cpu"] + flags)


@pytest.mark.parametrize("arch", ["resnet18", "vgg11"])
def test_binary_test_scores_resnet_and_vgg(tmp_path, capsys, arch):
    """``--arch resnet18``/``vgg11``: no int8 path (the CLI says so), the
    float backbone at 224^2 scores every tick's 10 crops."""
    write_proposal_list(tmp_path / "thumos14_sw_test_proposal_list.txt",
                        n_videos=1)
    torch.manual_seed(0)        # torch's own init: VGG's 133M weights
    model = BinaryClassifier(base_model=arch)
    save_checkpoint(str(tmp_path / "b.pt"), model.state_dict(), None,
                    arch=arch)
    got = port_main(["thumos14", "RGB", "testing", str(tmp_path / "b.pt"),
                     str(tmp_path / "s.pkl"), "--arch", arch,
                     "--synthetic_data", "--prop_file_dir", str(tmp_path),
                     "--frame_interval", "300", "--test_batchsize", "2",
                     "--device", "cpu"])
    assert f"int8 off: no int8 path wired for {arch}" in \
        capsys.readouterr().out
    assert got["video_0"].shape == (2, 10, 2)
    assert np.isfinite(got["video_0"]).all()


@pytest.mark.parametrize("flag,init", [("--use_reference", "ImageNet"),
                                       ("--use_kinetics_reference",
                                        "Kinetics")])
def test_binary_test_use_reference_names_the_missing_file(
        tmp_path, monkeypatch, flag, init):
    """``--use_reference``/``--use_kinetics_reference`` look the published
    checkpoint up in $ADT_MODEL_CACHE and, when it is not there, raise
    naming the path it looked at."""
    from action_detection_torch import config

    monkeypatch.setenv("ADT_MODEL_CACHE", str(tmp_path))
    url = config.get_reference_model_url("thumos14", "RGB", init,
                                         "BNInception")
    path = str(tmp_path / url.rsplit("/", 1)[-1])
    with pytest.raises(FileNotFoundError, match=path.replace(".", r"\.")):
        port_main(["thumos14", "RGB", "testing", "w.pt", "s.pkl", flag,
                   "--device", "cpu"])


def test_binary_test_refuses_pth_ssn_checkpoints_and_missing_cards(
        tmp_path, monkeypatch):
    from action_detection_torch.models import SSN, seeded_init

    write_proposal_list(tmp_path / "thumos14_sw_test_proposal_list.txt",
                        n_videos=1)
    # a reference SSN .pth.tar (the published release has no actionness
    # model) reads, and is refused for its missing head
    ref = seeded_init(SSN(num_class=20, base_model="TinyConv"), seed=1)
    torch.save({"state_dict": {"module." + k: v for k, v in
                               ref.state_dict().items()},
                "reg_stats": np.ones((2, 2), np.float32)},
               str(tmp_path / "w.pth.tar"))
    with pytest.raises(SystemExit, match="not an actionness checkpoint"):
        port_main(["thumos14", "RGB", "testing", str(tmp_path / "w.pth.tar"),
                   str(tmp_path / "s.pkl"), "--arch", "TinyConv",
                   "--prop_file_dir", str(tmp_path), "--device", "cpu"])

    ssn = seeded_init(SSN(num_class=20, base_model="TinyConv"), seed=0)
    save_checkpoint(str(tmp_path / "ssn.pt"), ssn.state_dict(), None,
                    arch="TinyConv")
    args = ["thumos14", "RGB", "testing", str(tmp_path / "ssn.pt"),
            str(tmp_path / "s.pkl"), "--arch", "TinyConv", "--prop_file_dir",
            str(tmp_path)]
    with pytest.raises(SystemExit, match="not an actionness checkpoint"):
        port_main(args + ["--device", "cpu"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_main(args)
