"""Port parity, the RGBDiff modality (TSN's third: the differences of
``new_length + 1 = 6`` consecutive RGB frames, 15 channels into the first
conv): ``rgb_diff``, ``preprocess_frames``, ``device_normed_pair`` and
``device_oversample_normed`` bit-exact against the JAX package, an RGBDiff
training batch bit-exact, the RGB -> RGBDiff first-conv init, the frame
template (``img_``, not the flow files), the TinyConv ``ssn_train`` and
``binary_train`` RGBDiff epochs against the JAX CLIs (1e-4 of each
tensor's largest value), and the int8-e2e shared-stem RGBDiff scorer
against the JAX scorer (0.12 of the largest fused score)."""

import argparse

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from action_detection_tpu.cli.binary_train import main as j_binary_train
from action_detection_tpu.cli.ssn_train import main as j_ssn_train
from action_detection_tpu.data import pipeline as jpipe
from action_detection_tpu.data import transforms as jtr
from action_detection_tpu.data.ssn_dataset import SSNDataset as JSSNDataset
from action_detection_tpu.config import SamplingConfig as JSamplingConfig
from action_detection_tpu.infer.scorer import ProposalScorer as JScorer
from action_detection_tpu.models import SSN as JSSN
from action_detection_tpu.models import BinaryClassifier as JBinary
from action_detection_tpu.models import jitted_init
from action_detection_tpu.models.backbones import InputSpec as JInputSpec
from action_detection_tpu.models.convert import (
    convert_first_conv_cross_modality)

from action_detection_torch.cli import (binary_test, binary_train, ssn_test,
                                        ssn_train)
from action_detection_torch.cli.train_common import frame_provider
from action_detection_torch.config import SamplingConfig
from action_detection_torch.data import pipeline, transforms
from action_detection_torch.data.ssn_dataset import SSNDataset
from action_detection_torch.infer.scorer import ProposalScorer
from action_detection_torch.models import (SSN, BinaryClassifier,
                                           seeded_init, state_dict_from_jax)
from action_detection_torch.models.backbones import InputSpec
from action_detection_torch.train import save_checkpoint
from action_detection_torch.train.init_weights import load_backbone_weights

from tests.test_datasets import write_proposal_list
from tests.test_torch_port_int8 import _jitter
from tests.test_torch_port_perlayer import one_torch_thread  # noqa: F401
from tests.test_torch_port_train_cli import COMMON, _compare, _start

SPECS = {  # BNInception's (BGR roll, no division) and torchvision's
    "caffe": ((104.0, 117.0, 128.0), (1.0,), True, False),
    "torchvision": ((0.485, 0.456, 0.406), (0.229, 0.224, 0.225), False,
                    True)}


def _specs(name, size=16):
    mean, std, bgr, div255 = SPECS[name]
    return (InputSpec(size, mean, std, bgr, div255),
            JInputSpec(size, mean, std, bgr, div255))


def test_rgb_diff_bit_exact():
    x = np.random.RandomState(0).randn(2, 5, 7, 18).astype(np.float32)
    got = transforms.rgb_diff(torch.from_numpy(x), 5)
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jtr.rgb_diff(jnp.asarray(x), 5)))
    assert got.shape == (2, 5, 7, 15)
    with pytest.raises(ValueError, match="needs 6"):
        transforms.rgb_diff(torch.from_numpy(x[..., :15]), 5)


def _bits(a) -> np.ndarray:
    """A torch tensor or a JAX array as numpy, bf16 as its int16 bits."""
    if isinstance(a, torch.Tensor):
        return (a.view(torch.int16) if a.dtype == torch.bfloat16
                else a).numpy()
    a = np.asarray(a)
    return a.view(np.int16) if a.dtype == jnp.bfloat16 else a


@pytest.mark.parametrize("spec", sorted(SPECS))
@pytest.mark.parametrize("dtype", [(torch.float32, None),
                                   (torch.bfloat16, jnp.bfloat16)])
def test_rgbdiff_preprocess_and_oversample_bit_exact(spec, dtype):
    """The BGR roll per 3-channel image over the 18 raw channels, then the
    differences: ``preprocess_frames`` and the device 10-crop (flips never
    invert RGBDiff), in float32 and bf16; the shared stem's pair is the
    15-channel difference tensor twice."""
    ours, ref = _specs(spec)
    tdt, jdt = dtype
    frames = np.random.RandomState(3).randint(0, 256, (3, 24, 30, 18),
                                              dtype=np.uint8)
    tf, jf = torch.from_numpy(frames), jnp.asarray(frames)
    got = transforms.preprocess_frames(tf, ours, "RGBDiff", 5, dtype=tdt)
    assert got.shape == (3, 24, 30, 15)
    np.testing.assert_array_equal(_bits(got), _bits(jtr.preprocess_frames(
        jf, ref, "RGBDiff", 5, dtype=jdt)))
    got = transforms.device_oversample_normed(tf, ours, "RGBDiff", 5,
                                              dtype=tdt)
    assert got.shape == (30, 16, 16, 15)
    np.testing.assert_array_equal(_bits(got), _bits(
        jtr.device_oversample_normed(jf, ref, "RGBDiff", 5, dtype=jdt)))
    xn, flip_src = transforms.device_normed_pair(tf, ours, "RGBDiff", 5)
    assert xn.shape[-1] == 15 and flip_src is xn


def test_rgbdiff_training_batch_bit_exact(tmp_path):
    """The RGBDiff training augmentation (multi-scale crop at 1, .875, .75,
    a flip that inverts nothing) on 6-frame segments: the uint8 batch and
    its device preprocessing equal the JAX package's."""
    pf = write_proposal_list(tmp_path / "p.txt")
    kw = dict(body_seg=1, aug_seg=1, new_length=5)
    jb = jpipe.assemble_train_batch(
        JSSNDataset(pf, JSamplingConfig(), **kw), [0, 1],
        jpipe.SyntheticFrameProvider(48, 40, modality="RGBDiff"),
        jtr.get_train_augmentation(32, "RGBDiff"), np.random.RandomState(7))
    tb = pipeline.assemble_train_batch(
        SSNDataset(pf, SamplingConfig(), **kw), [0, 1],
        pipeline.SyntheticFrameProvider(48, 40, modality="RGBDiff"),
        transforms.get_train_augmentation(32, "RGBDiff"),
        np.random.RandomState(7))
    assert tb["frames"].shape == (16, 3, 32, 32, 18)
    for key in jb:
        np.testing.assert_array_equal(tb[key], jb[key])
    ours, ref = _specs("caffe", 32)
    np.testing.assert_array_equal(
        transforms.preprocess_frames(torch.from_numpy(tb["frames"]), ours,
                                     "RGBDiff", 5).numpy(),
        np.asarray(jtr.preprocess_frames(jnp.asarray(jb["frames"]), ref,
                                         "RGBDiff", 5)))


def test_rgb_to_rgbdiff_first_conv_init(tmp_path):
    """``--init_weights`` of an RGB checkpoint into an RGBDiff model: the
    first conv becomes its channel mean tiled over 15 channels, as the JAX
    package's ``convert_first_conv_cross_modality`` makes it; every other
    weight is copied."""
    rgb = seeded_init(SSN(num_class=20, base_model="TinyConv"), seed=3)
    save_checkpoint(str(tmp_path / "rgb.pt"), rgb.state_dict(), None,
                    arch="TinyConv")
    diff = SSN(num_class=20, base_model="TinyConv", modality="RGBDiff")
    load_backbone_weights(diff, str(tmp_path / "rgb.pt"))
    w = rgb.base_model.conv1_7x7_s2.weight.detach().numpy()
    want = convert_first_conv_cross_modality(w.transpose(2, 3, 1, 0), 15)
    got = diff.base_model.conv1_7x7_s2.weight.detach().numpy()
    assert got.shape[1] == 15
    np.testing.assert_array_equal(got, want.transpose(3, 2, 0, 1))
    torch.testing.assert_close(diff.base_model.conv2_3x3.weight,
                               rgb.base_model.conv2_3x3.weight)


class _Recorded(Exception):
    pass


@pytest.mark.parametrize("cli", ["ssn_test", "binary_test"])
def test_rgbdiff_scoring_reads_rgb_frames(tmp_path, monkeypatch, cli):
    """Without ``--synthetic_data`` RGBDiff reads ``img_NNNNN.jpg``, as
    the JAX CLIs do (not the flow files ``<flow_pref>{x,y}_NNNNN.jpg``)."""
    seen = {}

    def record(root, tmpl, modality):
        seen.update(root=root, tmpl=tmpl, modality=modality)
        raise _Recorded

    monkeypatch.setattr(pipeline, "DirectoryFrameProvider", record)
    model = (SSN(num_class=20, base_model="TinyConv", modality="RGBDiff")
             if cli == "ssn_test" else
             BinaryClassifier(base_model="TinyConv", modality="RGBDiff"))
    save_checkpoint(str(tmp_path / "w.pt"), seeded_init(model).state_dict(),
                    np.zeros((2, 2)), arch="TinyConv")
    write_proposal_list(tmp_path / "thumos14_tag_test_proposal_list.txt",
                        n_videos=1)
    write_proposal_list(tmp_path / "thumos14_sw_test_proposal_list.txt",
                        n_videos=1)
    args = (["thumos14", "RGBDiff"]
            + (["testing"] if cli == "binary_test" else [])
            + [str(tmp_path / "w.pt"), str(tmp_path / "s.pkl"), "--arch",
               "TinyConv", "--device", "cpu", "--data_root", "frames",
               "--flow_pref", "flow_", "--prop_file_dir", str(tmp_path)])
    main = ssn_test.main if cli == "ssn_test" else binary_test.main
    with pytest.raises(_Recorded):
        main(args)
    assert seen == dict(root="frames", tmpl="img_{:05d}.jpg",
                        modality="RGBDiff")


@pytest.mark.parametrize("modality,tmpl", [
    ("RGB", "img_{:05d}.jpg"), ("RGBDiff", "img_{:05d}.jpg"),
    ("Flow", "flow_{}_{:05d}.jpg")])
def test_training_frame_template(modality, tmpl):
    provider = frame_provider(argparse.Namespace(
        synthetic_data=False, modality=modality, data_root="frames",
        flow_prefix="flow_"))
    assert provider.image_tmpl == tmpl and provider.modality == modality


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    d = tmp_path_factory.mktemp("rgbdiff_cli")
    for task in ("tag", "sw"):
        write_proposal_list(d / f"thumos14_{task}_val_proposal_list.txt",
                            n_videos=3)
        write_proposal_list(d / f"thumos14_{task}_test_proposal_list.txt",
                            n_videos=2, seed=7)
    return d


def test_ssn_train_rgbdiff_matches_jax_cli(workdir, monkeypatch):
    """One epoch (two steps of two videos, validation) of TinyConv RGBDiff
    from the same start weights: the checkpoints within 1e-4 of each
    tensor's largest value, the validation loss within 1e-5."""
    monkeypatch.chdir(workdir)
    _start(JSSN(num_class=20, base_model="TinyConv", modality="RGBDiff",
                dropout=0.0),
           (jnp.zeros((1, 9, 32, 32, 15)), jnp.ones((1, 2))), "dstart",
           np.asarray([[0.01, -0.02], [0.1, 0.2]]))
    args = ["thumos14", "RGBDiff", *COMMON, "-b", "2", "--tem", "2",
            "--prop_file_dir", str(workdir), "--clip-gradient", "40"]
    j_ssn_train(args + ["--resume", "dstart.msgpack", "--gpus", "0",
                        "--snapshot_pref", "jax"])
    stats = ssn_train.main(args + ["--resume", "dstart.pt", "--device",
                                   "cpu", "--snapshot_pref", "port"])
    assert len(stats.step_ms) == 3
    _compare("ssnjax_thumos14_TinyConv_rgbdiff_checkpoint.msgpack",
             "ssnport_thumos14_TinyConv_rgbdiff_checkpoint.pt")


def test_binary_train_rgbdiff_matches_jax_cli(workdir, monkeypatch):
    monkeypatch.chdir(workdir)
    _start(JBinary(num_class=2, base_model="TinyConv", modality="RGBDiff",
                   dropout=0.0),
           (jnp.zeros((1, 5, 32, 32, 15)),), "dbstart", np.zeros((2, 2)))
    args = ["thumos14", "RGBDiff", *COMMON, "-b", "2",
            "--prop_file_dir", str(workdir)]
    j_binary_train(args + ["--resume", "dbstart.msgpack", "--gpus", "0",
                           "--snapshot_pref", "jax"])
    stats = binary_train.main(args + ["--resume", "dbstart.pt", "--device",
                                      "cpu", "--snapshot_pref", "port"])
    assert len(stats.step_ms) == 1
    _compare("ssnjax_thumos14_TinyConv_rgbdiff_binary_checkpoint.msgpack",
             "ssnport_thumos14_TinyConv_rgbdiff_binary_checkpoint.pt")


def test_rgbdiff_int8_sharedstem_scorer_matches_jax(tmp_path):
    """The scoring default for RGBDiff (BNInception at 64^2, int8-e2e, the
    bf16 stem once per frame and flip on the 15-channel differences): the
    port's fused frame scores of one chunk within 0.12 of the JAX
    scorer's largest, from the same seeded weights and calibration
    frames."""
    model = JSSN(num_class=5, base_model="BNInception", modality="RGBDiff",
                 dropout=0.0)
    v = _jitter(jitted_init(model, {"params": jax.random.PRNGKey(2)},
                            jnp.zeros((1, 9, 64, 64, 15)), jnp.ones((1, 2)),
                            train=False), seed=2)
    params = jax.device_get(v["params"])
    stats = jax.device_get(v["batch_stats"])
    ours, ref = _specs("caffe", 64)
    rng = np.random.RandomState(4)
    frames = rng.randint(0, 256, (4, 73, 97, 18), dtype=np.uint8)
    # neighbouring frames that differ a little, as in a video
    frames[..., 3:] = np.clip(frames[..., :3].astype(np.int16).repeat(5, -1)
                              + rng.randint(-20, 21, (4, 73, 97, 15)),
                              0, 255).astype(np.uint8)
    calib = frames[:2, 4:68, 16:80]
    reg = np.ones((2, 2), np.float32)
    jscorer = JScorer(model, params, stats, ref, reg_stats=reg, num_class=5,
                      chunk_frames=4, modality="RGBDiff", quantize="e2e",
                      calibration_frames=calib, shared_stem=True)
    want = np.asarray(jscorer._score_chunk(jnp.asarray(frames), n_stacks=4))
    jscorer.close()
    tmodel = SSN(num_class=5, base_model="BNInception", modality="RGBDiff",
                 dropout=0.0)
    tmodel.load_state_dict(state_dict_from_jax(params, stats))
    with ProposalScorer(tmodel, ours, reg_stats=reg, num_class=5,
                        chunk_frames=4, modality="RGBDiff", device="cpu",
                        quantize="e2e", calibration_frames=calib,
                        shared_stem=True) as scorer:
        assert scorer.shared_stem
        got = scorer._score_chunk(torch.from_numpy(frames), 4).numpy()
    delta = np.abs(got - want).max() / np.abs(want).max()
    print(f"RGBDiff int8-e2e shared-stem fused scores, port vs JAX: max "
          f"delta {delta:.5f} of the largest")
    assert got.shape == want.shape and delta < 0.12
