"""Port parity, Flow: 10-channel x/y stacks of new_length 5 through the
int8-e2e shared-stem BNInception scorer (the flow-x inversion of flipped
crops rides in the shared stem's flip source) and through the port's
ssn_test CLI, against the JAX package on the same frames and weights; the
float ResNet and VGG backbones through both CLIs; and the CLI's refusals of
what the port does not cover yet."""

import pytest
import torch

from action_detection_torch.cli.ssn_test import main as port_main

from tests.test_torch_port_scorer import (  # noqa: F401 (fixture)
    check_cli, check_int8_slice, one_torch_thread)


def test_flow_int8_sharedstem_slice_matches_jax(tmp_path):
    """BNInception Flow, int8-e2e with the shared stem, on the color-coded
    detector fixture as flow planes: combined score within 0.12 of the JAX
    scorer's, mAP within 0.005."""
    check_int8_slice(tmp_path, modality="Flow")


def test_ssn_test_flow_cli_matches_jax_cli(tmp_path, monkeypatch):
    """``ssn_test thumos14 Flow --arch TinyConv --no_int8``: the port's
    pickle equals the JAX CLI's within 1e-4."""
    check_cli(tmp_path, monkeypatch, "Flow")


def test_ssn_test_flow_cli_matches_jax_cli_on_jpeg_frames(tmp_path,
                                                          monkeypatch):
    """The same on JPEG x/y frame directories (``--data_root``): the port's
    decoder against PIL under the JAX CLI, within 1e-4."""
    check_cli(tmp_path, monkeypatch, "Flow", data_root=True)


def test_flow_frames_are_read_with_flow_pref(tmp_path, monkeypatch):
    """Without ``--synthetic_data`` the Flow provider reads
    ``<flow_pref>{x,y}_NNNNN.jpg``, as the JAX CLI does."""
    from action_detection_torch.data import pipeline
    from action_detection_torch.models import SSN, seeded_init
    from action_detection_torch.train import save_checkpoint

    from tests.test_datasets import write_proposal_list

    seen = {}

    class Recorder(pipeline.DirectoryFrameProvider):
        def __init__(self, root, image_tmpl, modality):
            seen.update(root=root, tmpl=image_tmpl, modality=modality)
            raise KeyboardInterrupt

    monkeypatch.setattr(pipeline, "DirectoryFrameProvider", Recorder)
    write_proposal_list(tmp_path / "thumos14_tag_test_proposal_list.txt",
                        n_videos=1)
    model = seeded_init(SSN(num_class=20, base_model="TinyConv",
                            modality="Flow"), seed=0)
    save_checkpoint(str(tmp_path / "w.pt"), model.state_dict(), None,
                    arch="TinyConv")
    with pytest.raises(KeyboardInterrupt):
        port_main(["thumos14", "Flow", str(tmp_path / "w.pt"),
                   str(tmp_path / "s.pkl"), "--arch", "TinyConv",
                   "--device", "cpu", "--prop_file_dir", str(tmp_path),
                   "--data_root", "frames", "--flow_pref", "flow_"])
    assert seen == {"root": "frames", "tmpl": "flow_{}_{:05d}.jpg",
                    "modality": "Flow"}


@pytest.mark.parametrize("arch,modality", [("resnet18", "Flow"),
                                           ("vgg11", "RGB")])
def test_ssn_test_scores_resnet_and_vgg_as_the_jax_cli(tmp_path, monkeypatch,
                                                       capsys, arch,
                                                       modality):
    """``--arch resnet18`` (Flow: a 10-channel ``conv1``) and ``vgg11``
    (RGB): no int8 path, so both CLIs print so and score the float backbone
    at 224^2; from one reference-style ``.pth.tar`` the port's pickle is
    within 1e-4 of the JAX CLI's."""
    import pickle

    import numpy as np

    from action_detection_tpu.cli.ssn_test import main as jax_main

    from action_detection_torch.models import SSN

    from tests.test_datasets import write_proposal_list
    from tests.test_torch_port_checkpoints import _reference_pth

    monkeypatch.chdir(tmp_path)
    write_proposal_list(tmp_path / "thumos14_tag_test_proposal_list.txt",
                        n_videos=1, seed=5)
    torch.manual_seed(2)        # torch's own init: VGG's 133M weights
    model = SSN(num_class=20, base_model=arch, modality=modality,
                dropout=0.0)
    _reference_pth("w.pth.tar", model.state_dict(), arch=arch)
    common = ["--arch", arch, "--synthetic_data", "--prop_file_dir",
              str(tmp_path), "--frame_interval", "300", "--test_batchsize",
              "2"]
    port_main(["thumos14", modality, "w.pth.tar", "p.pkl"] + common
              + ["--device", "cpu"])
    jax_main(["thumos14", modality, "w.pth.tar", "j.pkl"] + common
             + ["--devices", "0"])
    assert f"int8 off: no int8 path wired for {arch}" in \
        capsys.readouterr().out
    with open("p.pkl", "rb") as f:
        got = pickle.load(f)
    with open("j.pkl", "rb") as f:
        ref = pickle.load(f)
    assert set(got) == set(ref) == {"video_0"}
    for g, r in zip(got["video_0"], ref["video_0"]):
        assert g.shape == r.shape
        np.testing.assert_allclose(g, r, rtol=0, atol=1e-4)
    assert np.abs(ref["video_0"][1]).max() > 1e-2


@pytest.mark.parametrize("flags,named", [
    pytest.param(["RGB", "--devices", "0", "1"],
                 r"device indices \[1\] out of range: 1 local devices",
                 id="flags1-scoring on several devices"),
])
def test_ssn_test_refuses_unported_by_name(flags, named):
    """Several ``--devices`` where the device (the CPU) is one: the JAX
    package's ``select_devices`` error, before any weights are read."""
    with pytest.raises(ValueError, match=named):
        port_main(["thumos14", flags[0], "w.pt", "s.pkl", "--device", "cpu"]
                  + flags[1:])


@pytest.mark.parametrize("flags,error,match", [
    (["--test_crops", "5"], ValueError, "unsupported number of crops 5"),
    (["--no_int8", "--test_crops", "3"], ValueError,
     "unsupported number of crops 3"),
    (["--shared_stem", "--test_crops", "1"], SystemExit,
     "--shared_stem requires"),
    (["--shared_stem", "--int8_mode", "perlayer"], SystemExit,
     "--shared_stem requires"),
])
def test_ssn_test_refuses_what_the_jax_cli_refuses(flags, error, match):
    """A crop count other than 1 or 10 (the JAX CLI's ValueError, int8 or
    not) and an explicit ``--shared_stem`` off its path refuse before any
    weights are read."""
    with pytest.raises(error, match=match):
        port_main(["thumos14", "RGB", "w.pt", "s.pkl", "--device", "cpu"]
                  + flags)
