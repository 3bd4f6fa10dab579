"""Port parity, Flow: 10-channel x/y stacks of new_length 5 through the
int8-e2e shared-stem BNInception scorer (the flow-x inversion of flipped
crops rides in the shared stem's flip source) and through the port's
ssn_test CLI, against the JAX package on the same frames and weights; and
the CLI's refusals of what the port does not cover yet."""

import pytest

from action_detection_torch.cli.ssn_test import main as port_main

from tests.test_torch_port_scorer import check_cli, check_int8_slice


def test_flow_int8_sharedstem_slice_matches_jax(tmp_path):
    """BNInception Flow, int8-e2e with the shared stem, on the color-coded
    detector fixture as flow planes: combined score within 0.12 of the JAX
    scorer's, mAP within 0.005."""
    check_int8_slice(tmp_path, modality="Flow")


def test_ssn_test_flow_cli_matches_jax_cli(tmp_path, monkeypatch):
    """``ssn_test thumos14 Flow --arch TinyConv --no_int8``: the port's
    pickle equals the JAX CLI's within 1e-4."""
    check_cli(tmp_path, monkeypatch, "Flow")


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


@pytest.mark.parametrize("flags,named", [
    (["RGBDiff"], "modality RGBDiff"),
    (["RGB", "--arch", "resnet50"], "backbone resnet50"),
    (["Flow", "--arch", "vgg16"], "backbone vgg16"),
    (["RGB", "--int8_mode", "perlayer"], "--int8_mode perlayer"),
    (["Flow", "--pack"], "--pack"),
    (["RGB", "--devices", "0", "1"], "scoring on several devices"),
])
def test_ssn_test_refuses_unported_by_name(flags, named):
    with pytest.raises(SystemExit, match=named):
        port_main(["thumos14", flags[0], "w.pt", "s.pkl"] + flags[1:])
