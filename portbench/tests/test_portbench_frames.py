"""The traffic at a tiny size: both frame sources hand the program the same
pixels, the frames come in shots, every group holds the mix's lengths, the
seed arranges but does not change the work, and the reference reads the
proposal list to the same test plan as the port."""

import numpy as np

from portbench.harness.traffic import (DecodedFrames, fixture_pixels,
                                       link_frames, make_traffic,
                                       write_proposal_list)

MIX = {"lengths": [31, 43, 60], "proposals": [4, 6, 5], "groups": 2,
       "sequences": 2, "shot_frames": [6, 13], "frames_seed": 9,
       "warmup_frames": 13}


def test_jpeg_and_decoded_sources_agree(tmp_path):
    from action_detection_torch.data.pipeline import DirectoryFrameProvider

    traffic = make_traffic(MIX, 20, 2 ** 40 + 3)
    (tmp_path / "videos").mkdir()
    link_frames(str(tmp_path / "videos"), traffic, str(tmp_path / "cache"))
    # a second run finds the sequences' links made
    again = tmp_path / "again"
    again.mkdir()
    link_frames(str(again), traffic, str(tmp_path / "cache"))
    assert len(list((tmp_path / "cache").iterdir())) == 1
    jpeg = DirectoryFrameProvider(str(again), "img_{:05d}.jpg", "RGB")
    decoded = DecodedFrames(traffic, fixture_pixels())
    for v in traffic.videos[:3] + [traffic.warmup]:
        for idx in range(1, v.frames + 1):
            a, = jpeg.load(v.vid, idx)
            b, = decoded.load(v.vid, idx)
            assert a.dtype == b.dtype == np.uint8
            np.testing.assert_array_equal(a, b)


def test_shots_groups_and_seeds():
    a = make_traffic(MIX, 20, 1)
    b = make_traffic(MIX, 20, 2)
    # the seed arranges the work and never changes it: the same frames,
    # and each length reads the same sequence
    np.testing.assert_array_equal(a.sequences, b.sequences)
    assert sorted((v.frames, v.sequence) for v in a.videos) == \
        sorted((v.frames, v.sequence) for v in b.videos)
    assert [v.vid for v in a.videos] != [v.vid for v in b.videos]
    for t in (a, b):
        groups = t.groups()
        assert len(groups) == 2
        for g in groups:
            assert sorted(t.videos[i].frames for i in g) == \
                sorted(MIX["lengths"])
            assert sorted(len(t.videos[i].props) for i in g) == \
                sorted(MIX["proposals"])
        for seq in t.sequences:
            runs = np.diff(np.flatnonzero(np.diff(seq)))
            assert runs.min() >= 6 and runs.max() <= 13


def test_reference_reads_the_test_plan_of_the_port(tmp_path):
    from action_detection_torch.data.ssn_dataset import SSNDataset
    from portbench.reference.ssn import read_proposal_list, test_plan

    traffic = make_traffic(MIX, 20, 5)
    path = str(tmp_path / "list.txt")
    write_proposal_list(path, traffic.videos)
    ds = SSNDataset(path, new_length=1, test_interval=6)
    plan = read_proposal_list(path)
    assert len(ds.video_list) == len(plan)
    for i in range(len(ds.video_list)):
        s = ds.get_test_sample(i)
        ticks, bounds, scaling = test_plan(*plan[s.video_id], 6)
        np.testing.assert_array_equal(ticks, s.frame_ticks)
        np.testing.assert_array_equal(bounds, s.prop_ticks)
        np.testing.assert_array_equal(scaling, s.prop_scaling)


def test_reference_calibrates_on_the_ports_calibration_frames(tmp_path):
    """The int8 reference picks the frames that the port's scoring
    calibrates on, and cuts and normalizes them to the same crops."""
    import torch

    from action_detection_torch.data.pipeline import (
        collect_calibration_frames, make_test_transform)
    from action_detection_torch.data.ssn_dataset import SSNDataset
    from action_detection_torch.data.transforms import normalize_stack
    from portbench.reference.ssn import (calibration_frames, oversample,
                                         read_proposal_list)

    cfg = {"crop_size": 224, "scale_size": 256, "mean": [104.0, 117.0,
                                                         128.0],
           "std": [1.0, 1.0, 1.0], "bgr": True}
    traffic = make_traffic(dict(MIX, groups=5), 20, 77)
    path = str(tmp_path / "list.txt")
    write_proposal_list(path, traffic.videos + [traffic.warmup])
    provider = DecodedFrames(traffic, fixture_pixels())
    ds = SSNDataset(path, new_length=1, test_interval=6)
    got = collect_calibration_frames(ds, provider,
                                     make_test_transform(224, 256, 10))
    seq_of = {v.vid: traffic.sequences[v.sequence]
              for v in traffic.videos + [traffic.warmup]}
    picks = calibration_frames(read_proposal_list(path), 6)
    assert len(picks) == 8
    crops = oversample(fixture_pixels()[[seq_of[v][t] for v, t in picks]],
                       cfg, "cpu")
    want = normalize_stack(torch.from_numpy(got), cfg["mean"], cfg["std"],
                           bgr=True).permute(0, 3, 1, 2)
    assert torch.equal(crops, want)
