"""Port parity, TAG proposals and the host CLIs: ``data/video_db.py`` on the
fixtures of tests/test_video_db_and_tag_cli.py, ``ops/tag.py`` against the
JAX package's, and ``gen_sliding_window_proposals``, ``gen_proposal_list``
and ``gen_bottom_up_proposals`` of both packages on the same inputs (among
them the JAX ``binary_test`` pickle): their written lists byte-identical."""

import os
import pickle

import numpy as np
import pytest

from action_detection_tpu.cli import gen_bottom_up_proposals as jax_bu
from action_detection_tpu.cli import gen_proposal_list as jax_pl
from action_detection_tpu.cli import gen_sliding_window_proposals as jax_sw
from action_detection_tpu.data import video_db as jdb
from action_detection_tpu.ops import tag as jtag

from action_detection_torch.cli import gen_bottom_up_proposals as port_bu
from action_detection_torch.cli import gen_proposal_list as port_pl
from action_detection_torch.cli import gen_sliding_window_proposals as port_sw
from action_detection_torch.data import video_db as pdb
from action_detection_torch.kernels import launch_counts, reset_launch_counts
from action_detection_torch.ops import tag as ptag

from tests.test_video_db_and_tag_cli import (make_anet_fixture,
                                             make_thumos_fixture)


def _videos(videos):
    return [(v.id, v.duration, v.subset, v.url, v.path,
             [(i.label, i.start, i.end, i.video_duration, i.num_label)
              for i in v.instances]) for v in videos]


def test_thumos_db_matches_jax(tmp_path):
    data_dir, frames = make_thumos_fixture(tmp_path)
    db = pdb.THUMOSDB.get_db(14, data_dir=str(data_dir))
    ref = jdb.THUMOSDB.get_db(14, data_dir=str(data_dir))
    assert db.get_ordered_label_list() == ref.get_ordered_label_list()
    assert (db.try_load_file_path(str(frames))
            == ref.try_load_file_path(str(frames)) == 4)
    for subset in ("validation", "test"):
        assert (_videos(db.get_subset_videos(subset))
                == _videos(ref.get_subset_videos(subset)))
        assert len(db.get_subset_instance(subset)) == 4
    with pytest.raises(ValueError):
        db.get_subset_videos("training")
    with pytest.raises(ValueError):
        pdb.THUMOSDB.get_db(13)


def test_anet_db_matches_jax(tmp_path):
    make_anet_fixture(tmp_path)
    db = pdb.ANetDB.get_db("1.2", data_dir=str(tmp_path))
    ref = jdb.ANetDB.get_db("1.2", data_dir=str(tmp_path))
    assert db.version == ref.version
    assert db.get_ordered_label_list() == ref.get_ordered_label_list()
    for subset in ("training", "validation", "testing"):
        assert (_videos(db.get_subset_videos(subset))
                == _videos(ref.get_subset_videos(subset)))
    assert db.get_subset_instance("validation")[0].covering_ratio == \
        ref.get_subset_instance("validation")[0].covering_ratio
    with pytest.raises(ValueError):
        pdb.ANetDB.get_db("1.1", data_dir=str(tmp_path))


@pytest.mark.parametrize("multicrop,bw", [(True, None), (True, 3),
                                          (False, 1.5)])
def test_tag_grouping_matches_jax(multicrop, bw):
    """Frame labels and boxes (with the native search on both sides) equal
    the JAX package's, for 2-way and 100-way score matrices."""
    rng = np.random.RandomState(int(multicrop) + int(bw or 0))
    thresholds = [0.01, 0.05, 0.1, 0.4, 0.5, 0.6, 0.9, 0.95]
    tol = np.array([0.05, 0.1, 0.3, 0.6, 1.0])
    for K in (2, 100):
        T = rng.randint(5, 200)
        shape = (T, 10, K) if multicrop else (T, K)
        mat = rng.randn(*shape)
        mat[T // 4: T // 2, ..., 1] += 3.0
        got = ptag.label_frame_by_threshold(mat, [0], bw=bw,
                                            thresh=thresholds,
                                            multicrop=multicrop)
        ref = jtag.label_frame_by_threshold(mat, [0], bw=bw,
                                            thresh=thresholds,
                                            multicrop=multicrop)
        assert len(got) == len(ref) == len(thresholds)
        for (c, lab, sc), (rc, rlab, rsc) in zip(got, ref):
            assert c == rc
            np.testing.assert_array_equal(lab, rlab)
            np.testing.assert_array_equal(sc, rsc)
        boxes = ptag.build_box_by_search(got, tol)
        assert boxes == jtag.build_box_by_search(ref, tol) and boxes


@pytest.mark.parametrize("overlap", [0.4, 0.7])
def test_sliding_windows_match_jax(overlap):
    for duration in (0.5, 1.0, 7.3, 120.0, 211.9):
        for level, step in ((8, 1), (6, 0.5)):
            assert (ptag.gen_exponential_sw_proposal(duration, step, level,
                                                     overlap)
                    == jtag.gen_exponential_sw_proposal(duration, step,
                                                        level, overlap))


def _both(jax_main, port_main, argv, out_name, tmp_path, monkeypatch,
          capsys):
    """Run both CLIs, each in its own directory; return the two written
    files' bytes and the two stdouts."""
    res = {}
    for name, main in (("jax", jax_main), ("port", port_main)):
        d = tmp_path / f"run_{name}"
        d.mkdir(exist_ok=True)
        monkeypatch.chdir(d)
        main(argv)
        out = capsys.readouterr().out
        path = d / out_name
        res[name] = ((path.read_bytes() if path.exists() else None), out)
    return res["jax"], res["port"]


@pytest.mark.parametrize("subset,flags", [
    ("validation", ["--max_level", "6"]),
    ("testing", []),
    ("testing", ["--overlap", "0.4", "--time_step", "2", "--avoid",
                 "avoid.txt"]),
])
def test_sliding_window_cli_matches_jax(tmp_path, monkeypatch, capsys,
                                        subset, flags):
    data_dir, frames = make_thumos_fixture(tmp_path)
    (tmp_path / "avoid.txt").write_text("video_test_0001\n")
    flags = [str(tmp_path / f) if f == "avoid.txt" else f for f in flags]
    argv = [subset, "rgb", str(frames), "sw.txt", "--dataset", "thumos14",
            "--data_dir", str(data_dir)] + flags
    (ref, ref_out), (got, got_out) = _both(jax_sw.main, port_sw.main, argv,
                                           "sw.txt", tmp_path, monkeypatch,
                                           capsys)
    assert got is not None and got == ref
    assert got_out == ref_out


def test_proposal_list_cli_matches_jax(tmp_path, monkeypatch, capsys):
    """A normalized list denormalized against the fixture's frame folders;
    the missing test list is skipped by both."""
    _, frames = make_thumos_fixture(tmp_path)
    data = tmp_path / "lists"
    data.mkdir()
    rng = np.random.RandomState(4)
    lines = []
    for i, vid in enumerate(("video_validation_0001",
                             "video_validation_0002")):
        gt = np.sort(rng.rand(2, 2), axis=1)
        pr = np.sort(rng.rand(5, 2), axis=1)
        lines.append(f"# {i}\n{vid}\n120.0\n30\n2\n")
        lines += [f"{1 + j} {a:.4f} {b:.4f}\n" for j, (a, b) in enumerate(gt)]
        lines.append("5\n")
        lines += [f"{j % 3} {rng.rand():.4f} {rng.rand():.4f} {a:.4f} "
                  f"{b:.4f}\n" for j, (a, b) in enumerate(pr)]
    (data / "thumos14_tag_val_normalized_proposal_list.txt").write_text(
        "".join(lines))
    out = data / "thumos14_tag_val_proposal_list.txt"
    written = {}
    for name, main in (("jax", jax_pl.main), ("port", port_pl.main)):
        main(["thumos14", str(frames), "--data_dir", str(data)])
        written[name] = out.read_bytes()
        out.unlink()
    assert written["port"] == written["jax"] and written["port"]
    stdout = capsys.readouterr().out
    assert stdout.count("skip ") == 2


def _planted_scores(vids, T=120, crops=1, K=2):
    """Dense actionness with strong foreground on the fixture's GT spans
    (tests/test_video_db_and_tag_cli.py:test_tag_pipeline_end_to_end)."""
    rng = np.random.RandomState(0)
    out = {}
    for i, v in enumerate(vids):
        mat = rng.randn(T, crops, K) * 0.1
        s = 10 + 30 * i
        mat[max(s - 25, 0):s + 40, :, 1] += 1.2
        mat[s:s + 15, :, 1] += 6.0
        out[v] = mat
    return out


@pytest.fixture(scope="module")
def jax_actionness(tmp_path_factory):
    """The JAX pipeline's own actionness pickle: JAX
    gen_sliding_window_proposals -> JAX binary_test (TinyConv, synthetic
    frames) on the fixture's validation videos."""
    from action_detection_tpu.cli.binary_test import main as jax_btest

    from tests.test_torch_port_binary import binary_checkpoints

    d = tmp_path_factory.mktemp("tag_actionness")
    data_dir, frames = make_thumos_fixture(d)
    jax_sw.main(["validation", "rgb", str(frames),
                 str(d / "thumos14_sw_val_proposal_list.txt"), "--dataset",
                 "thumos14", "--data_dir", str(data_dir)])
    jpath, _, _, _ = binary_checkpoints(d)
    jax_btest(["thumos14", "RGB", "validation", jpath,
               str(d / "actionness.pkl"), "--arch", "TinyConv",
               "--synthetic_data", "--prop_file_dir", str(d),
               "--frame_interval", "2", "--test_batchsize", "16"])
    return str(d / "actionness.pkl")


@pytest.mark.parametrize("source,flags", [
    ("jax_binary_test", []),
    ("jax_binary_test", ["--smoothing_bw", "1", "--thresholds", "0.25",
                         "0.27", "0.3", "--tolerances", "0.1", "0.5"]),
    ("planted", ["--minimum_len", "2"]),
    ("planted_two_piles", ["--score_weights", "1", "0.5"]),
])
def test_bottom_up_cli_matches_jax(tmp_path, monkeypatch, capsys,
                                   jax_actionness, source, flags):
    """gen_bottom_up_proposals of both packages on the same pickles write
    byte-identical lists and print the same recall; every video gets
    proposals; the port's search and NMS ran in the C++ library."""
    data_dir, frames = make_thumos_fixture(tmp_path)
    vids = ["video_validation_0001", "video_validation_0002"]
    piles = []
    if source == "jax_binary_test":
        piles = [jax_actionness]
        with open(jax_actionness, "rb") as f:
            assert sorted(pickle.load(f)) == vids
    else:
        for i, crops in enumerate((1, 10)[:1 + (source == "planted_two_piles")]):
            piles.append(str(tmp_path / f"pile{i}.pkl"))
            scores = _planted_scores(vids, T=120 - 20 * i, crops=crops)
            with open(piles[-1], "wb") as f:
                pickle.dump(scores, f)
    argv = piles + ["--dataset", "thumos14", "--subset", "validation",
                    "--data_dir", str(data_dir), "--frame_path", str(frames),
                    "--write_proposals", "tag.txt", "--workers", "1"] + flags
    reset_launch_counts()
    (ref, ref_out), (got, got_out) = _both(jax_bu.main, port_bu.main, argv,
                                           "tag.txt", tmp_path, monkeypatch,
                                           capsys)
    counts = launch_counts()
    assert counts["host_tag_search"] > 0 and counts["host_nms"] == 2
    assert got is not None and got == ref
    assert got_out == ref_out
    from action_detection_torch.data.proposal_io import load_proposal_file

    groups = load_proposal_file(str(tmp_path / "run_port" / "tag.txt"))
    assert [os.path.basename(g[0]) for g in groups] == vids
    assert all(len(g[3]) > 0 for g in groups)


def test_bottom_up_cli_process_pool_matches_one_worker(tmp_path, monkeypatch,
                                                       capsys):
    """--workers 2 (a spawn pool) writes the list one worker writes."""
    data_dir, frames = make_thumos_fixture(tmp_path)
    with open(tmp_path / "s.pkl", "wb") as f:
        pickle.dump(_planted_scores(["video_test_0001", "video_test_0002"],
                                    crops=10), f)
    monkeypatch.chdir(tmp_path)
    lists = []
    for workers in ("1", "2"):
        port_bu.main([str(tmp_path / "s.pkl"), "--dataset", "thumos14",
                      "--subset", "testing", "--data_dir", str(data_dir),
                      "--frame_path", str(frames), "--write_proposals",
                      f"w{workers}.txt", "--workers", workers])
        lists.append((tmp_path / f"w{workers}.txt").read_bytes())
    assert lists[0] == lists[1] and lists[0]


def test_bottom_up_cli_activitynet_recall_matches_jax(tmp_path, monkeypatch,
                                                      capsys):
    """ActivityNet (no frames, no list): the same recall report from a
    100-way score matrix."""
    make_anet_fixture(tmp_path)
    rng = np.random.RandomState(6)
    mat = rng.randn(80, 10, 100) * 0.1
    mat[5:25, :, 1] += 4.0
    mat[50:70, :, 1] += 4.0
    with open(tmp_path / "anet.pkl", "wb") as f:
        pickle.dump({"v_abc00000002": mat}, f)
    argv = [str(tmp_path / "anet.pkl"), "--dataset", "activitynet",
            "--subset", "validation", "--data_dir", str(tmp_path),
            "--workers", "1"]
    (_, ref_out), (_, got_out) = _both(jax_bu.main, port_bu.main, argv,
                                       "none", tmp_path, monkeypatch, capsys)
    assert got_out == ref_out and "Average Recall" in got_out
