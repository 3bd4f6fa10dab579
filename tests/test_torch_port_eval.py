"""Port parity, host evaluation: the port's metrics, aggregation, detection
evaluation and ``eval_detection_results`` CLI against the JAX package's on
the same numpy-seeded score dicts and ground truth. Both are the same
float64 numpy, so AP arrays, tables and dumps must be exactly equal; the
port's numpy ``video_mean_ap`` and ``mean_class_accuracy`` are held against
scikit-learn, which the JAX package calls."""

import pickle

import numpy as np
import pandas as pd
import pytest

from action_detection_tpu import evaluation as jev
from action_detection_tpu.cli.eval_detection_results import main as jax_eval
from action_detection_tpu.data.video_db import Instance as JInstance
from action_detection_tpu.data.video_db import Video as JVideo
from action_detection_tpu.ops import aggregation as jagg
from action_detection_tpu.ops import metrics as jmetrics

from action_detection_torch import evaluation as pev
from action_detection_torch.cli.eval_detection_results import main as port_eval
from action_detection_torch.data.ssn_dataset import SSNDataset
from action_detection_torch.config import get_configs
from action_detection_torch.ops import aggregation as pagg
from action_detection_torch.ops import metrics as pmetrics

from tests.test_datasets import write_proposal_list

K = 20
FRAMES = 600


def score_dict(seed: int, n_videos: int = 3, P: int = 40, K: int = K):
    """{video_v: (rel_props, act, comp, reg)} with proposals scattered around
    the fixture's GT spans (frames 100-300 and 400-520 of 600) and ties in
    the activity scores."""
    rng = np.random.RandomState(seed)
    out = {}
    for v in range(n_videos):
        centers = rng.choice([200.0, 460.0, 50.0, 560.0], size=P)
        half = rng.uniform(20, 120, size=P)
        rel = np.clip(np.stack([centers - half, centers + half], 1)
                      + rng.randn(P, 2) * 15, 0, FRAMES) / FRAMES
        act = rng.randn(P, K + 1).astype(np.float32)
        act[::7] = act[0]                     # tied rows
        out[f"video_{v}"] = (rel.astype(np.float32), act,
                             rng.randn(P, K).astype(np.float32),
                             (rng.randn(P, K, 2) * 0.1).astype(np.float32))
    return out


@pytest.fixture
def prop_file(tmp_path):
    return write_proposal_list(tmp_path / "thumos14_tag_test_proposal_list.txt",
                               n_videos=3, frames_per_video=FRAMES, seed=7)


def _assert_dets_equal(got, ref):
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        assert list(g) == list(r)
        for vid in r:
            np.testing.assert_array_equal(g[vid], r[vid])


@pytest.mark.parametrize("weights", [None, [1.0, 1.5]])
def test_merge_score_dicts_matches_jax(weights):
    dicts = [score_dict(1), score_dict(2)]
    got = pev.merge_score_dicts(dicts, weights)
    ref = jev.merge_score_dicts(dicts, weights)
    assert list(got) == list(ref)
    for vid in ref:
        for g, r in zip(got[vid], ref[vid]):
            np.testing.assert_array_equal(g, r)


@pytest.mark.parametrize("mode", ["all_class", "top_k", "cls_scores",
                                  "cls_scores_no_softmax"])
def test_generate_nms_regression_and_ap_match_jax(prop_file, mode):
    """Detections in every filter mode, then class-wise NMS, regression and
    the AP sweep: every array exactly equal to the JAX package's."""
    scores = pev.merge_score_dicts([score_dict(3), score_dict(4)], [1, 1.5])
    rng = np.random.RandomState(5)
    kw = {"top_k": 0}
    if mode == "top_k":
        kw = {"top_k": 60}
    elif mode.startswith("cls_scores"):
        # the fixture's GT classes (0-2) lead each video's classifier scores
        kw = {"cls_score_dict": {v: rng.rand(K) + (np.arange(K) < 3)
                                 for v in scores},
              "cls_top_k": 2,
              "softmax_before_filter": mode == "cls_scores"}
    got = pev.generate_detections(scores, K, **kw)
    ref = jev.generate_detections(scores, K, **kw)
    _assert_dets_equal(got, ref)
    got, ref = pev.apply_classwise_nms(got, 0.2), jev.apply_classwise_nms(ref, 0.2)
    _assert_dets_equal(got, ref)
    got, ref = pev.apply_regression(got), jev.apply_regression(ref)
    _assert_dets_equal(got, ref)

    all_gt = SSNDataset(prop_file, get_configs("thumos14").sampling,
                        verbose=False).get_all_gt()
    iou = np.arange(0.1, 1.0, 0.1)
    ap = pev.evaluate_detections(got, all_gt, K, iou, workers=3)
    ap_ref = jev.evaluate_detections(ref, all_gt, K, iou, workers=3)
    np.testing.assert_array_equal(ap, ap_ref)
    assert ap.shape == (K, 9) and ap.max() > 0
    assert (pev.format_map_table(iou, ap)
            == jev.format_map_table(iou, ap_ref))


def _run_cli(main, argv, workdir, monkeypatch, capsys):
    monkeypatch.chdir(workdir)
    ap = main(argv)
    out = capsys.readouterr().out
    return ap, out[out.index("Detection Performance"):]


@pytest.mark.parametrize("extra", [
    [],
    ["--score_weights", "1", "1.5", "--no_regression"],
    ["--top_k", "50", "--nms_threshold", "0.4", "--softmax_before_filter"],
    ["--cls_scores", "cls.pkl", "--cls_top_k", "3"],
])
def test_eval_cli_matches_jax_cli(tmp_path, monkeypatch, capsys, prop_file,
                                  extra):
    """Both CLIs on the same pickles and list: the same AP array and table,
    the same gt_dump.pc / pred_dump.pc (pandas exists here), the same
    --dump_detections."""
    pkls = []
    for i, seed in enumerate((8, 9)):
        pkls.append(str(tmp_path / f"s{i}.pkl"))
        with open(pkls[-1], "wb") as f:
            pickle.dump(score_dict(seed), f)
    if "--cls_scores" in extra:
        rng = np.random.RandomState(10)
        with open(tmp_path / "cls.pkl", "wb") as f:
            pickle.dump({f"video_{v}".encode(): rng.rand(K) for v in range(3)},
                        f)
        extra = [str(tmp_path / a) if a == "cls.pkl" else a for a in extra]
    runs = {}
    for name, main in (("jax", jax_eval), ("port", port_eval)):
        d = tmp_path / name
        d.mkdir()
        argv = (["thumos14"] + pkls + ["--prop_file_dir", str(tmp_path),
                                       "-j", "2", "--dump_detections",
                                       str(d / "dets.pkl")] + extra)
        runs[name] = _run_cli(main, argv, d, monkeypatch, capsys)
    np.testing.assert_array_equal(runs["port"][0], runs["jax"][0])
    assert runs["port"][1] == runs["jax"][1]
    assert runs["port"][1].count("|") == 2 * (9 + 3)   # 9 IoU columns
    for name in ("gt_dump.pc", "pred_dump.pc"):
        with open(tmp_path / "jax" / name, "rb") as f:
            ref = pickle.load(f)
        with open(tmp_path / "port" / name, "rb") as f:
            got = pickle.load(f)
        assert len(got) == len(ref) == K
        for g, r in zip(got, ref):
            pd.testing.assert_frame_equal(g, r)
    with open(tmp_path / "jax" / "dets.pkl", "rb") as f:
        ref = pickle.load(f)
    with open(tmp_path / "port" / "dets.pkl", "rb") as f:
        _assert_dets_equal(pickle.load(f), ref)


def test_eval_cli_without_pandas_skips_the_dumps(tmp_path, monkeypatch,
                                                 capsys, prop_file):
    """Where pandas does not import, the CLI says so in one line, writes no
    dump and prints the same table."""
    with open(tmp_path / "s.pkl", "wb") as f:
        pickle.dump(score_dict(11), f)
    argv = ["thumos14", str(tmp_path / "s.pkl"), "--prop_file_dir",
            str(tmp_path)]
    ap_ref, table_ref = _run_cli(port_eval, argv, tmp_path, monkeypatch,
                                 capsys)
    (tmp_path / "gt_dump.pc").unlink()
    (tmp_path / "pred_dump.pc").unlink()
    monkeypatch.setitem(__import__("sys").modules, "pandas", None)
    ap = port_eval(argv)
    out = capsys.readouterr().out
    assert "gt_dump.pc and pred_dump.pc skipped" in out
    assert out[out.index("Detection Performance"):] == table_ref
    np.testing.assert_array_equal(ap, ap_ref)
    assert not (tmp_path / "gt_dump.pc").exists()
    assert not (tmp_path / "pred_dump.pc").exists()


def _videos(rng, n, num_class):
    vids = []
    for v in range(n):
        labels = rng.choice(num_class, size=rng.randint(1, 3), replace=False)
        vids.append(JVideo(id=f"v{v}", duration=10.0, subset="validation",
                           instances=[JInstance("x", 0, 1, 10.0, int(c))
                                      for c in labels]))
    return vids


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_video_metrics_match_sklearn(seed):
    """The numpy video_mean_ap and mean_class_accuracy against the JAX
    package's, which call scikit-learn: ties, absent classes, a class only
    in the predictions."""
    rng = np.random.RandomState(seed)
    C = 6
    vids = _videos(rng, 12, C)
    scores = {v.id: np.round(rng.rand(C), 1) for v in vids[:-1]}   # ties
    got = pmetrics.video_mean_ap(scores, vids)
    assert got == pytest.approx(jmetrics.video_mean_ap(scores, vids),
                                rel=1e-12, abs=1e-15)
    labels = rng.randint(0, C - 1, size=30)
    s = rng.randn(30, C)
    with np.errstate(invalid="ignore", divide="ignore"):
        ref = jmetrics.mean_class_accuracy(s, labels)
        got = pmetrics.mean_class_accuracy(s, labels)
    np.testing.assert_allclose(got, ref, rtol=1e-12)
    for k in (1, 3):
        assert (pmetrics.top_k_accuracy(scores, vids, k)
                == jmetrics.top_k_accuracy(scores, vids, k))
    x = rng.randn(5, C)
    np.testing.assert_array_equal(pmetrics.softmax(x, 0.5),
                                  jmetrics.softmax(x, 0.5))


def test_aggregation_matches_jax():
    rng = np.random.RandomState(3)
    s = rng.randn(37, 10, 8)
    for name, args in (("default_aggregation_func", (s,)),
                       ("top_k_aggregation_func", (s, 5)),
                       ("sliding_window_aggregation_func", (s,)),
                       ("tpp_aggregation_func", (np.tile(s, 3), 8))):
        np.testing.assert_array_equal(getattr(pagg, name)(*args),
                                      getattr(jagg, name)(*args))
    other = [rng.randn(8), rng.randn(8)]
    np.testing.assert_array_equal(
        pagg.default_fusion_func(s[0, 0], other, [0.5, 1.5]),
        jagg.default_fusion_func(s[0, 0], other, [0.5, 1.5]))
