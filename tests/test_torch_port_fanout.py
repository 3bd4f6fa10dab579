"""Port parity, scoring over several devices and ``--pack``, on the CPU.

Two CPU "devices" (``["cpu", "cpu"]``) stand for two GPUs: two threads, two
scorers, one queue. The fan-out of ``score_videos`` (int8-e2e shared stem,
lazy calibration on the first chunk, elected once) equals one device
exactly; so do ``score_video_pack`` against per-video scoring (a zero-tick
video, two scale shapes, a partial last chunk), ``binary_test``'s video
queue (``score_actionness``) against one device, and
``make_sharded_frame_scorer`` against the unsplit scorer. Against the JAX
package's fan-out and pack, on the color-coded real-detector fixture of
tests/test_int8.py: the normalized combined score within int8's 0.12 and
mAP within 0.005; float TinyConv scores within 1e-4. The ``ssn_test`` CLI
writes equal pickles with ``--pack`` and ``--no_pack``."""

import pickle
from dataclasses import astuple

import numpy as np
import pytest
import torch

import jax

from action_detection_tpu.config import SamplingConfig as JSamplingConfig
from action_detection_tpu.data.ssn_dataset import SSNDataset as JSSNDataset
from action_detection_tpu.infer.scorer import ProposalScorer as JScorer
from action_detection_tpu.infer.scorer import score_videos as j_score_videos
from action_detection_tpu.ops.metrics import softmax

from action_detection_torch.config import SamplingConfig
from action_detection_torch.data.binary_dataset import BinaryDataset
from action_detection_torch.data.ssn_dataset import SSNDataset
from action_detection_torch.infer.actionness import (ActionnessScorer,
                                                     score_actionness)
from action_detection_torch.infer.features import shared_prequantized
from action_detection_torch.infer.scorer import (ProposalScorer,
                                                 make_sharded_frame_scorer,
                                                 score_videos)
from action_detection_torch.models import (SSN, BinaryClassifier,
                                           seeded_init, state_dict_from_jax)
from action_detection_torch.models.ssn import fuse_test_heads
from action_detection_torch.models.backbones import InputSpec

from tests.test_int8 import (DET_K, ColorCodedProvider,
                             detection_calibration_frames,
                             write_detection_fixture)
from tests.test_torch_port_int8 import one_torch_thread  # noqa: F401
from tests.test_torch_port_scorer import ArrayProvider, _color_detector, _map

CPU2 = ["cpu", "cpu"]


def append_empty_video(path, vid="video_empty"):
    """A one-frame video with one proposal over it: no test ticks."""
    with open(path, "a") as f:
        f.write(f"# 99\n{vid}\n1\n1\n1\n1 0 1\n1\n"
                "0 0.0000 0.0000 0 1\n")


class MixedProvider:
    """The color-coded frames at 72x80 for every video but ``tall``'s, at
    80x72: two scale shapes (73x81 and 81x73 at the 64^2 spec)."""

    modality = "RGB"

    def __init__(self, gt, tall="video_1", pil=False):
        self.wide = ColorCodedProvider(gt, height=72, width=80)
        self.tall = ColorCodedProvider(gt, height=80, width=72)
        self.tall_id, self.pil = tall, pil

    def load(self, vid, idx):
        src = self.tall if vid == self.tall_id else self.wide
        ims = src.load(vid, idx)
        return ims if self.pil else [np.asarray(im) for im in ims]


@pytest.fixture(scope="module")
def detector(tmp_path_factory):
    """The color-coded BNInception detector (64^2), its fixture of three
    videos of 15 ticks (test_interval 40: chunks of 4 leave a partial last
    one) plus a zero-tick video, as flax trees and as the port's SSN."""
    d = tmp_path_factory.mktemp("fanout")
    pf, gt_by = write_detection_fixture(str(d / "p.txt"), n_videos=3)
    append_empty_video(pf)
    gt_by["video_empty"] = []
    jmodel, params, stats, small, reg_stats = _color_detector()
    model = SSN(num_class=DET_K, dropout=0.0)
    model.load_state_dict(state_dict_from_jax(params, stats))
    return dict(pf=pf, gt=gt_by, jmodel=jmodel, params=params, stats=stats,
                jspec=small, spec=InputSpec(*astuple(small)),
                reg_stats=reg_stats, model=model)


def _port_factory(det, calibration=None, chunk=4, **kw):
    def factory(device):
        return ProposalScorer(det["model"], det["spec"],
                              reg_stats=det["reg_stats"], num_class=DET_K,
                              chunk_frames=chunk, device=device,
                              quantize="e2e", shared_stem=True,
                              calibration_frames=calibration, **kw)
    return factory


def _tuples(results):
    return {vid: r.as_tuple() for vid, r in results.items()}


def _assert_equal(got, ref):
    assert set(got) == set(ref)
    for vid in ref:
        for g, r in zip(got[vid], ref[vid]):
            np.testing.assert_array_equal(g, r)


def _combined_delta(got, ref) -> float:
    delta = 0.0
    for vid in ref:
        _, act_r, comp_r, _ = ref[vid]
        _, act_g, comp_g, _ = got[vid]
        if not len(act_r) or not np.abs(act_r).max():
            continue                            # the zero-tick video
        comb_r = softmax(act_r)[:, 1:] * np.exp(comp_r)
        comb_g = softmax(act_g)[:, 1:] * np.exp(comp_g)
        delta = max(delta, float(np.abs(comb_g - comb_r).max()
                                 / comb_r.max()))
    return delta


@pytest.mark.parametrize("pack", [False, True])
def test_fanout_lazy_calibration_equals_one_device(detector, pack):
    """Two scorers on two threads, int8-e2e calibrated lazily: the first
    item calibrates on the main thread and both scorers score with that
    export, so the pickle equals one device's bit for bit (per-video and
    packed). The zero-tick video scores zeros on either path."""
    ds = SSNDataset(detector["pf"], SamplingConfig(), test_interval=40)
    provider = ArrayProvider(ColorCodedProvider(detector["gt"]))
    factory = _port_factory(detector)
    one = score_videos(factory, ds, provider, devices=["cpu"], pack=pack)
    two = score_videos(factory, ds, provider, devices=CPU2, pack=pack)
    assert len(one) == 4
    _assert_equal(_tuples(two), _tuples(one))
    assert not np.abs(one["video_empty"].act_scores).any()


def test_fanout_matches_jax_fanout(detector):
    """The port's two-device lazy-calibration fan-out against the JAX
    package's ``score_videos`` over two virtual devices: combined score
    within int8's 0.12, mAP within 0.005."""
    jds = JSSNDataset(detector["pf"], JSamplingConfig(), test_interval=40)
    pil = ColorCodedProvider(detector["gt"])

    def jfactory(device):
        return JScorer(detector["jmodel"], detector["params"],
                       detector["stats"] or None, detector["jspec"],
                       reg_stats=detector["reg_stats"], num_class=DET_K,
                       test_crops=10, chunk_frames=4, device=device,
                       device_crops=True, quantize="e2e", shared_stem=True)

    ref = _tuples(j_score_videos(jfactory, jds, pil,
                                 devices=jax.devices()[:2]))
    ds = SSNDataset(detector["pf"], SamplingConfig(), test_interval=40)
    got = _tuples(score_videos(_port_factory(detector), ds,
                               ArrayProvider(pil), devices=CPU2))
    assert set(got) == set(ref)
    delta = _combined_delta(got, ref)
    print(f"fan-out, port vs JAX: combined-score delta {delta:.5f}")
    assert delta < 0.12, delta
    m_ref, m_got = _map(ref, jds, DET_K), _map(got, ds, DET_K)
    print(f"mAP: JAX {m_ref:.4f}, port {m_got:.4f}")
    # the lazy calibration sees one video's first chunk, two classes'
    # colors: it under-covers the others (0.72 here, 0.89 in float)
    assert m_ref > 0.5 and abs(m_got - m_ref) < 0.005, (m_got, m_ref)


def test_pack_equals_per_video_int8(detector):
    """``score_video_pack`` over the four videos (two scale shapes, partial
    chunks, the zero-tick video) equals ``score_video`` of each, bit for
    bit, with the raw frame scores; it scores fewer padded ticks."""
    ds = SSNDataset(detector["pf"], SamplingConfig(), test_interval=40)
    provider = MixedProvider(detector["gt"])
    calib = detection_calibration_frames(64)
    samples = [ds.get_test_sample(i) for i in range(len(ds.video_list))]
    with _port_factory(detector, calib)("cpu") as a:
        singles = [a.score_video(s, provider, keep_raw=True)
                   for s in samples]
    with _port_factory(detector, calib)("cpu") as b:
        packed = b.score_video_pack(samples, provider, keep_raw=True)
    assert [o.video_id for o in packed] == [o.video_id for o in singles]
    for p, s in zip(packed, singles):
        for g, r in zip(astuple(p)[1:], astuple(s)[1:]):
            np.testing.assert_array_equal(g, r)
    assert a.real_ticks == b.real_ticks == 45
    # per video 4 chunks of 4 (15 ticks); packed: 30 + 15 ticks of two
    # shapes, 8 + 4 chunks
    assert (a.device_ticks, b.device_ticks) == (48, 48)
    assert packed[3].raw_scores.shape[0] == 0


def test_pack_matches_jax_pack(detector):
    """Int8 ``score_video_pack`` (calibration frames, two scale shapes)
    against the JAX package's: combined score within 0.12, mAP within
    0.005."""
    calib = detection_calibration_frames(64)
    jds = JSSNDataset(detector["pf"], JSamplingConfig(), test_interval=40)
    jscorer = JScorer(detector["jmodel"], detector["params"],
                      detector["stats"] or None, detector["jspec"],
                      reg_stats=detector["reg_stats"], num_class=DET_K,
                      test_crops=10, chunk_frames=4, device_crops=True,
                      quantize="e2e", calibration_frames=calib,
                      shared_stem=True)
    jsamples = [jds.get_test_sample(i) for i in range(len(jds.video_list))]
    ref = {o.video_id: o.as_tuple() for o in jscorer.score_video_pack(
        jsamples, MixedProvider(detector["gt"], pil=True))}
    jscorer.close()
    ds = SSNDataset(detector["pf"], SamplingConfig(), test_interval=40)
    with _port_factory(detector, calib)("cpu") as scorer:
        got = {o.video_id: o.as_tuple() for o in scorer.score_video_pack(
            [ds.get_test_sample(i) for i in range(len(ds.video_list))],
            MixedProvider(detector["gt"]))}
    assert set(got) == set(ref)
    delta = _combined_delta(got, ref)
    print(f"pack, port vs JAX: combined-score delta {delta:.5f}")
    assert delta < 0.12, delta
    m_ref, m_got = _map(ref, jds, DET_K), _map(got, ds, DET_K)
    assert m_ref > 0.8 and abs(m_got - m_ref) < 0.005, (m_got, m_ref)


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    """A seeded flax TinyConv SSN (jittered BN, heads scaled so the scores
    are not ~0) and its port twin, on the color-coded fixture."""
    import jax.numpy as jnp

    from action_detection_tpu.models import SSN as JSSN
    from action_detection_tpu.models import jitted_init

    from tests.test_torch_port_int8 import _jitter

    d = tmp_path_factory.mktemp("tiny")
    pf, gt_by = write_detection_fixture(str(d / "p.txt"), n_videos=3)
    append_empty_video(pf)
    gt_by["video_empty"] = []
    jm = JSSN(num_class=DET_K, base_model="TinyConv", dropout=0.0)
    v = _jitter(jitted_init(jm, {"params": jax.random.PRNGKey(3)},
                            jnp.zeros((1, 9, 32, 32, 3)), jnp.ones((1, 2)),
                            train=False), seed=3)
    params = jax.tree_util.tree_map_with_path(
        lambda p, a: a * 300.0 if p[0].key.endswith("_fc") else a,
        jax.device_get(v["params"]))
    stats = jax.device_get(v["batch_stats"])
    model = SSN(num_class=DET_K, base_model="TinyConv", dropout=0.0)
    model.load_state_dict(state_dict_from_jax(params, stats))
    return dict(pf=pf, gt=gt_by, model=model, jm=jm, params=params,
                stats=stats)


def test_pack_float_matches_per_video_and_jax(tiny):
    """Float TinyConv: ``score_video_pack`` equals ``score_video`` bit for
    bit (two scale shapes, partial chunks, the zero-tick video), and the
    JAX package's ``score_video_pack`` within 1e-4."""
    from action_detection_torch.models.backbones import get_backbone

    from action_detection_tpu.models.backbones import get_backbone as jget

    spec = get_backbone("TinyConv")[2]
    reg = np.array([[0.01, -0.02], [0.1, 0.2]], np.float32)
    ds = SSNDataset(tiny["pf"], SamplingConfig(), test_interval=40)
    samples = [ds.get_test_sample(i) for i in range(len(ds.video_list))]
    provider = MixedProvider(tiny["gt"])
    with ProposalScorer(tiny["model"], spec, reg_stats=reg, num_class=DET_K,
                        chunk_frames=4, device="cpu") as scorer:
        singles = [scorer.score_video(s, provider, keep_raw=True)
                   for s in samples]
        packed = scorer.score_video_pack(samples, provider, keep_raw=True)
    for p, s in zip(packed, singles):
        for g, r in zip(astuple(p)[1:], astuple(s)[1:]):
            np.testing.assert_array_equal(g, r)
    assert np.abs(singles[0].act_scores).max() > 1e-3

    jds = JSSNDataset(tiny["pf"], JSamplingConfig(), test_interval=40)
    jscorer = JScorer(tiny["jm"], tiny["params"], tiny["stats"],
                      jget("TinyConv")[2], reg_stats=reg, num_class=DET_K,
                      test_crops=10, chunk_frames=4, device_crops=True)
    ref = jscorer.score_video_pack(
        [jds.get_test_sample(i) for i in range(len(jds.video_list))],
        MixedProvider(tiny["gt"], pil=True))
    jscorer.close()
    for p, r in zip(packed, ref):
        assert p.video_id == r.video_id
        for g, w in zip(p.as_tuple(), r.as_tuple()):
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-4)


def test_binary_queue_two_devices_equals_one(tmp_path):
    """``binary_test``'s queue (``score_actionness``) over two CPU devices,
    int8-e2e shared stem with the tree calibrated once and placed on each
    scorer (``shared_prequantized``): equal to one device, bit for bit,
    every video keyed by its basename (the zero-tick one empty)."""
    pf, gt_by = write_detection_fixture(str(tmp_path / "b.txt"), n_videos=3)
    append_empty_video(pf)
    ds = BinaryDataset(pf, new_length=1, test_interval=40)
    model = seeded_init(BinaryClassifier(dropout=0.0), seed=5)
    base = model.input_spec
    spec = InputSpec(64, base.mean, base.std, base.bgr, base.div255)
    provider = ArrayProvider(ColorCodedProvider(gt_by))
    calib = detection_calibration_frames(64)
    built = []

    def make(device, prequantized):
        built.append(prequantized)
        return ActionnessScorer(model, spec, chunk_frames=4, device=device,
                                quantize="e2e", calibration_frames=calib,
                                shared_stem=True, prequantized=prequantized)

    runs = [score_actionness(shared_prequantized(make, True), ds, provider,
                             devices=devices)
            for devices in (["cpu"], CPU2)]
    assert built[0] is None and built[1] is None and built[2] is not None
    assert set(runs[0]) == set(runs[1]) == {"video_0", "video_1", "video_2",
                                            "video_empty"}
    for vid, want in runs[0].items():
        np.testing.assert_array_equal(runs[1][vid], want)
    assert runs[0]["video_0"].shape == (15, 10, 2)
    assert runs[0]["video_empty"].shape == (0, 10, 2)


def test_sharded_frame_scorer_equals_unsplit(tiny):
    """One video's 10 frames split over two CPU devices (5 each) and
    gathered on the first: equal to the unsplit float scorer."""
    from action_detection_torch.data.transforms import preprocess_frames
    from action_detection_torch.models.backbones import get_backbone

    spec = get_backbone("TinyConv")[2]
    model = tiny["model"]
    kernel, bias = fuse_test_heads(model, DET_K)
    frames = np.random.RandomState(0).randint(0, 256, (10, 32, 32, 3),
                                              np.uint8)
    score = make_sharded_frame_scorer(model, kernel, bias, spec, CPU2)
    got = score(frames)
    with torch.no_grad():
        want = model.eval().features(preprocess_frames(
            torch.from_numpy(frames), spec)) @ kernel + bias
    assert got.shape == (10, kernel.shape[1])
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_ssn_test_pack_and_no_pack_write_equal_pickles(tmp_path, monkeypatch,
                                                       capsys):
    """The CLI (TinyConv, synthetic frames, float): ``--pack`` and
    ``--no_pack`` pickles are equal, and the packed run scores fewer padded
    ticks (its summary line); several ``--devices`` on the CPU (one device)
    raise JAX's out-of-range ValueError."""
    from tests.test_datasets import write_proposal_list

    from action_detection_torch.cli.ssn_test import main as ssn_test
    from action_detection_torch.train import save_checkpoint

    monkeypatch.chdir(tmp_path)
    write_proposal_list(tmp_path / "thumos14_tag_test_proposal_list.txt",
                        n_videos=3, seed=7)
    model = seeded_init(SSN(num_class=20, base_model="TinyConv",
                            dropout=0.0), seed=4)
    save_checkpoint("w.pt", model.state_dict(), [[0.0, 0.0], [1.0, 1.0]],
                    arch="TinyConv")
    common = ["thumos14", "RGB", "w.pt", "--arch", "TinyConv",
              "--synthetic_data", "--prop_file_dir", str(tmp_path),
              "--frame_interval", "30", "--test_batchsize", "8",
              "--device", "cpu", "-j", "2"]
    ticks = {}
    for mode in ("--pack", "--no_pack"):
        argv = common[:3] + [f"{mode[2:]}.pkl"] + common[3:] + [mode]
        ssn_test(argv)
        line = [ln for ln in capsys.readouterr().out.splitlines()
                if "ticks scored on the device" in ln][0]
        ticks[mode] = int(line.split("; ")[-1].split()[0])
    with open("pack.pkl", "rb") as f:
        packed = pickle.load(f)
    with open("no_pack.pkl", "rb") as f:
        single = pickle.load(f)
    assert set(packed) == set(single) and len(single) == 3
    for vid in single:
        for g, r in zip(packed[vid], single[vid]):
            np.testing.assert_array_equal(g, r)
    # 20 ticks a video: 3 x 24 per video, 64 packed
    assert ticks == {"--pack": 64, "--no_pack": 72}
    with pytest.raises(ValueError, match=r"device indices \[1\] out of "
                                         "range: 1 local devices"):
        ssn_test(common[:3] + ["x.pkl"] + common[3:] + ["--devices", "0",
                                                         "1"])
