"""Port parity, host-crop scoring: ``make_test_transform`` (scale + center
crop at ``--test_crops 1``, the 10-crop oversample at 10) and
``iter_test_frame_batches`` byte-identical with the JAX package's PIL
transforms for RGB, Flow and RGBDiff; the calibration frames at 1 crop;
the ``--test_crops 1`` scorer (float TinyConv through the ``ssn_test``
CLIs within 1e-4; BNInception int8-e2e per crop on the color-coded
detector within 0.12 and mAP 0.005); ``binary_test --host_crops`` and
``--test_crops 1`` pickles against the JAX CLI's; and the port's
device-crop and host-crop 10-crop scores against each other (the JAX
package's tests/test_infer_eval.py:406)."""

import pickle
from dataclasses import astuple

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from action_detection_tpu.cli.ssn_test import main as j_ssn_test
from action_detection_tpu.config import SamplingConfig as JSamplingConfig
from action_detection_tpu.data import pipeline as jpipe
from action_detection_tpu.data.ssn_dataset import SSNDataset as JSSNDataset
from action_detection_tpu.infer.scorer import ProposalScorer as JScorer
from action_detection_tpu.models import SSN as JSSN
from action_detection_tpu.ops.metrics import softmax
from action_detection_tpu.train import save_checkpoint as j_save_checkpoint

from action_detection_torch.cli import ssn_test
from action_detection_torch.config import SamplingConfig
from action_detection_torch.data import pipeline
from action_detection_torch.data.ssn_dataset import SSNDataset
from action_detection_torch.infer.scorer import ProposalScorer
from action_detection_torch.models import SSN, seeded_init, state_dict_from_jax
from action_detection_torch.models.backbones import InputSpec, get_backbone
from action_detection_torch.train import save_checkpoint

from tests.test_datasets import write_proposal_list
from tests.test_int8 import (DET_K, ColorCodedProvider,
                             detection_calibration_frames,
                             write_detection_fixture)
from tests.test_torch_port_binary import (_run_both, append_empty_video,
                                          binary_checkpoints)
from tests.test_torch_port_int8 import _jitter
from tests.test_torch_port_perlayer import one_torch_thread  # noqa: F401
from tests.test_torch_port_scorer import ArrayProvider, _color_detector, _map

NEW_LENGTH = {"RGB": 1, "Flow": 5, "RGBDiff": 5}


@pytest.mark.parametrize("modality", ["RGB", "Flow", "RGBDiff"])
@pytest.mark.parametrize("crops", [1, 10])
def test_test_frame_batches_byte_equal(modality, crops):
    """TinyConv's geometry (32^2 crops at scale size 36) from 80x72 frames,
    so the numpy resize runs: every chunk (7 ticks at 3 a chunk, a tail
    of 1) equal to the JAX package's, crop-major, ``frames_per_segment``
    images a tick."""
    spec = get_backbone("TinyConv", modality)[2]
    nl = NEW_LENGTH[modality]
    ticks = np.arange(1, 70, 10)
    kw = dict(new_length=nl, batch_ticks=3)
    got = list(pipeline.iter_test_frame_batches(
        pipeline.SyntheticFrameProvider(80, 72, modality=modality), "v",
        ticks, 70, pipeline.make_test_transform(spec.input_size,
                                                spec.scale_size, crops),
        **kw))
    ref = list(jpipe.iter_test_frame_batches(
        jpipe.SyntheticFrameProvider(80, 72, modality=modality), "v", ticks,
        70, jpipe.make_test_transform(spec.input_size, spec.scale_size,
                                      crops), **kw))
    c_in = {"RGB": 3, "Flow": 10, "RGBDiff": 18}[modality]
    assert [g.shape for g in got] == [(crops * n, 32, 32, c_in)
                                      for n in (3, 3, 1)]
    for g, r in zip(got, ref):
        assert g.dtype == r.dtype == np.uint8
        np.testing.assert_array_equal(g, r)


def test_unsupported_crop_count_raises_as_in_jax():
    for n in (0, 5):
        with pytest.raises(ValueError, match=f"unsupported number of crops "
                                             f"{n}"):
            pipeline.make_test_transform(224, 256, n)
        with pytest.raises(ValueError, match="unsupported number of crops"):
            jpipe.make_test_transform(224, 256, n)


@pytest.mark.parametrize("modality", ["RGB", "RGBDiff"])
def test_one_crop_calibration_frames_byte_equal(tmp_path, modality):
    """At ``--test_crops 1`` the calibration frames are the first ticks'
    center crops (crop-shaped), as the JAX CLIs collect them."""
    pf = write_proposal_list(tmp_path / "p.txt", n_videos=3, seed=1)
    spec = get_backbone("TinyConv", modality)[2]
    nl = NEW_LENGTH[modality]
    got = pipeline.collect_calibration_frames(
        SSNDataset(pf, test_interval=40, new_length=nl),
        pipeline.SyntheticFrameProvider(80, 72, modality=modality),
        pipeline.make_test_transform(32, spec.scale_size, 1), new_length=nl)
    ref = jpipe.collect_calibration_frames(
        JSSNDataset(pf, JSamplingConfig(), test_interval=40, new_length=nl),
        jpipe.SyntheticFrameProvider(80, 72, modality=modality),
        jpipe.make_test_transform(32, spec.scale_size, 1), new_length=nl)
    assert got.shape == (3, 32, 32, 3 * (nl + (modality == "RGBDiff")))
    np.testing.assert_array_equal(got, ref)


def _ssn_checkpoints(d):
    """A seeded TinyConv SSN (jittered BN, O(1) scores) as the JAX CLI's
    msgpack and the port's .pt."""
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
    reg_stats = np.array([[0.01, -0.02], [0.1, 0.2]], np.float32)
    j_save_checkpoint(str(d / "w.msgpack"), params, reg_stats,
                      batch_stats=stats, arch="TinyConv")
    save_checkpoint(str(d / "w.pt"), state_dict_from_jax(params, stats),
                    reg_stats, arch="TinyConv")


@pytest.mark.parametrize("int8", [[], ["--int8"]])
def test_ssn_test_one_crop_matches_jax_cli(tmp_path, monkeypatch, int8):
    """``ssn_test --test_crops 1`` on TinyConv (float, no int8 path: an
    explicit ``--int8`` refuses in both CLIs), synthetic frames: the
    pickle within 1e-4 of the JAX CLI's."""
    monkeypatch.chdir(tmp_path)
    write_proposal_list(tmp_path / "thumos14_tag_test_proposal_list.txt",
                        n_videos=2, seed=7)
    _ssn_checkpoints(tmp_path)
    common = ["--arch", "TinyConv", "--synthetic_data", "--prop_file_dir",
              str(tmp_path), "--frame_interval", "30", "--test_batchsize",
              "8", "--test_crops", "1"] + int8
    if int8:
        for main, extra in ((j_ssn_test, ["--devices", "0"]),
                            (ssn_test.main, ["--device", "cpu"])):
            with pytest.raises(SystemExit, match="not available for "
                                                 "backbone 'TinyConv'"):
                main(["thumos14", "RGB", "w.pt", "x.pkl"] + common + extra)
        return
    j_ssn_test(["thumos14", "RGB", "w.msgpack", "j.pkl"] + common
               + ["--devices", "0"])
    ssn_test.main(["thumos14", "RGB", "w.pt", "p.pkl"] + common
                  + ["--device", "cpu"])
    with open("j.pkl", "rb") as f:
        ref = pickle.load(f)
    with open("p.pkl", "rb") as f:
        got = pickle.load(f)
    assert set(got) == set(ref) and len(got) == 2
    for vid in ref:
        for g, r in zip(got[vid], ref[vid]):
            assert g.shape == r.shape
            np.testing.assert_allclose(g, r, rtol=0, atol=1e-4)
        assert np.abs(ref[vid][1]).max() > 1e-2


def test_one_crop_int8_scorer_matches_jax(tmp_path):
    """BNInception int8-e2e on host center crops (no shared stem: it is
    tied to 10 device crops), calibrated on crop-shaped frames, on the
    color-coded detector: the combined score within 0.12 of JAX's int8
    scorer's and of the float scorer's, mAP within 0.005.

    The JAX int8 scorer takes a tree calibrated op by op (``jax.jit`` as
    the identity), the semantics the port computes (as in
    ``test_torch_port_int8.py:jax_qe``): at one crop a score is one
    crop's, not a mean of 10, and JAX's jitted calibration alone moves
    JAX's own combined score by 0.127 on this fixture (0.021 at 10 crops),
    while the port is 0.015 from the op-by-op JAX scorer and 0.074 from
    float."""
    from action_detection_tpu.models.backbones.quantize import (
        calibrate_e2e_backbone)

    jmodel, params, batch_stats, small, reg_stats = _color_detector()
    pf, gt_by = write_detection_fixture(str(tmp_path / "p.txt"), n_videos=2)
    calib = detection_calibration_frames(64)
    pil = ColorCodedProvider(gt_by)
    jds = JSSNDataset(pf, JSamplingConfig(), test_interval=40)
    kw = dict(reg_stats=reg_stats, num_class=DET_K, test_crops=1,
              chunk_frames=4)
    real_jit = jax.jit
    jax.jit = lambda f, **_: f
    try:
        tree = calibrate_e2e_backbone(
            "BNInception", params["backbone"], batch_stats["backbone"],
            JScorer(jmodel, params, batch_stats or None, small, **kw)
            ._prep_calibration(jnp.asarray(calib)))
    finally:
        jax.jit = real_jit
    jscorer = JScorer(jmodel, params, batch_stats or None, small,
                      quantize="e2e", prequantized=(tree, None), **kw)
    model = SSN(num_class=DET_K, base_model="BNInception", dropout=0.0)
    model.load_state_dict(state_dict_from_jax(params, batch_stats))
    spec = InputSpec(*astuple(small))
    scorer = ProposalScorer(model, spec, device="cpu", quantize="e2e",
                            calibration_frames=calib, **kw)
    assert not scorer.device_crops and not scorer.shared_stem
    # the float reference: the port's float scorer (its backbone held to
    # flax's in tests/test_torch_port_models.py)
    pfloat = ProposalScorer(model, spec, device="cpu", **kw)
    ds = SSNDataset(pf, SamplingConfig(), test_interval=40)
    ref, flt, got = {}, {}, {}
    with scorer, pfloat:
        for i in range(len(jds.video_list)):
            for out, sc, prov, dset in ((ref, jscorer, pil, jds),
                                        (flt, pfloat, ArrayProvider(pil),
                                         ds),
                                        (got, scorer, ArrayProvider(pil),
                                         ds)):
                o = sc.score_video(dset.get_test_sample(i), prov)
                out[o.video_id] = o.as_tuple()

    def delta(a, b):
        return max(float(np.abs(softmax(a[v][1])[:, 1:] * np.exp(a[v][2])
                                - softmax(b[v][1])[:, 1:] * np.exp(b[v][2])
                                ).max() / (softmax(b[v][1])[:, 1:]
                                           * np.exp(b[v][2])).max())
                   for v in b)

    for vid in ref:
        np.testing.assert_array_equal(got[vid][0], ref[vid][0])
    m_ref, m_got = _map(ref, jds, DET_K), _map(got, jds, DET_K)
    print(f"--test_crops 1 int8-e2e: port vs JAX {delta(got, ref):.5f}, vs "
          f"float {delta(got, flt):.5f}; mAP JAX {m_ref:.4f}, port "
          f"{m_got:.4f}")
    assert delta(got, ref) < 0.12 and delta(got, flt) < 0.12
    assert m_ref > 0.8 and abs(m_got - m_ref) < 0.005, (m_got, m_ref)


@pytest.mark.parametrize("flags,crops", [(["--host_crops"], 10),
                                         (["--test_crops", "1"], 1)])
def test_binary_test_host_crops_matches_jax_cli(tmp_path, monkeypatch,
                                                flags, crops):
    """``binary_test --host_crops`` (10 crops cut on the host) and
    ``--test_crops 1`` on TinyConv (float): per-crop logits within 1e-4 of
    the JAX CLI's, ``(T, crops, 2)``, an empty video included."""
    path = tmp_path / "thumos14_sw_test_proposal_list.txt"
    write_proposal_list(path, n_videos=2, seed=7)
    append_empty_video(path)
    binary_checkpoints(tmp_path)
    ref, got = _run_both(tmp_path, monkeypatch, [
        "thumos14", "RGB", "testing", "--arch", "TinyConv",
        "--synthetic_data", "--prop_file_dir", str(tmp_path),
        "--frame_interval", "30", "--test_batchsize", "8"] + flags)
    assert got["video_0"].shape == (20, crops, 2)
    assert got["video_empty"].shape == (0, crops, 2)
    for vid in ref:
        np.testing.assert_allclose(got[vid], ref[vid], rtol=0, atol=1e-4)
    assert np.abs(ref["video_0"]).max() > 0.05


def test_binary_test_host_crops_int8_matches_jax_cli(tmp_path, monkeypatch):
    """``binary_test --host_crops`` with BNInception int8-e2e (per crop: no
    shared stem off the device crops) at 64^2 on the color-coded frames:
    per-crop logits within 0.12 of the largest of the JAX CLI's."""
    from action_detection_torch.models import ssn as pssn
    from action_detection_tpu.models import backbones as jbackbones

    path = tmp_path / "thumos14_sw_test_proposal_list.txt"
    _, gt_by = write_detection_fixture(str(path), n_videos=2)
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
    monkeypatch.setattr(pipeline, "SyntheticFrameProvider",
                        lambda modality: ArrayProvider(
                            ColorCodedProvider(gt_by)))
    ref, got = _run_both(tmp_path, monkeypatch, [
        "thumos14", "RGB", "testing", "--synthetic_data", "--prop_file_dir",
        str(tmp_path), "--frame_interval", "40", "--test_batchsize", "4",
        "--host_crops"])
    assert got["video_0"].shape == (15, 10, 2)
    delta = max(float(np.abs(got[v] - ref[v]).max() / np.abs(ref[v]).max())
                for v in ref)
    print(f"binary_test --host_crops int8-e2e, port vs JAX: max normalized "
          f"per-crop logit delta {delta:.5f}")
    assert delta < 0.12, delta


@pytest.mark.parametrize("quantize", [False, "e2e", "perlayer"])
def test_device_crops_match_host_crops(tmp_path, quantize):
    """The port's 10 device crops and 10 host crops score the same video
    alike: float TinyConv within 2e-5 (the JAX package's bound), the int8
    BNInception (e2e per crop, and per-layer) bit for bit, since
    normalization commutes exactly with cropping and flipping."""
    arch = "TinyConv" if not quantize else "BNInception"
    model = seeded_init(SSN(num_class=5, base_model=arch, dropout=0.0),
                        seed=1)
    base = model.input_spec
    size = 32 if arch == "TinyConv" else 64
    spec = InputSpec(size, base.mean, base.std, base.bgr, base.div255)
    pf = write_proposal_list(tmp_path / "p.txt", n_videos=2, seed=7)
    ds = SSNDataset(pf, SamplingConfig(), test_interval=60)
    provider = pipeline.SyntheticFrameProvider(97, 73)
    calib = (pipeline.collect_calibration_frames(
        ds, provider, pipeline.make_test_transform(size, spec.scale_size, 10))
        if quantize else None)
    outs = []
    for device_crops in (True, False):
        with ProposalScorer(model, spec, reg_stats=np.ones((2, 2)),
                            num_class=5, chunk_frames=4, device="cpu",
                            quantize=quantize, calibration_frames=calib,
                            device_crops=device_crops) as scorer:
            assert scorer.device_crops == device_crops
            outs.append(scorer.score_video(ds.get_test_sample(1), provider))
    dev, host = outs
    for a, b in ((dev.act_scores, host.act_scores),
                 (dev.comp_scores, host.comp_scores),
                 (dev.reg_scores, host.reg_scores)):
        if quantize:
            np.testing.assert_array_equal(a, b)
        else:
            np.testing.assert_allclose(a, b, rtol=0, atol=2e-5)
    assert np.abs(dev.act_scores).max() > 1e-3
