"""Port parity, the whole slice: the int8-e2e shared-stem ProposalScorer
against the JAX package's on the color-coded real-detector fixture of
tests/test_int8.py (combined-score and mAP bounds of tests/test_int8.py and
tests/test_sharedstem.py), and the port's ssn_test CLI against the JAX CLI
from the same checkpoint."""

import pickle
from dataclasses import astuple

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from action_detection_tpu.config import SamplingConfig as JSamplingConfig
from action_detection_tpu.data.ssn_dataset import SSNDataset as JSSNDataset
from action_detection_tpu.evaluation import (apply_classwise_nms,
                                             apply_regression,
                                             evaluate_detections,
                                             generate_detections)
from action_detection_tpu.infer.scorer import ProposalScorer as JScorer
from action_detection_tpu.models import SSN as JSSN
from action_detection_tpu.models import jitted_init
from action_detection_tpu.models.backbones import get_backbone as j_get_backbone
from action_detection_tpu.ops.metrics import softmax

from action_detection_torch.config import SamplingConfig
from action_detection_torch.data.ssn_dataset import SSNDataset
from action_detection_torch.infer.scorer import ProposalScorer
from action_detection_torch.models import SSN, state_dict_from_jax
from action_detection_torch.models.backbones import InputSpec

from tests.test_datasets import write_proposal_list
from tests.test_int8 import (DET_K, DET_PAL, ColorCodedProvider,
                             detection_calibration_frames,
                             write_detection_fixture)
from tests.test_torch_port_int8 import (  # noqa: F401 (fixture)
    _jitter, one_torch_thread)


class ArrayProvider:
    """The fixture's frames as the port's providers give them: uint8 arrays."""

    def __init__(self, pil_provider):
        self.pil = pil_provider
        self.modality = pil_provider.modality

    def load(self, vid, idx):
        return [np.asarray(im) for im in self.pil.load(vid, idx)]


def _flow_planes(rgb: np.ndarray) -> np.ndarray:
    """(..., 3) color-coded pixels -> (..., 2) flow planes: x = red, y =
    (green + 2 blue) / 3. Every class keeps its own (x, y) pair under the
    flipped crops' flow-x inversion (x -> 255 - x), so the class means the
    10 crops see stay apart (x = red, y = green would map two classes onto
    near-equal crop means)."""
    rgb = rgb.astype(np.uint16)
    return np.stack([rgb[..., 0], (rgb[..., 1] + 2 * rgb[..., 2]) // 3],
                    axis=-1).astype(np.uint8)


class FlowColorProvider:
    """The color-coded frames as flow planes (:func:`_flow_planes`), PIL
    ``L`` images as the JAX providers give flow frames."""

    modality = "Flow"

    def __init__(self, gt):
        self.rgb = ColorCodedProvider(gt)

    def load(self, vid, idx):
        from PIL import Image

        xy = _flow_planes(np.asarray(self.rgb.load(vid, idx)[0]))
        return [Image.fromarray(np.ascontiguousarray(xy[..., c]), "L")
                for c in (0, 1)]


def _flow_stack(rgb: np.ndarray) -> np.ndarray:
    """(..., 3) color-coded pixels -> (..., 10) flow stacks of new_length 5
    (:func:`_flow_planes` per frame)."""
    return np.concatenate([_flow_planes(rgb)] * 5, axis=-1)


def _color_detector(arch="BNInception", size=64, modality="RGB"):
    """tests/test_int8.build_color_detector for any backbone, crop size and
    modality: a REAL detector without training (the activity head
    interpolates class-mean backbone features; completeness is 2*course -
    start - end). Flow's class means average the plain stacks and the
    flipped ones (flow-x inverted), as the 10 crops do."""
    K = DET_K
    model = JSSN(num_class=K, base_model=arch, modality=modality,
                 dropout=0.0)
    c_in = 3 if modality == "RGB" else 10
    hv = jitted_init(model, {"params": jax.random.PRNGKey(1)},
                     jnp.zeros((1, 9, size, size, c_in)), jnp.ones((1, 2)),
                     train=False)
    params = dict(jax.device_get(hv["params"]))
    batch_stats = dict(jax.device_get(hv.get("batch_stats") or {}))
    backbone, dim, base = j_get_backbone(arch, modality)
    small = base.__class__(size, base.mean, base.std, base.bgr, base.div255)
    bvars = {"params": params["backbone"]}
    if "backbone" in batch_stats:
        bvars["batch_stats"] = batch_stats["backbone"]
    apply = jax.jit(backbone.apply)

    from action_detection_tpu.data.transforms import preprocess_frames

    mu = []
    for lab in range(K + 1):
        imgs = np.stack([np.clip(np.asarray(DET_PAL[lab], np.int16)
                                 + np.random.RandomState(lab * 100 + i)
                                 .randint(-12, 13, size=(size, size, 3)),
                                 0, 255).astype(np.uint8) for i in range(4)])
        if modality == "Flow":
            imgs = _flow_stack(imgs)
            inv = imgs.copy()
            inv[..., 0::2] = 255 - inv[..., 0::2]
            imgs = np.concatenate([imgs, inv])
        x = preprocess_frames(jnp.asarray(imgs), small, modality,
                              1 if modality == "RGB" else 5)
        mu.append(np.asarray(apply(bvars, x)).mean(0))
    mu = np.stack(mu).astype(np.float64)
    A = np.concatenate([mu, np.ones((K + 1, 1))], 1)
    t_act = -4 * np.ones((K + 1, K + 1))
    np.fill_diagonal(t_act, 4.0)
    sol = np.linalg.lstsq(A, t_act, rcond=None)[0]
    params["activity_fc"] = {"kernel": sol[:-1].astype(np.float32),
                             "bias": sol[-1].astype(np.float32)}
    t_comp = -2 * np.ones((K + 1, K))
    for c in range(1, K + 1):
        t_comp[c, c - 1] = 2.0
    wc = np.linalg.lstsq(A, t_comp, rcond=None)[0][:-1]
    params["completeness_fc"] = {
        "kernel": np.concatenate([-wc, 2 * wc, -wc]).astype(np.float32),
        "bias": np.zeros(K, np.float32)}
    params["regressor_fc"] = {"kernel": np.zeros((3 * dim, 2 * K),
                                                 np.float32),
                              "bias": np.zeros(2 * K, np.float32)}
    reg_stats = np.array([[0.0, 0.0], [0.05, 0.05]], np.float32)
    return model, params, batch_stats, small, reg_stats


def _map(results, ds, K):
    dets = generate_detections(results, K, top_k=0, softmax_before_filter=True)
    dets = apply_regression(apply_classwise_nms(dets, 0.2))
    return float(evaluate_detections(dets, ds.get_all_gt(), K,
                                     np.arange(0.1, 1.0, 0.1),
                                     workers=1).mean())


def check_int8_slice(tmp_path, arch="BNInception", size=64, modality="RGB"):
    """The deployed default end to end (10 device crops, bf16 stem once per
    frame+flip, int8 trunk on the plain kernels, fused FC, STPP pool,
    reg_stats) on the color-coded fixture, port against the JAX scorer: the
    normalized combined score within int8's bound 0.12, mAP within 0.005."""
    K = DET_K
    new_length = 1 if modality == "RGB" else 5
    jmodel, params, batch_stats, small, reg_stats = _color_detector(
        arch, size, modality)
    pf, gt_by = write_detection_fixture(str(tmp_path / "p.txt"), n_videos=2)
    calib = detection_calibration_frames(size)
    pil = ColorCodedProvider(gt_by)
    if modality == "Flow":
        calib, pil = _flow_stack(calib), FlowColorProvider(gt_by)

    jds = JSSNDataset(pf, JSamplingConfig(), new_length=new_length,
                      test_interval=40)
    jscorer = JScorer(jmodel, params, batch_stats or None, small,
                      reg_stats=reg_stats, num_class=K, test_crops=10,
                      chunk_frames=4, modality=modality, device_crops=True,
                      quantize="e2e", calibration_frames=calib,
                      shared_stem=True)
    ref = {}
    for i in range(len(jds.video_list)):
        out = jscorer.score_video(jds.get_test_sample(i), pil)
        ref[out.video_id] = out.as_tuple()
    jscorer.close()

    model = SSN(num_class=K, base_model=arch, modality=modality, dropout=0.0)
    model.load_state_dict(state_dict_from_jax(params, batch_stats))
    ds = SSNDataset(pf, SamplingConfig(), new_length=new_length,
                    test_interval=40)
    scorer = ProposalScorer(model, InputSpec(*astuple(small)),
                            reg_stats=reg_stats, num_class=K,
                            chunk_frames=4, modality=modality, device="cpu",
                            quantize="e2e", calibration_frames=calib,
                            shared_stem=True)
    assert scorer.shared_stem
    got = {}
    with scorer:
        for i in range(len(ds.video_list)):
            out = scorer.score_video(ds.get_test_sample(i),
                                     ArrayProvider(pil))
            got[out.video_id] = out.as_tuple()

    assert set(got) == set(ref)
    max_norm_delta = 0.0
    for vid in ref:
        rel_r, act_r, comp_r, reg_r = ref[vid]
        rel_g, act_g, comp_g, reg_g = got[vid]
        np.testing.assert_array_equal(rel_g, rel_r)
        assert act_g.shape == act_r.shape and reg_g.shape == reg_r.shape
        comb_r = softmax(act_r)[:, 1:] * np.exp(comp_r)
        comb_g = softmax(act_g)[:, 1:] * np.exp(comp_g)
        max_norm_delta = max(max_norm_delta, float(
            np.abs(comb_g - comb_r).max() / comb_r.max()))
    print(f"port vs JAX int8-e2e shared-stem {arch} {modality}: max "
          f"normalized combined-score delta {max_norm_delta:.5f}")
    assert max_norm_delta < 0.12, max_norm_delta

    m_ref, m_got = _map(ref, jds, K), _map(got, jds, K)
    print(f"mAP: JAX {m_ref:.4f}, port {m_got:.4f}")
    assert m_ref > 0.8, m_ref       # the fixture is a real detector
    assert abs(m_got - m_ref) < 0.005, (m_got, m_ref)


def test_sharedstem_int8_slice_matches_jax(tmp_path):
    """The deployed default (BNInception RGB) end to end: the port's scores
    track the JAX scorer's within int8's combined-score bound, and mAP moves
    by < 0.5 point."""
    check_int8_slice(tmp_path)


def test_prequantized_and_lazy_calibration(tmp_path):
    """export_quantized -> prequantized= skips calibration with identical
    scores; without calibration frames the first chunk calibrates."""
    from action_detection_torch.models import seeded_init

    model = seeded_init(SSN(num_class=3, base_model="BNInception",
                            dropout=0.0), seed=2)
    base = model.input_spec
    spec = InputSpec(64, base.mean, base.std, base.bgr, base.div255)
    rng = np.random.RandomState(0)
    calib = rng.randint(0, 256, size=(4, 64, 64, 3), dtype=np.uint8)
    chunk = torch.from_numpy(rng.randint(0, 256, size=(4, 73, 97, 3),
                                         dtype=np.uint8))

    def make(**kw):
        return ProposalScorer(model, spec, reg_stats=np.ones((2, 2)),
                              num_class=3, chunk_frames=4, device="cpu",
                              quantize="e2e", shared_stem=True, **kw)

    a = make(calibration_frames=calib)
    export = a.export_quantized()
    b = make(prequantized=export)
    assert not a.needs_lazy_calibration and not b.needs_lazy_calibration
    assert a._qp is None and b._qp is None
    torch.testing.assert_close(b._score_chunk(chunk, 4),
                               a._score_chunk(chunk, 4), rtol=0, atol=0)

    lazy = make()
    assert lazy.needs_lazy_calibration and lazy.export_quantized() is None
    out = lazy._score_chunk(chunk, 4)
    assert not lazy.needs_lazy_calibration and torch.isfinite(out).all()
    with pytest.raises(ValueError, match="prequantized"):
        ProposalScorer(model, spec, reg_stats=np.ones((2, 2)), device="cpu",
                       prequantized=export)
    with pytest.raises(ValueError, match="reg_stats"):
        ProposalScorer(model, spec, device="cpu")


def check_cli(tmp_path, monkeypatch, modality="RGB"):
    """The port's ssn_test (TinyConv, synthetic frames, float path) writes
    the JAX CLI's pickle from the same weights, within 1e-4."""
    from action_detection_tpu.cli.ssn_test import main as jax_main
    from action_detection_tpu.train import save_checkpoint as jax_save

    from action_detection_torch.cli.ssn_test import main as port_main
    from action_detection_torch.train import save_checkpoint

    monkeypatch.chdir(tmp_path)
    write_proposal_list(tmp_path / "thumos14_tag_test_proposal_list.txt",
                        n_videos=2, seed=7)
    c_in = 3 if modality == "RGB" else 10
    jm = JSSN(num_class=20, base_model="TinyConv", modality=modality,
              dropout=0.0)
    v = _jitter(jm.init({"params": jax.random.PRNGKey(4)},
                        jnp.zeros((1, 9, 32, 32, c_in)), jnp.ones((1, 2)),
                        train=False), seed=4)
    rng = np.random.RandomState(5)
    params = jax.tree_util.tree_map_with_path(
        lambda p, a: (a * 300.0 + rng.randn(*a.shape).astype(np.float32)
                      * (p[-1].key == "bias") if p[0].key.endswith("_fc")
                      else a), jax.device_get(v["params"]))
    stats = jax.device_get(v["batch_stats"])
    reg_stats = np.array([[0.01, -0.02], [0.1, 0.2]], np.float32)
    jax_save("w.msgpack", params, reg_stats, batch_stats=stats,
             arch="TinyConv")
    save_checkpoint("w.pt", state_dict_from_jax(params, stats), reg_stats,
                    arch="TinyConv")

    common = ["--arch", "TinyConv", "--synthetic_data", "--prop_file_dir",
              str(tmp_path), "--frame_interval", "30", "--test_batchsize",
              "8", "--save_raw_scores"]
    jax_main(["thumos14", modality, "w.msgpack", "j.pkl"] + common
             + ["j_raw.pkl", "--devices", "0"])
    port_main(["thumos14", modality, "w.pt", "p.pkl"] + common
              + ["p_raw.pkl", "--device", "cpu"])
    with open("j.pkl", "rb") as f:
        ref = pickle.load(f)
    with open("p.pkl", "rb") as f:
        got = pickle.load(f)
    assert set(got) == set(ref) and len(got) == 2
    for vid in ref:
        for g, r in zip(got[vid], ref[vid]):
            assert g.shape == r.shape
            np.testing.assert_allclose(g, r, rtol=0, atol=1e-4)
        assert np.abs(ref[vid][1]).max() > 1e-2     # scores are not ~0
    with open("j_raw.pkl", "rb") as f:
        raw_ref = pickle.load(f)
    with open("p_raw.pkl", "rb") as f:
        raw_got = pickle.load(f)
    for vid in raw_ref:
        np.testing.assert_allclose(raw_got[vid], raw_ref[vid], rtol=0,
                                   atol=1e-4)


def test_ssn_test_cli_matches_jax_cli(tmp_path, monkeypatch):
    """The port's ssn_test (TinyConv, synthetic frames, float path) writes
    the JAX CLI's pickle from the same weights, within 1e-4."""
    check_cli(tmp_path, monkeypatch)
