"""Port parity, ``--int8_mode perlayer``: the per-layer int8 BNInception
(bf16 activations, every conv in int8 through K1's bf16 epilogue, the stem
conv padded to 16 input channels) against the JAX package's
``_conv_int8``, ``calibrate_activation_scales`` and
``bninception_int8_features`` on the same weights and inputs, and the
per-layer ``ProposalScorer`` against the JAX scorer on the color-coded
detector fixture of tests/test_int8.py (combined-score bound 0.12, mAP
within 0.005). InceptionV3 has no per-layer mode: the CLIs refuse it with
the JAX package's text.

The JAX calibration pass runs op by op here (``jax.jit`` patched to the
identity): under ``jax.jit`` XLA fuses across the ops of the whole pass and
rounds differently, while the port computes each op's stated rounding (the
same choice as ``test_torch_port_int8.py:jax_qe``)."""

from dataclasses import astuple

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from action_detection_tpu.config import SamplingConfig as JSamplingConfig
from action_detection_tpu.data.ssn_dataset import SSNDataset as JSSNDataset
from action_detection_tpu.infer.scorer import ProposalScorer as JScorer
from action_detection_tpu.models.backbones import bn_inception_int8 as jq
from action_detection_tpu.ops.metrics import softmax

from action_detection_torch.cli import binary_test, ssn_test
from action_detection_torch.config import SamplingConfig
from action_detection_torch.data.ssn_dataset import SSNDataset
from action_detection_torch.infer.scorer import ProposalScorer
from action_detection_torch.models import SSN, state_dict_from_jax
from action_detection_torch.models.backbones import InputSpec
from action_detection_torch.models.backbones import bn_inception_int8 as q

from tests.test_int8 import (DET_K, ColorCodedProvider,
                             detection_calibration_frames,
                             write_detection_fixture)
from tests.test_torch_port_int8 import (  # noqa: F401 (fixtures)
    bn_setup, one_torch_thread)
from tests.test_torch_port_scorer import ArrayProvider, _color_detector, _map


def _stem_conv(c_in: int, seed: int):
    """A BN-folded conv1_7x7_s2 with ``c_in`` input channels, as the JAX
    trees and as the port's state_dict."""
    rng = np.random.RandomState(seed)
    k = (rng.randn(7, 7, c_in, 64) * 0.05).astype(np.float32)
    b = (rng.randn(64) * 0.1).astype(np.float32)
    g = (1.0 + 0.1 * rng.randn(64)).astype(np.float32)
    beta = (0.05 * rng.randn(64)).astype(np.float32)
    mean = (0.05 * rng.randn(64)).astype(np.float32)
    var = (1.0 + 0.3 * rng.rand(64)).astype(np.float32)
    params = {"conv1_7x7_s2": {"kernel": k, "bias": b},
              "conv1_7x7_s2_bn": {"scale": g, "bias": beta}}
    stats = {"conv1_7x7_s2_bn": {"mean": mean, "var": var}}
    return params, stats, state_dict_from_jax(params, stats)


def _bits(t: torch.Tensor) -> np.ndarray:
    return t.view(torch.int16).numpy()


@pytest.mark.parametrize("c_in", [3, 10, 15])
@pytest.mark.parametrize("static", [False, True])
def test_padded_stem_conv_bit_exact(c_in, static):
    """The int8 7x7 s2 p3 stem conv at RGB's, Flow's and RGBDiff's input
    channels: weights padded with zero channels to 16, the input quantized
    into 16 channels of which the extra are zero, so the s32 sums and the
    bf16 outputs are ``_conv_int8``'s bit for bit (tails: a 21x19 input)."""
    params, stats, sd = _stem_conv(c_in, seed=c_in)
    jlayer = jq.quantize_backbone(params, stats)["conv1_7x7_s2"]
    layer = q.quantize_backbone(sd)["conv1_7x7_s2"]
    assert tuple(layer["wq"].shape) == (64, 7, 7, 16)
    np.testing.assert_array_equal(
        layer["wq"][..., :c_in].numpy(),
        np.asarray(jlayer["wq"]).transpose(3, 0, 1, 2))
    assert not layer["wq"][..., c_in:].any()
    rng = np.random.RandomState(c_in + 1)
    x = (rng.randn(2, 21, 19, c_in) * 60).astype(np.float32)
    xb = jnp.asarray(x, jnp.bfloat16)
    sx = 0.37 if static else None
    ref = jq._conv_int8(xb, jlayer, stride=2, pad=3,
                        sx=None if sx is None else jnp.float32(sx))
    scales = {} if sx is None else {
        "conv1_7x7_s2": torch.tensor(sx, dtype=torch.float32)}
    got = q._PerLayerOps({"conv1_7x7_s2": layer}, act_scales=scales).conv(
        torch.from_numpy(x).to(torch.bfloat16), "conv1_7x7_s2", 2, 3)
    assert got.shape == (2, 11, 10, 64) and got.dtype == torch.bfloat16
    assert (np.asarray(ref, np.float32) > 0).mean() > 0.2
    np.testing.assert_array_equal(_bits(got), np.asarray(ref).view(np.int16))


@pytest.mark.parametrize("name,stride,pad,c_in", [
    ("conv2_3x3_reduce", 1, 0, 64), ("conv2_3x3", 1, 1, 64),
    ("inception_3a_1x1", 1, 0, 192), ("inception_3c_double_3x3_2", 2, 1, 96),
    ("inception_5b_pool_proj", 1, 0, 1024)])
@pytest.mark.parametrize("static", [False, True])
def test_perlayer_conv_bit_exact(bn_setup, name, stride, pad, c_in,  # noqa: F811
                                 static):
    """Every other per-layer conv geometry, dynamic and static scales (the
    static one set so that some inputs saturate at +-127)."""
    _, params, stats, sd, _ = bn_setup
    jlayer = jq.quantize_backbone(params, stats)[name]
    layer = q.quantize_backbone(sd)[name]
    assert layer["wq"].shape[-1] == c_in
    rng = np.random.RandomState(c_in)
    x = (rng.rand(2, 9, 9, c_in) * 30).astype(np.float32)
    sx = 0.2 if static else None
    ref = jq._conv_int8(jnp.asarray(x, jnp.bfloat16), jlayer, stride=stride,
                        pad=pad, sx=None if sx is None else jnp.float32(sx))
    scales = {} if sx is None else {name: torch.tensor(sx)}
    got = q._PerLayerOps({name: layer}, act_scales=scales).conv(
        torch.from_numpy(x).to(torch.bfloat16), name, stride, pad)
    np.testing.assert_array_equal(_bits(got), np.asarray(ref).view(np.int16))


@pytest.fixture(scope="module")
def perlayer_both(bn_setup):  # noqa: F811
    """The per-layer trees and the static scales of both packages (JAX's
    calibration pass op by op) on the 64^2 fixture batch."""
    _, params, stats, sd, x = bn_setup
    jtree = jq.quantize_backbone(params, stats)
    tree = q.quantize_backbone(sd)
    real_jit = jax.jit
    jax.jit = lambda f, **kw: f
    try:
        jscales = jq.calibrate_activation_scales(jtree, jnp.asarray(x))
    finally:
        jax.jit = real_jit
    scales = q.calibrate_activation_scales(tree, torch.from_numpy(x))
    return jtree, tree, jscales, scales, x


def test_calibrate_activation_scales_equal(perlayer_both):
    """Each of the 69 convs' static scale, float32 bit for bit."""
    _, _, jscales, scales, _ = perlayer_both
    assert set(scales) == set(jscales) and len(scales) == 69
    for name, s in scales.items():
        assert s.dtype == torch.float32 and s.dim() == 0
        assert s.item() == float(np.asarray(jscales[name])), name


@pytest.mark.parametrize("static", [False, True])
def test_perlayer_features_within_a_bf16_ulp(perlayer_both, static):
    """``bninception_int8_features`` end to end (int8 stem, bf16 ceil max
    pools and include-pad avg pools at 3a-3b and 4a-4d, every conv): the
    activations are bit-exact, so the features differ only where the two
    frameworks' float32 global means round to different bf16 values, by
    one bf16 ulp at most (measured on this fixture: every feature equal)."""
    jtree, tree, jscales, scales, x = perlayer_both
    ref = np.asarray(jq.bninception_int8_features(
        jtree, jnp.asarray(x), act_scales=jscales if static else None))
    got = q.bninception_int8_features(
        tree, torch.from_numpy(x), act_scales=scales if static else None
    ).numpy()
    assert got.shape == ref.shape == (4, 1024)
    ulp = np.exp2(np.floor(np.log2(np.maximum(np.abs(ref), 1e-30))) - 7)
    diff = np.abs(got - ref)
    print(f"perlayer features (static={static}): {np.mean(diff == 0):.4f} "
          f"equal, max {np.max(diff / ulp):.1f} bf16 ulp")
    assert np.all(diff <= ulp)
    assert np.mean(diff == 0) > 0.95 and np.abs(ref).max() > 0.1


def _perlayer_scorers(tmp_path, calibrate: bool):
    """The JAX and the port per-layer scorers on the color-coded fixture
    (10 device crops, BNInception at 64^2)."""
    K = DET_K
    jmodel, params, batch_stats, small, reg_stats = _color_detector()
    pf, gt_by = write_detection_fixture(str(tmp_path / "p.txt"), n_videos=2)
    calib = detection_calibration_frames(64) if calibrate else None
    pil = ColorCodedProvider(gt_by)
    jds = JSSNDataset(pf, JSamplingConfig(), test_interval=40)
    jscorer = JScorer(jmodel, params, batch_stats or None, small,
                      reg_stats=reg_stats, num_class=K, test_crops=10,
                      chunk_frames=4, device_crops=True, quantize="perlayer",
                      calibration_frames=calib)
    model = SSN(num_class=K, base_model="BNInception", dropout=0.0)
    model.load_state_dict(state_dict_from_jax(params, batch_stats))
    scorer = ProposalScorer(model, InputSpec(*astuple(small)),
                            reg_stats=reg_stats, num_class=K, chunk_frames=4,
                            device="cpu", quantize="perlayer",
                            calibration_frames=calib)
    ds = SSNDataset(pf, SamplingConfig(), test_interval=40)
    return jscorer, jds, scorer, ds, pil


def test_perlayer_scorer_matches_jax(tmp_path):
    """The per-layer ProposalScorer with static scales end to end: the
    combined score within int8's 0.12 of JAX's, mAP within 0.005; then its
    export_quantized() round trip (equal scores) and the dynamic-scale
    scorer (no calibration frames) on one chunk, its fused scores within
    0.12 of the largest static-scale one."""
    jscorer, jds, scorer, ds, pil = _perlayer_scorers(tmp_path, True)
    ref, got = {}, {}
    for i in range(len(jds.video_list)):
        out = jscorer.score_video(jds.get_test_sample(i), pil)
        ref[out.video_id] = out.as_tuple()
        out = scorer.score_video(ds.get_test_sample(i), ArrayProvider(pil))
        got[out.video_id] = out.as_tuple()
    jscorer.close()
    assert scorer._act_scales is not None and not scorer.shared_stem
    worst = 0.0
    for vid in ref:
        comb_r = softmax(ref[vid][1])[:, 1:] * np.exp(ref[vid][2])
        comb_g = softmax(got[vid][1])[:, 1:] * np.exp(got[vid][2])
        worst = max(worst, float(np.abs(comb_g - comb_r).max()
                                 / comb_r.max()))
    m_ref, m_got = _map(ref, jds, DET_K), _map(got, jds, DET_K)
    print(f"perlayer port vs JAX: combined-score delta {worst:.5f}; mAP "
          f"JAX {m_ref:.4f}, port {m_got:.4f}")
    assert worst < 0.12, worst
    assert m_ref > 0.8 and abs(m_got - m_ref) < 0.005, (m_got, m_ref)

    chunk = torch.from_numpy(np.asarray(
        detection_calibration_frames(64)[::3]))
    static = scorer._score_chunk(chunk, 4)
    kw = dict(reg_stats=scorer.reg_stats, num_class=DET_K, chunk_frames=4,
              device="cpu", quantize="perlayer")
    tree, scales = scorer.export_quantized()
    assert set(scales) == set(scorer._act_scales)
    again = ProposalScorer(scorer.model, scorer.input_spec,
                           prequantized=(tree, scales), **kw)
    torch.testing.assert_close(again._score_chunk(chunk, 4), static,
                               rtol=0, atol=0)
    dynamic = ProposalScorer(scorer.model, scorer.input_spec, **kw)
    assert dynamic._act_scales is None and not dynamic.needs_lazy_calibration
    delta = ((dynamic._score_chunk(chunk, 4) - static).abs().max()
             / static.abs().max()).item()
    print(f"perlayer dynamic vs static scales: {delta:.5f} of the largest "
          "fused score")
    assert delta < 0.12


@pytest.mark.parametrize("cli,args", [
    (ssn_test.main, ["thumos14", "RGB", "w.pt", "s.pkl"]),
    (binary_test.main, ["thumos14", "RGB", "testing", "w.pt", "s.pkl"])])
@pytest.mark.parametrize("int8", [[], ["--int8"]])
def test_inceptionv3_perlayer_refused_as_in_jax(cli, args, int8):
    """InceptionV3 has no per-layer mode: an explicit ``--int8_mode
    perlayer`` exits with the JAX package's text, with or without
    ``--int8``, before any weights are read."""
    with pytest.raises(SystemExit, match="int8 mode 'perlayer' is not "
                                         "available for backbone "
                                         "'InceptionV3'"):
        cli(args + ["--arch", "InceptionV3", "--int8_mode", "perlayer",
                    "--device", "cpu"] + int8)
