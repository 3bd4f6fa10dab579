"""Port parity, ``quantization_report`` (the int8 check before deploying
``--int8``): the port's report on its float BNInception module against the
JAX package's on the converted variables, in both modes, with and without
a score layout, on tests/test_int8.py's torch-twin weights: from the same
calibration (JAX's pass op by op) within a tight tolerance, which holds
the report's own arithmetic, and with each package calibrating its own
way (JAX's pass jitted) within 0.01 absolute."""

from dataclasses import astuple

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from action_detection_tpu.models import SSN as JSSN
from action_detection_tpu.models.backbones import bn_inception_int8 as jq
from action_detection_tpu.models.backbones import get_backbone as j_get_backbone

from action_detection_torch.models.backbones import get_backbone
from action_detection_torch.models.backbones import bn_inception_int8 as q

from tests.test_torch_port_int8 import one_torch_thread  # noqa: F401


@pytest.fixture(scope="module")
def report_setup():
    """tests/test_int8.py's torch-twin setting: BNInception at torch's
    default init (seed 3) with perturbed BN statistics, the JAX variables
    converted from it, the fused test FC and layout of a K = 20 SSN, and
    two normalized 64^2 frames."""
    from action_detection_tpu.models.convert import (
        convert_torch_backbone_state)
    from action_detection_tpu.models.ssn import fuse_test_heads
    from action_detection_tpu.ops.stpp import (ReorganizedScoreLayout,
                                               StppConfig)

    torch.manual_seed(3)
    backbone = get_backbone("BNInception", "RGB")[0].eval()
    with torch.no_grad():
        for m in backbone.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.normal_(0, 0.02)
                m.running_var.uniform_(0.9, 1.4)
                m.weight.normal_(1.0, 0.02)
                m.bias.normal_(0, 0.02)
    sd = backbone.state_dict()
    params, batch_stats = convert_torch_backbone_state(
        {k: v for k, v in sd.items()
         if not k.endswith("num_batches_tracked")}, "BNInception")
    jbackbone, _, _ = j_get_backbone("BNInception", "RGB")
    variables = {"params": params, "batch_stats": batch_stats}

    K = 20
    model = JSSN(num_class=K, base_model="BNInception", dropout=0.0)
    head_vars = model.init({"params": jax.random.PRNGKey(1)},
                           jnp.zeros((1, 9, 64, 64, 3)), jnp.ones((1, 2)),
                           train=False)
    kernel, bias = fuse_test_heads(head_vars["params"], K, (1, 1, 1))
    cfg = StppConfig.from_raw((1, 1, 1))
    layout = ReorganizedScoreLayout(K + 1, K, 2 * K, cfg.feat_multiplier)
    rng = np.random.RandomState(5)
    x = (rng.rand(2, 64, 64, 3) * 255.0 - 117.0).astype(np.float32)
    return (backbone, sd, jbackbone, variables, np.asarray(kernel),
            np.asarray(bias), layout, x)


def test_report_float_features_match_jax(report_setup):
    """The report's float reference: the port's backbone on the state dict
    against the JAX backbone on the converted variables, within 1e-4."""
    backbone, sd, jbackbone, variables, _, _, _, x = report_setup
    ref = np.asarray(jbackbone.apply(variables, jnp.asarray(x)))
    with torch.no_grad():
        got = torch.func.functional_call(backbone, sd,
                                         (torch.from_numpy(x),)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-4,
                               atol=1e-4 * np.abs(ref).max())


@pytest.mark.parametrize("mode", ["perlayer", "e2e"])
@pytest.mark.parametrize("with_layout", [True, False])
def test_quantization_report_matches_jax(report_setup, mode, with_layout):
    """Each package calibrating its own way (JAX's pass jitted): JAX's keys,
    each value within 0.01 absolute of JAX's, and tests/test_int8.py's
    bounds. Measured: at most 2.2e-3 absolute, at e2e's act_rel_rms (29%
    of its value); the gap is JAX's jitted calibration rounding
    differently from op by op (ROADMAP.md queue 3), which moves the scales
    themselves, so the report's arithmetic is held by the same-calibration
    test below, not here."""
    from action_detection_tpu.models.backbones.bn_inception_int8 import (
        quantization_report as j_report)
    from action_detection_torch.ops.stpp import ReorganizedScoreLayout

    backbone, sd, jbackbone, variables, kernel, bias, jlayout, x = \
        report_setup
    layout = (ReorganizedScoreLayout(*astuple(jlayout)) if with_layout
              else None)
    ref = j_report(jbackbone, variables, jnp.asarray(x), fused_kernel=kernel,
                   fused_bias=bias, layout=jlayout if with_layout else None,
                   mode=mode)
    got = q.quantization_report(backbone, sd, torch.from_numpy(x),
                                fused_kernel=kernel, fused_bias=bias,
                                layout=layout, mode=mode)
    keys = {"feature_cosine", "feature_rel_rms", "score_rel_rms"}
    if with_layout:
        keys |= {"act_rel_rms", "comp_rel_rms", "reg_rel_rms"}
    assert set(got) == set(ref) == keys
    gaps = {k: abs(got[k] - ref[k]) for k in keys}
    print(f"quantization_report {mode}: port {got}; |port - JAX| {gaps}")
    for k in keys:
        assert gaps[k] < 0.01, (k, got[k], ref[k])
    assert got["feature_cosine"] > 0.995, got
    assert got["feature_rel_rms"] < (0.06 if mode == "perlayer" else 0.08)
    for head in ("act", "comp", "reg"):
        assert got.get(f"{head}_rel_rms", 0.0) < 0.12, got


def report_gaps(got, ref):
    """Each key's gap relative to its distance from the ideal value: 1 -
    cosine for ``feature_cosine``, the value itself for a relative RMS."""
    return {k: abs(got[k] - ref[k]) / (1.0 - ref[k] if k == "feature_cosine"
                                       else ref[k]) for k in ref}


@pytest.mark.parametrize("mode", ["perlayer", "e2e"])
@pytest.mark.parametrize("with_layout", [True, False])
def test_quantization_report_same_calibration_matches_jax(
        report_setup, monkeypatch, mode, with_layout):
    """Both reports from the same int8 activations, which holds the report's
    own arithmetic (cosine mean, relative RMS, the head slices): JAX's
    calibration pass runs op by op (``jax.jit`` off), whose per-layer
    scales the port's equal bit for bit (tests/test_torch_port_perlayer.py);
    in e2e mode the port builds its tree from JAX's maxes and its trunk
    takes JAX's hybrid-stem output (the bf16 stems may differ by 1 LSB,
    tests/test_torch_port_int8.py), so the trunks' features are bit-exact.
    Every key within 2e-5 of JAX's, relative to its distance from the
    ideal (1 - cosine, the relative RMS itself); measured on this fixture:
    at most 4.7e-6 (perlayer) and 3.5e-6 (e2e)."""
    from action_detection_torch.ops.stpp import ReorganizedScoreLayout

    backbone, sd, jbackbone, variables, kernel, bias, jlayout, x = \
        report_setup
    monkeypatch.setattr(jax, "jit", lambda f, **kw: f)
    seen = {}
    real_maxes, real_calibrate = jq._e2e_output_maxes, jq.calibrate_e2e

    def maxes_seen(*args):
        seen["maxes"] = real_maxes(*args)
        return seen["maxes"]

    def tree_seen(*args, **kwargs):
        seen["tree"] = real_calibrate(*args, **kwargs)
        return seen["tree"]

    monkeypatch.setattr(jq, "_e2e_output_maxes", maxes_seen)
    monkeypatch.setattr(jq, "calibrate_e2e", tree_seen)
    ref = jq.quantization_report(
        jbackbone, variables, jnp.asarray(x), fused_kernel=kernel,
        fused_bias=bias, layout=jlayout if with_layout else None, mode=mode)
    if mode == "e2e":
        maxes = {k: float(v) for k, v in seen["maxes"].items()}
        monkeypatch.setattr(q, "calibrate_e2e", lambda state_dict, frames:
                            q.quantize_backbone_e2e(state_dict, maxes))
        monkeypatch.setattr(q, "_e2e_stem_quantized", lambda qe, frames:
                            torch.from_numpy(np.array(jq._e2e_stem_quantized(
                                seen["tree"], jnp.asarray(frames.numpy())))))
    got = q.quantization_report(
        backbone, sd, torch.from_numpy(x), fused_kernel=kernel,
        fused_bias=bias, layout=(ReorganizedScoreLayout(*astuple(jlayout))
                                 if with_layout else None), mode=mode)
    assert set(got) == set(ref)
    gaps = report_gaps(got, ref)
    print(f"quantization_report {mode}, same calibration: relative gaps "
          f"{gaps}")
    for k in ref:
        assert gaps[k] < 2e-5, (k, got[k], ref[k])


def test_quantization_report_rejects_unknown_mode(report_setup):
    backbone, sd, *_, x = report_setup
    with pytest.raises(ValueError, match="mode"):
        q.quantization_report(backbone, sd, torch.from_numpy(x),
                              mode="int4")
