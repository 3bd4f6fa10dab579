"""Port parity, the all-int8 stems: the e2e trees built with
``hybrid_stem=False`` (BNInception and InceptionV3), their int8 stems and
trunks, the no-stem calibration, and the shared-stem scorer on a
``prequantized`` all-int8 tree — each held against its
action_detection_tpu twin on the same numpy inputs.

The kernels run their plain versions here (CPU tensors); the stem
geometries' CUDA cases are in tests/test_torch_port_kernels_cuda.py
(``cuda`` marker)."""

from dataclasses import astuple

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from action_detection_tpu.data.transforms import (
    preprocess_frames as j_preprocess_frames)
from action_detection_tpu.infer.scorer import ProposalScorer as JScorer
from action_detection_tpu.models import SSN as JSSN
from action_detection_tpu.models import jitted_init
from action_detection_tpu.models.backbones import get_backbone as j_get_backbone
from action_detection_tpu.models.backbones import bn_inception_int8 as jq
from action_detection_tpu.models.backbones import inception_v3_int8 as jiq

from action_detection_torch.infer.scorer import ProposalScorer
from action_detection_torch.models import SSN, state_dict_from_jax
from action_detection_torch.models.backbones import InputSpec, get_backbone
from action_detection_torch.models.backbones import bn_inception_int8 as q
from action_detection_torch.models.backbones import inception_v3_int8 as iq
from action_detection_torch.models.convert import quantized_from_jax

from tests.test_torch_port_int8 import (  # noqa: F401 (fixtures)
    _jitter, bn_setup, one_torch_thread)
from tests.test_torch_port_iv3 import iv3_setup, unjitted  # noqa: F401

TREE_SCALARS = {"__input_scale__", "__feat_scale__", "__entry__"}


def check_tree(ours, ref, path=""):
    """Two runtime trees equal key for key, tensor for tensor."""
    if isinstance(ours, dict):
        assert set(ours) == set(ref), path
        for key in ours:
            check_tree(ours[key], ref[key], path + "/" + key)
        return
    assert ours.dtype == ref.dtype and ours.shape == ref.shape, path
    assert torch.equal(ours, ref), path


def rel_rms(got, ref) -> float:
    return float(np.linalg.norm(got - ref) / (np.linalg.norm(ref) + 1e-9))


def min_cosine(got, ref) -> float:
    return float(min(np.dot(r, g) / (np.linalg.norm(r) * np.linalg.norm(g)
                                     + 1e-9) for r, g in zip(ref, got)))


@pytest.fixture(scope="module")
def bn_i8(bn_setup):
    """JAX's no-stem calibration maxes (the int8 proxy stem, op by op) and
    the all-int8 tree JAX builds from them."""
    _, params, stats, _, x = bn_setup
    folded = jq.fold_bn(params, stats)
    q0 = jq.quantize_backbone(params, stats, folded=folded)
    maxes = jax.device_get(jq._e2e_output_maxes(q0, jnp.asarray(x)))
    qe = jq.quantize_backbone_e2e(params, stats, maxes, hybrid_stem=False,
                                  folded=folded)
    return {n: float(v) for n, v in maxes.items()}, qe


@pytest.fixture(scope="module")
def iv3_i8(iv3_setup):
    """JAX's op-by-op InceptionV3 calibration maxes and its all-int8 tree
    (``calibrate_e2e_iv3(..., hybrid_stem=False)`` with ``jax.jit`` as the
    identity)."""
    _, _, params, stats, _, x = iv3_setup
    folded = jiq.fold_bn_iv3(params, stats)
    maxes = jax.device_get(jiq._calibration_maxes_iv3(
        jax.tree_util.tree_map(jnp.asarray, folded), jnp.asarray(x)))
    with unjitted():
        qe = jiq.calibrate_e2e_iv3(params, stats, jnp.asarray(x),
                                   hybrid_stem=False)
    return {n: float(v) for n, v in maxes.items()}, qe


# --- BNInception ------------------------------------------------------------


def test_bninception_all_int8_tree_exact(bn_setup, bn_i8):
    """``quantize_backbone_e2e(..., hybrid_stem=False)`` from JAX's maxes
    equals JAX's tree: every folded conv quantized once, no ``__stem__``;
    conv1's weights padded with zero channels to 16 for K1."""
    _, params, stats, sd, _ = bn_setup
    maxes, jqe = bn_i8
    ours = q.quantize_backbone_e2e(sd, maxes, hybrid_stem=False)
    assert set(ours) == set(jqe)
    assert set(ours) - TREE_SCALARS == set(jq.fold_bn(params, stats))
    check_tree(ours, quantized_from_jax(jqe))
    wq = ours["conv1_7x7_s2"]["wq"]
    assert wq.shape == (64, 7, 7, 16) and not wq[..., 3:].any()
    np.testing.assert_array_equal(
        wq[..., :3].numpy(),
        np.asarray(jqe["conv1_7x7_s2"]["wq"]).transpose(3, 0, 1, 2))


def test_bninception_all_int8_stem_and_trunk_bit_exact(bn_setup, bn_i8):
    """The all-int8 stem (input quantized into 16 channels, conv1 7x7 s2 on
    signed input, Caffe-ceil int8 pools) and the trunk after it: int8
    activations bit-exact against JAX, features within 1e-6."""
    _, jqe = bn_i8
    x = bn_setup[4]
    qe = quantized_from_jax(jqe)
    ref_h = np.asarray(jq._e2e_stem_quantized(jqe, jnp.asarray(x)))
    h = q._e2e_stem_quantized(qe, torch.from_numpy(x))
    assert h.dtype == torch.int8 and h.shape == (4, 8, 8, 192)
    np.testing.assert_array_equal(h.numpy(), ref_h)
    assert (ref_h > 0).mean() > 0.1 and ref_h.max() > 32     # not trivial
    xq = q._quantize_input(torch.from_numpy(x), qe["__input_scale__"], 16)
    assert (xq[..., :3] < 0).any() and not xq[..., 3:].any()

    ref_acts = np.asarray(jq._walk_trunk(jq._E2EOps(jqe),
                                         jnp.asarray(ref_h)))
    np.testing.assert_array_equal(
        q._walk_trunk(q._E2EOps(qe), h).numpy(), ref_acts)
    ref = np.asarray(jq.bninception_int8_e2e_features(jqe, jnp.asarray(x)))
    got = q.bninception_int8_e2e_features(qe, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=0)


def test_bninception_no_stem_calibration(bn_setup, bn_i8):
    """Without a stem the calibration pass runs the stem on the int8 proxy
    (K1's bf16 epilogue): its maxes within 1% of JAX's op-by-op ones, and
    ``calibrate_e2e(..., hybrid_stem=False)`` builds a stemless tree."""
    _, _, _, sd, x = bn_setup
    maxes, _ = bn_i8
    with torch.no_grad():
        ours = q._e2e_output_maxes(q.quantize_backbone(sd),
                                   torch.from_numpy(x))
    assert set(ours) == set(maxes)
    assert len(ours) == 1 + 3 + 66    # input, 3 stem convs, 66 trunk convs
    worst = max(abs(ours[n] / maxes[n] - 1) for n in maxes)
    print(f"no-stem calibration maxes: largest relative gap {worst:.2e}")
    for name in maxes:
        np.testing.assert_allclose(ours[name], maxes[name], rtol=1e-2,
                                   err_msg=name)
    qe = q.calibrate_e2e(sd, torch.from_numpy(x), hybrid_stem=False)
    assert "__stem__" not in qe and "__stem_scale__" not in qe
    assert qe["conv1_7x7_s2"]["wq"].shape == (64, 7, 7, 16)
    assert qe["__feat_scale__"].shape == (1024,)


def _float_features(arch, sd, x):
    backbone = get_backbone(arch, "RGB")[0]
    backbone.load_state_dict(sd)
    with torch.no_grad():
        return backbone.eval()(torch.from_numpy(x)).double().numpy()


@pytest.mark.parametrize("arch", ["BNInception", "InceptionV3"])
def test_hybrid_no_worse_than_all_int8(arch, bn_setup, iv3_setup):
    """Both stems against the float backbone (the bounds of
    tests/test_int8_iv3.py:98-104 and :135): all-int8 min cosine > 0.99 and
    relative RMS < 0.12; the hybrid stem no worse than 1.05x all-int8."""
    if arch == "BNInception":
        sd, x = bn_setup[3], bn_setup[4]
        calibrate, features = q.calibrate_e2e, q.bninception_int8_e2e_features
    else:
        sd, x = iv3_setup[4], iv3_setup[5]
        calibrate = iq.calibrate_e2e_iv3
        features = iq.inception_v3_int8_e2e_features
    ref = _float_features(arch, sd, x)
    xt = torch.from_numpy(x)
    got = {}
    with torch.no_grad():
        for hybrid in (True, False):
            qe = calibrate(sd, xt, hybrid_stem=hybrid)
            assert ("__stem__" in qe) == hybrid
            got[hybrid] = features(qe, xt).double().numpy()
    rel_h, rel_i8 = rel_rms(got[True], ref), rel_rms(got[False], ref)
    cos_i8 = min_cosine(got[False], ref)
    print(f"{arch} vs float: hybrid rel {rel_h:.5f}; all-int8 rel "
          f"{rel_i8:.5f}, min cos {cos_i8:.6f}")
    assert np.isfinite(got[False]).all()
    assert cos_i8 > 0.99 and rel_i8 < 0.12, (cos_i8, rel_i8)
    assert rel_h < 0.12 and rel_h <= rel_i8 * 1.05, (rel_h, rel_i8)


# --- InceptionV3 ------------------------------------------------------------


def test_iv3_all_int8_tree_exact(iv3_setup, iv3_i8):
    """``quantize_iv3_e2e(..., hybrid_stem=False)`` from JAX's maxes equals
    ``calibrate_e2e_iv3(..., hybrid_stem=False)``'s tree (the key set of
    tests/test_int8_iv3.py:91-94); Conv2d_1a's C = 3 padded to 16."""
    _, _, params, stats, sd, x = iv3_setup
    maxes, jqe = iv3_i8
    folded = iq.fold_bn_iv3(sd)
    ours = iq.quantize_iv3_e2e(folded, maxes, hybrid_stem=False)
    assert set(ours) == set(jqe)
    assert set(ours) - TREE_SCALARS == set(jiq.fold_bn_iv3(params, stats))
    check_tree(ours, quantized_from_jax(jqe))
    assert ours["Conv2d_1a_3x3"]["wq"].shape == (32, 3, 3, 16)
    assert not ours["Conv2d_1a_3x3"]["wq"][..., 3:].any()

    qe = iq.calibrate_e2e_iv3(sd, torch.from_numpy(x), hybrid_stem=False)
    assert set(qe) == set(jqe) and qe["__feat_scale__"].shape == (2048,)


def test_iv3_all_int8_stem_and_trunk_bit_exact(iv3_setup, iv3_i8):
    """The all-int8 InceptionV3 stem (Conv2d_1a 3x3 s2 VALID on 16 signed
    channels, 2a-4a, two VALID int8 pools) and the trunk: int8 activations
    bit-exact against JAX, features within 1e-6."""
    _, jqe = iv3_i8
    x = iv3_setup[5]
    qe = quantized_from_jax(jqe)
    ref_h = np.asarray(jiq._iv3_stem_quantized(jqe, jnp.asarray(x)))
    h = iq._iv3_stem_quantized(qe, torch.from_numpy(x))
    assert h.dtype == torch.int8 and h.shape == (3, 7, 7, 192)
    np.testing.assert_array_equal(h.numpy(), ref_h)
    assert (ref_h > 0).mean() > 0.1

    class JActs(jiq._ForwardOps):           # the last concat, before the mean
        def finish(self, y):
            return y

    class Acts(iq._ForwardOps):
        def finish(self, y):
            return y

    np.testing.assert_array_equal(
        iq._walk_trunk(Acts(qe), h).numpy(),
        np.asarray(jiq._walk_trunk(JActs(jqe), jnp.asarray(ref_h))))
    ref = np.asarray(jiq.inception_v3_int8_e2e_features(jqe, jnp.asarray(x)))
    got = iq.inception_v3_int8_e2e_features(qe, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=0)


# --- the shared-stem scorer on a prequantized all-int8 tree -----------------


@pytest.mark.parametrize("arch,modality,size", [
    ("BNInception", "RGB", 64), ("BNInception", "Flow", 64),
    ("InceptionV3", "RGB", 75)])
def test_prequantized_all_int8_sharedstem_matches_jax(arch, modality, size):
    """A ``hybrid_stem=False`` tree handed to the shared-stem scorer through
    ``prequantized=`` (the way JAX reaches the all-int8 stem): the port's
    fused chunk scores against the JAX scorer's from the same tree."""
    K = 3
    new_length = 1 if modality == "RGB" else 5
    c_in = 3 if modality == "RGB" else 10
    jmodel = JSSN(num_class=K, base_model=arch, modality=modality,
                  dropout=0.0)
    variables = _jitter(jitted_init(
        jmodel, {"params": jax.random.PRNGKey(1)},
        jnp.zeros((1, 9, size, size, c_in)), jnp.ones((1, 2)), train=False),
        seed=5)
    params = jax.device_get(variables["params"])
    stats = jax.device_get(variables["batch_stats"])
    _, _, base = j_get_backbone(arch, modality)
    jspec = base.__class__(size, base.mean, base.std, base.bgr, base.div255)
    rng = np.random.RandomState(size + c_in)
    S = jspec.scale_size
    chunk = rng.randint(0, 256, size=(3, S, S * 4 // 3, c_in),
                        dtype=np.uint8)
    o = (S - size) // 2
    sample = j_preprocess_frames(jnp.asarray(chunk[:, o:o + size,
                                                   o:o + size]),
                                 jspec, modality, new_length)
    with unjitted():
        if arch == "BNInception":
            jqe = jq.calibrate_e2e(params["backbone"], stats["backbone"],
                                   sample, hybrid_stem=False)
        else:
            jqe = jiq.calibrate_e2e_iv3(params["backbone"],
                                        stats["backbone"], sample,
                                        hybrid_stem=False)
    assert "__stem__" not in jqe
    reg_stats = np.array([[0.0, 0.0], [0.1, 0.1]], np.float32)
    kw = dict(reg_stats=reg_stats, num_class=K, chunk_frames=3,
              modality=modality, quantize="e2e", shared_stem=True)
    with unjitted():
        jscorer = JScorer(jmodel, params, stats, jspec,
                          prequantized=(jqe, None), **kw)
        ref = np.asarray(jscorer._score_chunk(jnp.asarray(chunk), 3))
    jscorer.close()

    model = SSN(num_class=K, base_model=arch, modality=modality,
                dropout=0.0)
    model.load_state_dict(state_dict_from_jax(params, stats))
    with ProposalScorer(model, InputSpec(*astuple(jspec)), device="cpu",
                        prequantized=(quantized_from_jax(jqe), None),
                        **kw) as scorer:
        assert scorer.shared_stem
        got = scorer._score_chunk(torch.from_numpy(chunk), 3).numpy()
    assert got.shape == ref.shape and np.isfinite(got).all()
    d = np.abs(got - ref).max() / np.abs(ref).max()
    print(f"{arch} {modality} all-int8 shared stem: max |d| / max|ref| "
          f"{d:.2e}")
    np.testing.assert_allclose(got, ref, rtol=1e-5,
                               atol=1e-5 * np.abs(ref).max())
