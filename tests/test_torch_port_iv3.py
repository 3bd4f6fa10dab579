"""Port parity, InceptionV3: the kernels' plain versions at InceptionV3's
geometries (K1 with per-axis pads, K2 without padding, K3's exclude-pad
mode), BN folding and the scale algebra, the int8 trunk, the bf16 hybrid
stem, calibration, the float backbone, the shared stem and a scoring slice,
each held against its action_detection_tpu twin on the same numpy inputs.

JAX's InceptionV3 functions run un-jitted at 75^2 (InceptionV3's smallest
input: the stem gives 7^2, Mixed_6a 3^2, Mixed_7a 1^2), as they run op by
op in the port; the CUDA kernels' own cases are in
tests/test_torch_port_kernels_cuda.py (``cuda`` marker)."""

from contextlib import contextmanager
from dataclasses import astuple
from unittest import mock

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from action_detection_tpu.models.backbones import get_backbone as j_get_backbone
from action_detection_tpu.models.backbones import inception_v3_int8 as jq

from action_detection_torch.kernels import int8 as k
from action_detection_torch.models.backbones import get_backbone
from action_detection_torch.models.backbones import inception_v3_int8 as q
from action_detection_torch.models.convert import (quantized_from_jax,
                                                   seeded_init,
                                                   state_dict_from_jax)

from tests.test_torch_port_int8 import (  # noqa: F401 (fixture)
    _jitter, one_torch_thread)

HW = 75


@contextmanager
def unjitted():
    """Run JAX code that calls ``jax.jit`` op by op (the port's semantics;
    XLA's fusion of a whole jitted pass rounds bf16 differently)."""
    with mock.patch.object(jax, "jit", lambda f, **kw: f):
        yield


@pytest.fixture(scope="module")
def iv3_setup():
    """JAX InceptionV3 variables (jittered BN), the bridged port state_dict
    and a normalized 75^2 input batch."""
    jbb, _, _ = j_get_backbone("InceptionV3", "RGB")
    variables = _jitter(jbb.init(jax.random.PRNGKey(0),
                                 jnp.zeros((1, HW, HW, 3))), seed=3)
    params = jax.device_get(variables["params"])
    stats = jax.device_get(variables["batch_stats"])
    sd = state_dict_from_jax(params, stats)
    rng = np.random.RandomState(8)
    x = (rng.rand(3, HW, HW, 3) * 255.0 - 117.0).astype(np.float32)
    return jbb, variables, params, stats, sd, x


@pytest.fixture(scope="module")
def jax_qe(iv3_setup):
    """JAX's op-by-op calibration maxes and the e2e tree JAX builds from
    them (``calibrate_e2e_iv3`` with ``jax.jit`` as the identity)."""
    _, _, params, stats, _, x = iv3_setup
    folded = jq.fold_bn_iv3(params, stats)
    maxes = jax.device_get(jq._calibration_maxes_iv3(
        jax.tree_util.tree_map(jnp.asarray, folded), jnp.asarray(x)))
    with unjitted():
        qe = jq.calibrate_e2e_iv3(params, stats, jnp.asarray(x))
    return {n: float(v) for n, v in maxes.items()}, qe


# (N, H, W, C, O, (KH, KW), stride, pad) — every InceptionV3 conv geometry
CONV_CASES = [
    (2, 9, 8, 12, 16, (1, 1), 1, ((0, 0), (0, 0))),     # entry 1x1
    (2, 9, 9, 48, 20, (5, 5), 1, ((2, 2), (2, 2))),     # branch5x5_2
    (2, 9, 8, 16, 24, (3, 3), 1, ((1, 1), (1, 1))),     # branch3x3dbl_2
    (2, 11, 11, 8, 12, (3, 3), 2, ((0, 0), (0, 0))),    # Mixed_6a, 7a s2 VALID
    (2, 9, 9, 8, 16, (3, 3), 1, ((0, 0), (0, 0))),      # Conv2d_2a/4a VALID
    (2, 7, 6, 32, 24, (1, 7), 1, ((0, 0), (3, 3))),     # branch7x7_2
    (2, 7, 6, 32, 20, (7, 1), 1, ((3, 3), (0, 0))),     # branch7x7_3
    (3, 4, 5, 16, 12, (1, 3), 1, ((0, 0), (1, 1))),     # branch3x3_2a
    (3, 4, 5, 16, 12, (3, 1), 1, ((1, 1), (0, 0))),     # branch3x3_2b
]


def _conv_inputs(case, seed):
    N, H, W, C, O, (kh, kw), _, _ = case
    rng = np.random.RandomState(seed)
    x = rng.randint(0, 128, size=(N, H, W, C)).astype(np.int8)
    wq = rng.randint(-127, 128, size=(kh, kw, C, O)).astype(np.int8)
    m = (rng.rand(O) * 4.0 / (kh * kw * C * 64)).astype(np.float32)
    bq = (rng.randn(O) * 20).astype(np.float32)
    return x, wq, m, bq


@pytest.mark.parametrize("case", CONV_CASES)
def test_plain_conv_per_axis_pad_bit_exact(case):
    """K1's plain version with ``(pad_h, pad_w)`` against
    ``_ForwardOps._conv_layer``."""
    stride, pad = case[6], case[7]
    x, wq, m, bq = _conv_inputs(case, seed=sum(case[:5]))
    ref = np.asarray(jq._ForwardOps({})._conv_layer(jnp.asarray(x), {
        "wq": jnp.asarray(wq), "m": jnp.asarray(m), "bq": jnp.asarray(bq)},
        stride, pad))
    got = k.int8_conv(torch.from_numpy(x),
                      torch.from_numpy(wq.transpose(3, 0, 1, 2).copy()),
                      torch.from_numpy(m), torch.from_numpy(bq), stride,
                      q._pad_hw(pad))
    assert (ref > 0).mean() > 0.1 and ref.max() > 32     # not trivial
    np.testing.assert_array_equal(got.numpy(), ref)


def test_conv_pad_forms_and_rejections():
    """One int pads both axes; negative pads, C % 4 != 0 and asymmetric
    walker pads raise."""
    x, wq, m, bq = _conv_inputs(CONV_CASES[2], seed=1)
    args = (torch.from_numpy(x), torch.from_numpy(wq.transpose(3, 0, 1, 2)
                                                  .copy()),
            torch.from_numpy(m), torch.from_numpy(bq), 1)
    torch.testing.assert_close(k.int8_conv(*args, 1), k.int8_conv(*args,
                                                                   (1, 1)))
    with pytest.raises(ValueError, match="negative"):
        k.int8_conv(*args, (1, -1))
    with pytest.raises(ValueError, match="C % 4"):
        k.int8_conv(torch.zeros(1, 5, 5, 6, dtype=torch.int8),
                    torch.zeros(2, 1, 7, 6, dtype=torch.int8), torch.ones(2),
                    torch.zeros(2), 1, (0, 3))
    with pytest.raises(ValueError, match="asymmetric"):
        q._pad_hw(((0, 1), (0, 0)))


@pytest.mark.parametrize("hw", [(7, 7), (5, 9), (3, 4), (1, 1), (1, 6)])
def test_plain_avg_pool_exclude_pad_bit_exact(hw):
    """K3's exclude-pad plain version against ``avg_pool_same`` (divisors
    9, 6, 4 and, on 1-wide maps, 3 and 2), signed inputs with .5 ties."""
    rng = np.random.RandomState(hw[0] * 10 + hw[1])
    x = rng.randint(-128, 128, size=(4,) + hw + (24,)).astype(np.int8)
    ref = np.asarray(jq._ForwardOps({}).avg_pool_same(jnp.asarray(x)))
    got = k.int8_avg_pool_exclude_pad(torch.from_numpy(x), 3, 1, 1)
    np.testing.assert_array_equal(got.numpy(), ref)
    # the plain version's own form of the same op
    np.testing.assert_array_equal(
        k.int8_avg_pool_plain(torch.from_numpy(x), 3, 1, 1,
                              count_include_pad=False).numpy(), ref)
    counts = q.same_pool_counts(*hw).numpy()[0, 0]
    np.testing.assert_array_equal(
        counts, np.asarray(jq._same_pool_counts(*hw, jnp.float32))[0, ..., 0])
    if min(hw) > 1:
        sums = torch.nn.functional.avg_pool2d(
            torch.from_numpy(x).permute(0, 3, 1, 2).double(), 3, 1, 1,
            divisor_override=1).numpy()
        ties = (np.abs(np.abs(sums / counts) % 1 - 0.5) < 1e-9).sum()
        assert ties > 0, "no .5 ties in the input"


@pytest.mark.parametrize("hw", [(7, 7), (9, 12), (35, 35)])
def test_plain_max_pool_valid_bit_exact(hw):
    rng = np.random.RandomState(hw[1])
    x = rng.randint(-128, 128, size=(2,) + hw + (8,)).astype(np.int8)
    ref = np.asarray(jq._ForwardOps({}).max_pool(jnp.asarray(x)))
    got = k.int8_max_pool(torch.from_numpy(x), 3, 2, q._NOPAD)
    assert got.shape == ref.shape
    np.testing.assert_array_equal(got.numpy(), ref)


def test_fold_bn_and_scale_tree_exact(iv3_setup, jax_qe):
    """fold_bn_iv3 from the bridged state_dict equals JAX's fold, and the
    tree built from the same maxes equals JAX's, tensor for tensor."""
    _, _, params, stats, sd, _ = iv3_setup
    maxes, jqe = jax_qe
    folded = q.fold_bn_iv3(sd)
    ref = jq.fold_bn_iv3(params, stats)
    assert set(folded) == set(ref) and len(folded) == 94
    for name in ref:
        for leaf in ("kernel", "bias"):
            a, b = folded[name][leaf], np.asarray(ref[name][leaf])
            assert a.dtype == b.dtype == np.float32, name
            np.testing.assert_array_equal(a, b, err_msg=name)

    ours = q.quantize_iv3_e2e(folded, maxes)
    theirs = quantized_from_jax(jqe)
    assert set(ours) == set(theirs) == set(jqe)
    assert len(ours["__entry__"]) == 10 and len(ours["__stem__"]) == 5

    def check(a, b, path):
        if isinstance(a, dict):
            assert set(a) == set(b), path
            for key in a:
                check(a[key], b[key], path + "/" + key)
            return
        assert a.dtype == b.dtype and a.shape == b.shape, path
        assert torch.equal(a, b), path

    check(ours, theirs, "")


def test_int8_trunk_bit_exact(iv3_setup, jax_qe):
    """The port's int8 trunk (plain K1-K3, fused entry convs) fed JAX's
    stem output and the bridged tree: bit-exact activations and features."""
    _, jqe = jax_qe
    x = iv3_setup[5]
    h = np.array(jq._iv3_stem_quantized(jqe, jnp.asarray(x)))
    assert h.shape == (3, 7, 7, 192)
    qe = quantized_from_jax(jqe)

    class Acts(q._ForwardOps):          # the last concat, before the mean
        def finish(self, y):
            return y

    class JActs(jq._ForwardOps):
        def finish(self, y):
            return y

    ref = np.asarray(jq._walk_trunk(JActs(jqe), jnp.asarray(h)))
    got = q._walk_trunk(Acts(qe), torch.from_numpy(h))
    assert got.shape == ref.shape == (3, 1, 1, 2048) and ref.max() > 0
    np.testing.assert_array_equal(got.numpy(), ref)
    np.testing.assert_array_equal(
        q.iv3_trunk(qe, torch.from_numpy(h)).numpy(),
        np.asarray(jq._walk_trunk(jq._ForwardOps(jqe), jnp.asarray(h))))

    # the fused branch-entry convs change nothing numerically
    unfused = {k_: v for k_, v in qe.items() if k_ != "__entry__"}
    np.testing.assert_array_equal(
        q._walk_trunk(Acts(unfused), torch.from_numpy(h)).numpy(), ref)


def test_hybrid_stem_within_one_lsb(iv3_setup, jax_qe):
    """The bf16 stem rounds at other places than XLA's: its int8 output may
    differ by at most 1 LSB."""
    _, jqe = jax_qe
    x = iv3_setup[5]
    ref = np.asarray(jq._iv3_stem_quantized(jqe, jnp.asarray(x))) \
        .astype(np.int32)
    got = q._iv3_stem_quantized(quantized_from_jax(jqe),
                                torch.from_numpy(x)).numpy().astype(np.int32)
    assert got.shape == ref.shape == (3, 7, 7, 192)
    d = np.abs(got - ref)
    print(f"IV3 hybrid stem int8: {100 * (d > 0).mean():.3f}% of "
          f"{d.size} values differ, max |d| {d.max()}")
    assert d.max() <= 1


def test_calibration_maxes_close(iv3_setup, jax_qe):
    """The bf16 calibration forward against JAX's op-by-op one: every
    conv's max within 1% (bf16 convs accumulate in another order)."""
    _, _, _, _, sd, x = iv3_setup
    maxes, _ = jax_qe
    folded = q.fold_bn_iv3(sd)
    with torch.no_grad():
        ours = q._calibration_maxes_iv3(q._torch_folded(folded, "cpu"),
                                        torch.from_numpy(x))
    assert set(ours) == set(maxes) and len(ours) == 1 + 94
    worst = max(abs(ours[n] / maxes[n] - 1) for n in maxes)
    print(f"IV3 calibration maxes: worst relative difference {worst:.2e}")
    for name in maxes:
        np.testing.assert_allclose(ours[name], maxes[name], rtol=1e-2,
                                   err_msg=name)
    qe = q.calibrate_e2e_iv3(sd, torch.from_numpy(x))
    assert qe["__feat_scale__"].shape == (2048,)


@pytest.mark.parametrize("hw", [(HW, HW), (79, 83)])
def test_float_inceptionv3_matches_flax(iv3_setup, hw):
    """The float backbone through the weight bridge (strict load), at 75^2
    and at an odd size whose exclude-pad avg pools divide by 6 and 4 at
    the edges and corners."""
    jbb, variables, _, _, sd, _ = iv3_setup
    rng = np.random.RandomState(hw[1])
    x = (rng.rand(2, *hw, 3) * 255.0 - 117.0).astype(np.float32)
    ref = np.asarray(jbb.apply(variables, jnp.asarray(x)))
    bb, dim, spec = get_backbone("InceptionV3", "RGB")
    bb.load_state_dict(sd, strict=True)
    with torch.no_grad():
        got = bb.eval()(torch.from_numpy(x)).numpy()
    assert got.shape == ref.shape == (2, dim)
    for modality in ("RGB", "Flow"):
        assert astuple(get_backbone("InceptionV3", modality)[2]) == \
            astuple(j_get_backbone("InceptionV3", modality)[2])
    np.testing.assert_allclose(got, ref, rtol=1e-3, atol=1e-4)


def test_seeded_init_and_state_dict_names():
    """seeded_init handles bias-free convs; the module names are the
    tf-model-zoo checkpoint's, with 94 conv+BN pairs."""
    bb = seeded_init(get_backbone("InceptionV3", "Flow")[0], seed=0)
    names = list(bb.state_dict())
    assert "Conv2d_1a_3x3.conv.weight" in names
    assert "Mixed_5b.branch1x1.bn.running_var" in names
    assert "Mixed_7c.branch3x3dbl_3b.conv.weight" in names
    assert not any(n.endswith("conv.bias") for n in names)
    assert sum(n.endswith(".conv.weight") for n in names) == 94
    assert bb.Conv2d_1a_3x3.conv.weight.shape == (32, 10, 3, 3)
    assert bb.Conv2d_1a_3x3.conv.weight.abs().max() > 0


def test_sharedstem_features_match_jax(iv3_setup, jax_qe):
    """Shared-stem 10-crop features (stem once per frame and its flip,
    windows on the stride-8 grid) against JAX's from the same tree: crop-mean
    cosine > 0.995, the bound of tests/test_sharedstem.py."""
    from action_detection_tpu.data.transforms import \
        device_normed_pair as j_pair

    from action_detection_torch.data.transforms import device_normed_pair

    _, jqe = jax_qe
    rng = np.random.RandomState(4)
    frames = rng.randint(0, 256, size=(2, 96, 120, 3), dtype=np.uint8)
    spec = get_backbone("InceptionV3", "RGB")[2]
    jspec = j_get_backbone("InceptionV3", "RGB")[2]
    xn, fs = j_pair(jnp.asarray(frames), jspec, "RGB", 1)
    ref = np.asarray(jq.inception_v3_int8_e2e_features_sharedstem(
        jqe, xn, fs, HW), np.float64)
    txn, tfs = device_normed_pair(torch.from_numpy(frames), spec, "RGB", 1)
    got = q.inception_v3_int8_e2e_features_sharedstem(
        quantized_from_jax(jqe), txn, tfs, HW).double().numpy()
    assert got.shape == ref.shape == (20, 2048)
    rm = ref.reshape(10, 2, -1).mean(0)
    gm = got.reshape(10, 2, -1).mean(0)
    cos = min(np.dot(a, b) / (np.linalg.norm(a) * np.linalg.norm(b))
              for a, b in zip(rm, gm))
    print(f"IV3 shared-stem crop-mean features: min cos {cos:.6f}")
    assert np.isfinite(gm).all() and cos > 0.995, cos


def test_int8_sharedstem_slice_matches_jax(tmp_path):
    """InceptionV3 RGB, int8-e2e with the shared stem (the JAX CLI's
    default), end to end at 75^2 crops from 94x85 frames resized by the
    numpy resize: combined score within 0.12 of the JAX scorer's (run op by
    op), mAP within 0.005."""
    from tests.test_torch_port_scorer import check_int8_slice

    with unjitted():
        check_int8_slice(tmp_path, "InceptionV3", HW)
