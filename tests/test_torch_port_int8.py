"""Port parity, int8: the kernels' plain versions, the scale algebra, the
int8 trunk, the bf16 hybrid stem and calibration — each held against its
action_detection_tpu twin on the same inputs and weights.

The CUDA kernels themselves have no CPU mode: their cases are in
tests/test_torch_port_kernels_cuda.py (``cuda`` marker), and
``python3 chip_smoke.py`` holds them against the plain versions at the
slice's full shapes."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from action_detection_tpu.models import jitted_init
from action_detection_tpu.models.backbones import get_backbone as j_get_backbone
from action_detection_tpu.models.backbones import bn_inception_int8 as jq

from action_detection_torch.kernels import int8 as k
from action_detection_torch.models.backbones import bn_inception_int8 as q
from action_detection_torch.models.backbones.bn_inception import pool_pads
from action_detection_torch.models.convert import (quantized_from_jax,
                                                   state_dict_from_jax)


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One torch CPU thread a test. The suite runs on several workers at
    once, and torch's CPU convolutions slow down many times over when every
    worker's ops take all the cores (measured: six concurrent copies of a
    3.4 s test took 252 s each at 8 threads, 5.3 s at 1). The heavy test
    files import it (an autouse fixture applies where its name is)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jitter(variables, seed=0):
    """Realistic BN statistics and affine parameters (the tests/test_int8.py
    fixture's ranges), so quantization is not trivial."""
    rng = np.random.RandomState(seed)

    def leaf(path, x):
        name = path[-1].key
        scope = path[-2].key if len(path) >= 2 else ""
        x = np.asarray(x)
        if name == "mean":
            return jnp.asarray((0.05 * rng.randn(*x.shape)).astype(np.float32))
        if name == "var":
            return jnp.asarray((1.0 + 0.3 * rng.rand(*x.shape))
                               .astype(np.float32))
        if scope.endswith("_bn") and name == "scale":
            return jnp.asarray((1.0 + 0.1 * rng.randn(*x.shape))
                               .astype(np.float32))
        if scope.endswith("_bn") and name == "bias":
            return jnp.asarray((0.05 * rng.randn(*x.shape)).astype(np.float32))
        return jnp.asarray(x)

    return jax.tree_util.tree_map_with_path(leaf, variables)


@pytest.fixture(scope="module")
def bn_setup():
    """JAX BNInception variables at 64^2 (jitted init) + the bridged port
    state_dict + a normalized input batch."""
    backbone, _, _ = j_get_backbone("BNInception", "RGB")
    variables = _jitter(jitted_init(backbone, jax.random.PRNGKey(0),
                                    jnp.zeros((1, 64, 64, 3))))
    params = jax.device_get(variables["params"])
    stats = jax.device_get(variables["batch_stats"])
    sd = state_dict_from_jax(params, stats)
    rng = np.random.RandomState(6)
    x = (rng.rand(4, 64, 64, 3) * 255.0 - 117.0).astype(np.float32)
    return backbone, params, stats, sd, x


@pytest.fixture(scope="module")
def jax_qe(bn_setup):
    """JAX calibration maxes and the JAX e2e tree built from them.

    The maxes come from the JAX calibration pass run op by op: under
    ``jax.jit`` XLA fuses across the ops of the whole pass and rounds
    differently (its jitted maxes differ from its own op-by-op ones by up
    to ~2.3% on this fixture), while the port computes each op's stated
    rounding."""
    _, params, stats, _, x = bn_setup
    folded = jq.fold_bn(params, stats)
    q0 = jq.quantize_backbone(params, stats, folded=folded)
    stem = {n: jax.tree_util.tree_map(jnp.asarray, folded[n])
            for n in q.STEM_CONVS}
    maxes = jax.device_get(jq._e2e_output_maxes(q0, jnp.asarray(x), stem))
    qe = jq.quantize_backbone_e2e(params, stats, maxes, folded=folded)
    return maxes, qe


CONV_CASES = [  # (N, H, W, C, O, k, stride, pad)
    (2, 9, 9, 32, 24, 1, 1, 0),
    (2, 9, 9, 16, 40, 3, 1, 1),
    (2, 10, 11, 8, 12, 3, 2, 1),
    (1, 7, 7, 64, 20, 3, 2, 1),
]


@pytest.mark.parametrize("case", CONV_CASES)
def test_plain_conv_e2e_bit_exact(case):
    N, H, W, C, O, kk, stride, pad = case
    rng = np.random.RandomState(sum(case))
    x = rng.randint(0, 128, size=(N, H, W, C)).astype(np.int8)
    wq = rng.randint(-127, 128, size=(kk, kk, C, O)).astype(np.int8)
    m = (rng.rand(O) * 4.0 / (kk * kk * C * 64)).astype(np.float32)
    bq = (rng.randn(O) * 20).astype(np.float32)
    ref = np.asarray(jq._conv_i8_e2e(jnp.asarray(x), {
        "wq": jnp.asarray(wq), "m": jnp.asarray(m), "bq": jnp.asarray(bq)},
        stride=stride, pad=pad))
    got = k.int8_conv(torch.from_numpy(x),
                      torch.from_numpy(wq.transpose(3, 0, 1, 2).copy()),
                      torch.from_numpy(m), torch.from_numpy(bq), stride, pad)
    assert (ref > 0).mean() > 0.1 and ref.max() > 32   # not trivial
    np.testing.assert_array_equal(got.numpy(), ref)


def test_plain_conv_on_channel_slice():
    """K1 reads a channel slice (the fused entry conv's split heads) in
    place: same result as on a contiguous copy."""
    rng = np.random.RandomState(3)
    x = torch.from_numpy(rng.randint(0, 128, size=(2, 6, 6, 24))
                         .astype(np.int8))
    w = torch.from_numpy(rng.randint(-127, 128, size=(8, 3, 3, 8))
                         .astype(np.int8))
    m, b = torch.full((8,), 1e-3), torch.zeros(8)
    np.testing.assert_array_equal(
        k.int8_conv(x[..., 8:16], w, m, b, 1, 1).numpy(),
        k.int8_conv(x[..., 8:16].contiguous(), w, m, b, 1, 1).numpy())


@pytest.mark.parametrize("name,stride,pad", [
    ("inception_3a_3x3", 1, 1), ("inception_3c_3x3", 2, 1),
    ("inception_4a_pool_proj", 1, 0)])
def test_calibration_conv_bit_exact(bn_setup, name, stride, pad):
    """K1's bf16 epilogue inside the per-layer calibration face vs
    ``_conv_int8`` (dynamic scale, s32 conv, ``y*(sx*sw)+b``, ReLU, bf16)."""
    _, params, stats, sd, _ = bn_setup
    jlayer = jq.quantize_backbone(params, stats)[name]
    layer = q.quantize_backbone(sd)[name]
    C = jlayer["wq"].shape[2]
    rng = np.random.RandomState(5)
    x = (rng.rand(2, 8, 8, C) * 30).astype(np.float32)
    xb = jnp.asarray(x, jnp.bfloat16)
    ref = jq._conv_int8(xb, jlayer, stride=stride, pad=pad)
    got = q._PerLayerOps({name: layer}).conv(
        torch.from_numpy(x).to(torch.bfloat16), name, stride, pad)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                  np.asarray(ref).view(np.int16))


@pytest.mark.parametrize("hw,kw", [
    ((9, 9), dict(kernel=3, stride=2, ceil=True)),
    ((8, 11), dict(kernel=3, stride=2, ceil=True)),
    ((7, 7), dict(kernel=3, stride=1, pad=1)),
    ((14, 14), dict(kernel=3, stride=2, ceil=True)),   # 4e: 14 -> 7
    ((27, 29), dict(kernel=3, stride=2, ceil=True)),   # ragged: 13 x 14
    ((9, 11), dict(kernel=3, stride=1, pad=1))])
def test_plain_max_pool_bit_exact(hw, kw):
    """On uniform signed inputs, and on inputs of -128 and other negative
    values with windows of -128 alone at the bottom-right (padded) edge:
    padding must never win."""
    rng = np.random.RandomState(hw[0] * hw[1])
    uniform = rng.randint(-128, 128, size=(2,) + hw + (8,)).astype(np.int8)
    negative = rng.choice(np.array([-128, -128, -127, -100, -1], np.int8),
                          size=uniform.shape)
    negative[:, -3:, -3:, ::2] = -128
    pads = pool_pads(hw[0], hw[1], **kw)
    for x in (uniform, negative):
        ref = np.asarray(jq._max_pool_i8(jnp.asarray(x), **kw))
        got = k.int8_max_pool(torch.from_numpy(x), kw["kernel"],
                              kw["stride"], pads)
        np.testing.assert_array_equal(got.numpy(), ref)
    assert (ref == -128).any() and (ref > -128).any()


@pytest.mark.parametrize("hw", [(7, 7), (10, 13)])
def test_plain_avg_pool_bit_exact(hw):
    rng = np.random.RandomState(hw[1])
    x = rng.randint(-128, 128, size=(2,) + hw + (16,)).astype(np.int8)
    ref = np.asarray(jq._avg_pool_i8_include_pad(jnp.asarray(x), 3, 1, 1))
    got = k.int8_avg_pool(torch.from_numpy(x), 3, 1, 1)
    np.testing.assert_array_equal(got.numpy(), ref)


def test_wrappers_reject_what_the_kernels_do_not_take():
    x = torch.zeros(1, 4, 4, 6, dtype=torch.int8)
    w = torch.zeros(2, 1, 1, 6, dtype=torch.int8)
    with pytest.raises(ValueError, match="C % 4"):
        k.int8_conv(x, w, torch.ones(2), torch.zeros(2))
    with pytest.raises(ValueError, match="int8"):
        k.int8_conv(x.float(), w, torch.ones(2), torch.zeros(2))
    with pytest.raises(ValueError, match="int8"):
        k.int8_max_pool(x.float(), 3, 2, ((0, 1), (0, 1)))


def test_quantize_backbone_e2e_tree_exact(bn_setup, jax_qe):
    _, _, _, sd, _ = bn_setup
    maxes, jqe = jax_qe
    ours = q.quantize_backbone_e2e(sd, {k_: float(v) for k_, v in
                                        maxes.items()})
    ref = quantized_from_jax(jqe)
    assert set(ours) == set(ref) == set(jqe)
    assert len(ours["__entry__"]) == 10

    def check(a, b, path):
        if isinstance(a, dict):
            assert set(a) == set(b), path
            for key in a:
                check(a[key], b[key], path + "/" + key)
            return
        assert a.dtype == b.dtype and a.shape == b.shape, path
        assert torch.equal(a, b), path

    check(ours, ref, "")


def test_e2e_trunk_bit_exact(jax_qe, bn_setup):
    """The port's int8 trunk (plain K1-K3, fused entry convs) fed the JAX
    stem's int8 output and the bridged tree: bit-exact features."""
    _, jqe = jax_qe
    x = bn_setup[4]
    h = np.array(jq._e2e_stem_quantized(jqe, jnp.asarray(x)))
    ref = np.asarray(jq._e2e_trunk(jqe, jnp.asarray(h)))
    got = q._e2e_trunk(quantized_from_jax(jqe), torch.from_numpy(h))
    assert got.shape == (4, 1024)
    np.testing.assert_array_equal(got.numpy(), ref)

    # the fused branch-entry convs change nothing numerically
    unfused = {k_: v for k_, v in quantized_from_jax(jqe).items()
               if k_ != "__entry__"}
    np.testing.assert_array_equal(
        q._e2e_trunk(unfused, torch.from_numpy(h)).numpy(), ref)


def test_hybrid_stem_within_one_lsb(jax_qe, bn_setup):
    """The bf16 stem rounds at other places than XLA's: its int8 output may
    differ by at most 1 LSB."""
    _, jqe = jax_qe
    x = bn_setup[4]
    ref = np.asarray(jq._e2e_stem_quantized(jqe, jnp.asarray(x))) \
        .astype(np.int32)
    got = q._e2e_stem_quantized(quantized_from_jax(jqe),
                                torch.from_numpy(x)).numpy().astype(np.int32)
    assert got.shape == ref.shape == (4, 8, 8, 192)
    d = np.abs(got - ref)
    print(f"hybrid stem int8: {100 * (d > 0).mean():.3f}% of "
          f"{d.size} values differ, max |d| {d.max()}")
    assert d.max() <= 1


def test_calibrate_e2e_maxes_close(bn_setup, jax_qe):
    _, _, _, sd, x = bn_setup
    maxes, _ = jax_qe
    folded = q.fold_bn(sd)
    q0 = q.quantize_backbone(sd, folded=folded)
    stem = {n: {"kernel": torch.from_numpy(folded[n]["kernel"])
                .permute(3, 2, 0, 1), "bias": torch.from_numpy(
                    folded[n]["bias"])} for n in q.STEM_CONVS}
    with torch.no_grad():
        ours = q._e2e_output_maxes(q0, torch.from_numpy(x), stem)
    assert set(ours) == set(maxes)
    assert len(ours) == 1 + 3 + 66    # input, 3 stem convs, 66 trunk convs
    for name in maxes:
        np.testing.assert_allclose(ours[name], float(maxes[name]), rtol=1e-2,
                                   err_msg=name)
    qe = q.calibrate_e2e(sd, torch.from_numpy(x))
    assert qe["__feat_scale__"].shape == (1024,)
