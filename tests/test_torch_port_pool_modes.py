"""Port parity, the max-pool backward modes of ``ops/pooling.py``:
``set_pool_backward("sas" | "eq_mask" | "pallas")``, ``pool_backward``,
``set_eq_mask`` and ``eq_mask_enabled`` with the JAX package's names,
values and errors; each mode's gradient against the JAX package's
``max_pool_2d`` VJP in the same mode on the same numpy inputs (the
geometries of tests/test_pooling.py); tie routing, stride-1 dispatch and
the integer forward.

On CPU tensors the first-match modes (``"pallas"``, ``"sas"`` and
eq-mask's stride-1 pools) run A1's wrapper on its plain version; A1 itself
is held against it on the card (tests/test_torch_port_kernels_cuda.py and
``chip_smoke.py``)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from action_detection_tpu.ops import pooling as jpool

from action_detection_torch.models.backbones.bn_inception import max_pool
from action_detection_torch.ops import pooling

CONFIGS = [
    # kernel, stride, padding, H, W  (tests/test_pooling.py:21-32)
    (3, 2, ((0, 1), (0, 1)), 112, 112),   # BNInception stem pool1 (ceil)
    (3, 2, ((0, 1), (0, 1)), 56, 56),     # stem pool2 (ceil)
    (3, 1, ((1, 1), (1, 1)), 28, 28),     # trunk stride-1 max branch
    (3, 2, ((0, 0), (0, 0)), 35, 35),     # InceptionV3 VALID grid reduce
    (2, 2, ((0, 0), (0, 0)), 32, 32),     # VGG
    (3, 2, ((1, 1), (1, 1)), 112, 112),   # ResNet stem
    (3, 2, ((0, 2), (0, 1)), 17, 23),     # asymmetric odd shape
    (2, 3, ((0, 0), (0, 0)), 13, 13),     # stride > kernel (gap residues)
    (3, 3, ((1, 1), (1, 1)), 15, 15),     # stride == kernel
]
MODES = ("sas", "eq_mask", "pallas")


@pytest.fixture(autouse=True)
def restore_modes():
    """Each test leaves both packages' modes as it found them (the state
    is process-wide and other tests share the worker)."""
    port, jax_mode = pooling.pool_backward(), jpool.pool_backward()
    yield
    pooling.set_pool_backward(port)
    jpool.set_pool_backward(jax_mode)


def set_both(mode: str) -> None:
    """The same backward mode in the port and in the JAX package (JAX's
    ``"pallas"`` is its Pallas kernel in interpret mode here)."""
    pooling.set_pool_backward(mode)
    jpool.set_pool_backward(mode)


def tied_input(shape, seed):
    """Post-ReLU-like float32 input on a coarse grid: many exact zeros and
    other ties inside windows, where the modes differ."""
    rng = np.random.RandomState(seed)
    return np.round(np.maximum(rng.randn(*shape), 0) * 4).astype(
        np.float32) / 4


def grads(x, dy, kernel, stride, pad):
    """(port dx, JAX dx) of ``max_pool_2d`` at ``x`` against ``dy``, each
    package in its current mode, and the two forwards."""
    y, vjp = jax.vjp(lambda v: jpool.max_pool_2d(v, kernel, stride, pad),
                     jnp.asarray(x))
    (g_ref,) = vjp(jnp.asarray(dy))
    xt = torch.from_numpy(x).requires_grad_()
    yt = pooling.max_pool_2d(xt, kernel, stride, pad)
    (g,) = torch.autograd.grad(yt, xt, torch.from_numpy(dy))
    np.testing.assert_array_equal(yt.detach().float().numpy(),
                                  np.asarray(y, np.float32))
    return g, np.asarray(g_ref)


def test_default_is_pallas_first_match():
    """The port's default is A1 (``"pallas"``), first-match like the JAX
    default (``"sas"``): a tied window routes one dy."""
    assert pooling.pool_backward() == "pallas"
    assert not pooling.eq_mask_enabled()
    x = torch.zeros((1, 2, 2, 1), requires_grad=True)
    pooling.max_pool_2d(x, 2, 2, ((0, 0), (0, 0))).sum().backward()
    assert x.grad.flatten().tolist() == [1.0, 0.0, 0.0, 0.0]


def test_mode_api_and_validation():
    """``set_pool_backward`` returns the previous mode and refuses unknown
    ones with JAX's message; ``set_eq_mask`` returns whether eq-mask WAS on
    and its False selects ``"sas"`` (overriding ``"pallas"``)."""
    for mode in MODES:
        prev = pooling.set_pool_backward(mode)
        assert pooling.set_pool_backward(prev) == mode
    with pytest.raises(ValueError, match="unknown pool backward mode"):
        pooling.set_pool_backward("cuda")
    with pytest.raises(ValueError, match="unknown pool backward mode"):
        jpool.set_pool_backward("cuda")
    assert pooling.pool_backward() in MODES

    pooling.set_pool_backward("pallas")
    assert pooling.set_eq_mask(True) is False
    assert pooling.eq_mask_enabled() and pooling.pool_backward() == "eq_mask"
    assert pooling.set_eq_mask(False) is True
    assert pooling.pool_backward() == "sas" and not pooling.eq_mask_enabled()
    assert pooling.set_eq_mask(False) is False


def test_set_eq_mask_toggles_and_restores():
    """tests/test_pooling.py:137-152: enabling gives eq-mask tie routing to
    pools run after the call, disabling restores first-match."""
    x = torch.zeros((1, 2, 2, 1), requires_grad=True)

    def grad_sum():
        (g,) = torch.autograd.grad(
            pooling.max_pool_2d(x, 2, 2, ((0, 0), (0, 0))).sum(), x)
        return float(g.sum())

    pooling.set_pool_backward("sas")
    prev = pooling.set_eq_mask(True)
    assert prev is False and pooling.eq_mask_enabled()
    assert grad_sum() == 4.0             # eq-mask: every tied position
    pooling.set_eq_mask(False)
    assert grad_sum() == 1.0             # first-match again
    pooling.set_eq_mask(prev)
    assert not pooling.eq_mask_enabled()


@pytest.mark.parametrize("kernel,stride,pad,H,W", CONFIGS)
def test_eq_mask_vjp_matches_jax(kernel, stride, pad, H, W):
    """The eq-mask backward against JAX's ``max_pool`` VJP on tied input
    with a non-uniform dy, within 1e-6 (stride-1 pools: both first-match)."""
    set_both("eq_mask")
    x = tied_input((2, H, W, 5), seed=H + W + kernel)
    dy_shape = ((2,) + pooling.pool_out_hw(H, W, (kernel,) * 2,
                                           (stride,) * 2, pad) + (5,))
    dy = np.random.RandomState(H).randn(*dy_shape).astype(np.float32)
    g, g_ref = grads(x, dy, kernel, stride, pad)
    np.testing.assert_allclose(g.numpy(), g_ref, rtol=1e-6, atol=1e-6)
    if stride > 1:
        # ties route dy to every maximal position: not first-match
        pooling.set_pool_backward("sas")
        first, _ = grads(x, dy, kernel, stride, pad)
        assert not torch.equal(first, g)


@pytest.mark.parametrize("kernel,stride,pad,H,W", CONFIGS)
def test_first_match_modes_match_jax_and_each_other(kernel, stride, pad, H,
                                                    W):
    """``"sas"`` and ``"pallas"`` (both A1's route) against JAX's
    SelectAndScatter on tied input: the same first-match gradient, and the
    two port modes equal bit for bit."""
    x = tied_input((2, H, W, 3), seed=H * 31 + W)
    dy_shape = ((2,) + pooling.pool_out_hw(H, W, (kernel,) * 2,
                                           (stride,) * 2, pad) + (3,))
    dy = (np.random.RandomState(W).randint(1, 8, size=dy_shape)
          .astype(np.float32))
    jpool.set_pool_backward("sas")
    out = {}
    for mode in ("sas", "pallas"):
        pooling.set_pool_backward(mode)
        out[mode], g_ref = grads(x, dy, kernel, stride, pad)
        np.testing.assert_allclose(out[mode].numpy(), g_ref, rtol=1e-6,
                                   atol=1e-6)
    assert torch.equal(out["sas"], out["pallas"])


def test_eq_mask_bf16_matches_jax():
    """bf16 (the ``--bf16`` trainer's dtype): distinct bf16-exact values
    (tests/test_pooling.py:91), the eq-mask sums in bf16 as JAX's."""
    set_both("eq_mask")
    rng = np.random.RandomState(3)
    x = rng.permutation(256).reshape(2, 4, 4, 8).astype(np.float32)
    pad = ((0, 1), (0, 1))
    g_ref = jax.grad(lambda v: jpool.max_pool_2d(v, 3, 2, pad).astype(
        jnp.float32).sum())(jnp.asarray(x, jnp.bfloat16))
    xt = torch.from_numpy(x).to(torch.bfloat16).requires_grad_()
    pooling.max_pool_2d(xt, 3, 2, pad).float().sum().backward()
    assert xt.grad.dtype == torch.bfloat16
    np.testing.assert_array_equal(xt.grad.float().numpy(),
                                  np.asarray(g_ref, np.float32))


def test_tie_routing_documented_divergence():
    """tests/test_pooling.py:106: an all-tied window routes a full dy to
    every position under eq-mask, one under first-match."""
    x = np.zeros((1, 2, 2, 1), np.float32)
    dy = np.ones((1, 1, 1, 1), np.float32)
    set_both("eq_mask")
    g, g_ref = grads(x, dy, 2, 2, ((0, 0), (0, 0)))
    assert g.flatten().tolist() == [1.0, 1.0, 1.0, 1.0]
    np.testing.assert_array_equal(g.numpy(), g_ref)
    for mode in ("sas", "pallas"):
        pooling.set_pool_backward(mode)
        g, _ = grads(x, dy, 2, 2, ((0, 0), (0, 0)))
        assert float(g.sum()) == 1.0


def test_stride1_dispatches_to_first_match():
    """tests/test_pooling.py:119: under eq-mask a stride-1 pool keeps
    first-match (one dy unit per window), as JAX's plain AD."""
    set_both("eq_mask")
    x = np.zeros((1, 3, 3, 1), np.float32)
    g, g_ref = grads(x, np.ones((1, 3, 3, 1), np.float32), 3, 1,
                     ((1, 1), (1, 1)))
    np.testing.assert_array_equal(g.numpy(), g_ref)
    assert float(g.sum()) == 9.0


@pytest.mark.parametrize("mode,stride,a1", [
    ("pallas", 2, True), ("pallas", 1, True), ("sas", 2, True),
    ("sas", 1, True), ("eq_mask", 2, False), ("eq_mask", 1, True)])
def test_first_match_backward_runs_a1(monkeypatch, mode, stride, a1):
    """Every first-match backward goes through A1's wrapper (on the card
    the kernel, here its plain version): ``"pallas"``, ``"sas"`` and
    eq-mask's stride-1 pools; eq-mask's strided pools do not."""
    calls = []
    real = pooling.max_pool_bwd

    def counted(*args):
        calls.append(args[3:])
        return real(*args)

    monkeypatch.setattr(pooling, "max_pool_bwd", counted)
    pooling.set_pool_backward(mode)
    x = torch.from_numpy(tied_input((2, 9, 9, 3), seed=stride)
                         ).requires_grad_()
    pad = ((1, 1), (1, 1))
    pooling.max_pool_2d(x, 3, stride, pad).sum().backward()
    assert calls == ([((3, 3), (stride, stride), pad)] if a1 else [])


@pytest.mark.parametrize("mode", MODES)
def test_int_dtype_forward(mode):
    """tests/test_pooling.py:155: integer inputs pool forward only (the
    dtype's minimum as padding) in every mode: int32 equal to JAX's (whose
    ``max_pool_2d`` refuses int8), int8 equal to K2's plain version."""
    from action_detection_torch.kernels.int8 import int8_max_pool_plain

    set_both(mode)
    rng = np.random.RandomState(1)
    x = rng.randint(-128, 128, size=(2, 9, 8, 3))
    for kernel, stride, pad in ((3, 2, ((0, 1), (0, 1))),
                                (3, 1, ((1, 1), (1, 1))),
                                (2, 2, ((0, 0), (0, 0)))):
        x32 = x.astype(np.int32)
        y = pooling.max_pool_2d(torch.from_numpy(x32), kernel, stride, pad)
        ref = np.asarray(jpool.max_pool_2d(jnp.asarray(x32), kernel, stride,
                                           pad))
        assert y.dtype == torch.int32
        np.testing.assert_array_equal(y.numpy(), ref)
        x8 = torch.from_numpy(x.astype(np.int8))
        y8 = pooling.max_pool_2d(x8, kernel, stride, pad)
        assert y8.dtype == torch.int8
        np.testing.assert_array_equal(
            y8.numpy(), int8_max_pool_plain(x8, kernel, stride, pad).numpy())


def test_rank_contract_is_explicit():
    with pytest.raises(ValueError, match="rank-4"):
        pooling.max_pool_2d(torch.zeros((2, 3, 4, 4, 5)), 2, 2,
                            ((0, 0), (0, 0)))


@pytest.mark.parametrize("mode", MODES)
def test_backbone_stem_grad_matches_jax(mode):
    """Through the BNInception stem's two Caffe-ceil pools with a random
    conv between them (tests/test_pooling.py:269): the input gradient in
    each mode against JAX's in the same mode, on tied post-ReLU input."""
    from action_detection_tpu.models.backbones.bn_inception import _max_pool

    set_both(mode)
    x = tied_input((2, 56, 56, 4), seed=13)
    w = np.random.RandomState(11).randn(3, 3, 4, 4).astype(np.float32)

    def j_stem(v):
        v = _max_pool(v, 3, 2, ceil=True)
        v = jax.lax.conv_general_dilated(
            v, jnp.asarray(w), (1, 1), ((1, 1), (1, 1)),
            dimension_numbers=("NHWC", "HWIO", "NHWC"))
        return (_max_pool(jnp.maximum(v, 0), 3, 2, ceil=True) ** 2).sum()

    def stem(v):
        v = max_pool(v.permute(0, 3, 1, 2), 3, 2, ceil=True)
        v = torch.nn.functional.conv2d(
            v, torch.from_numpy(w.transpose(3, 2, 0, 1).copy()), padding=1)
        return (max_pool(torch.relu(v), 3, 2, ceil=True) ** 2).sum()

    g_ref = np.asarray(jax.grad(j_stem)(jnp.asarray(x)))
    xt = torch.from_numpy(x).requires_grad_()
    stem(xt).backward()
    np.testing.assert_allclose(xt.grad.numpy(), g_ref, rtol=1e-5,
                               atol=1e-5 * np.abs(g_ref).max())
