"""A1's tile plan (``kernels/pool_bwd.py:pool_bwd_plan``) on the CPU.

The CUDA kernel has no CPU mode (its cases are in
tests/test_torch_port_kernels_cuda.py), so its tiling is held here twice:
the plan's invariants (every input cell owned once, every covering window
resolved by the owner, every cell of those windows staged, the shared
memory laid out inside the limit), and a numpy model of the kernel's two
phases on the plan's tiles — first-match offsets per window, then a gather
in (oy, ox) order in float32 — bit-exact against A1's plain version, the
JAX SelectAndScatter VJP and, for strided pools, the Pallas kernel in
interpret mode."""

import itertools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import linen as fnn

from action_detection_tpu.ops.pool_bwd_pallas import max_pool_bwd_pallas

from action_detection_torch.kernels import pool_bwd as a1
from action_detection_torch.models.backbones.bn_inception import pool_pads

from tests.test_torch_port_train import POOL_CASES, _pool_input

# the five float max pools of BNInception (kernel, stride, padding, H, W, C)
BN_POOLS = [(3, 2, pool_pads(112, 112, 3, 2, ceil=True), 112, 112, 64),
            (3, 2, pool_pads(56, 56, 3, 2, ceil=True), 56, 56, 192),
            (3, 2, pool_pads(28, 28, 3, 2, ceil=True), 28, 28, 320),
            (3, 2, pool_pads(14, 14, 3, 2, ceil=True), 14, 14, 576),
            (3, 1, pool_pads(7, 7, 3, 1, pad=1), 7, 7, 1024)]
GEOMETRIES = [c + (5,) for c in POOL_CASES] + BN_POOLS


def _plan(case, bf16=False, vec=None, **kw):
    k, s, pad, H, W, C = case
    if vec is None:
        vec = 1 if C % (8 if bf16 else 4) else (8 if bf16 else 4)
    return a1.pool_bwd_plan((2, H, W, C), (k, k), (s, s), pad, bf16, vec,
                            **kw)


def _covering(i, size_out, k, s, pad):
    """Windows that cover input index i along one axis, by brute force."""
    return [w for w in range(size_out) if 0 <= i - (w * s - pad) < k]


@pytest.mark.parametrize("tile_windows", [1, 2, 3, a1.TILE_WINDOWS])
@pytest.mark.parametrize("case", GEOMETRIES)
def test_plan_tiles_cover_the_image(case, tile_windows):
    """Every input cell is owned by one tile; every window covering an
    owned cell is in that tile's window range; the x cells the tile stages
    hold every in-image cell of those windows; the tile fits the plan's
    shared-memory extents."""
    k, s, pad, H, W, C = case
    plan = _plan(case, tile_windows=tile_windows)
    for axis, (size, size_out, p, extent, staged, tiles) in enumerate(zip(
            (H, W), (plan.Ho, plan.Wo), (pad[0][0], pad[1][0]),
            (plan.win_h, plan.win_w), (plan.xs_h, plan.xs_w),
            a1.plan_tiles(plan))):
        owned = []
        for lo, hi, w0, w1 in tiles:
            owned += range(lo, hi)
            cover = set()
            for i in range(lo, hi):
                cover.update(_covering(i, size_out, k, s, p))
            assert cover == set(range(w0, w1 + 1)), (axis, lo)
            if w1 < w0:
                continue
            assert w1 - w0 + 1 <= extent
            first = w0 * s - p              # the tile's shared index 0
            need = {w * s - p + j for w in range(w0, w1 + 1)
                    for j in range(k)} & set(range(size))
            lo_x, hi_x = max(first, 0), min((w1 - w0) * s + k + first, size)
            assert need <= set(range(lo_x, hi_x))   # gap cells: staged too
            assert {lo_x, hi_x - 1} <= need
            assert hi_x - first <= staged
        assert owned == list(range(size)), axis
    assert (plan.slabs - 1) * plan.slab < C <= plan.slabs * plan.slab
    assert plan.block_x * plan.block_y <= a1.THREADS
    assert plan.slab % plan.vec == 0 and plan.block_x * plan.vec == plan.slab


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("case", BN_POOLS)
def test_plan_shared_memory_layout(case, bf16):
    """The regions (x, y, dy, offsets, cover tables) are 16-byte aligned,
    do not overlap and fit the limit; BNInception's pools take 16-byte
    vectors and the default 8x8-window tile, whose slab is 128 bytes wide
    except on 5b's 7x7 images, where it doubles so that a block has two
    cells per thread to gather."""
    plan = _plan(case, bf16=bf16)
    es = 2 if bf16 else 4
    win = plan.win_h * plan.win_w * plan.slab
    wide = 2 if case[3] == 7 else 1
    assert plan.vec * es == 16 and plan.slab * es == wide * a1.SLAB_BYTES
    cells = min(plan.tile_h, plan.H) * min(plan.tile_w, plan.W)
    assert cells * plan.block_x >= 2 * a1.THREADS
    assert plan.tile_h == a1.TILE_WINDOWS * plan.sh
    ends = [(0, plan.xs_h * plan.xs_w * plan.slab * es),
            (plan.y_off, plan.y_off + win * es),
            (plan.dy_off, plan.dy_off + win * es),
            (plan.fm_off, plan.fm_off + win),
            (plan.cov_off, plan.smem)]
    for (a, b), (c, _) in zip(ends, ends[1:]):
        assert a % 16 == 0 and b <= c
    assert plan.smem == plan.cov_off + 8 * (plan.tile_h + plan.tile_w)
    assert plan.smem <= a1.SMEM_LIMIT
    assert len(plan) == len(a1.PLAN_FIELDS)


def test_plan_shrinks_to_fit_and_refuses_what_the_kernel_cannot_take():
    # a wide window: the slab halves, then the tile shrinks, until it fits
    big = a1.pool_bwd_plan((1, 200, 200, 256), (15, 15), (1, 1),
                           ((7, 7), (7, 7)), False, 4)
    assert big.smem <= a1.SMEM_LIMIT and big.slab < 32
    with pytest.raises(ValueError, match="at most 254"):
        a1.pool_bwd_plan((1, 40, 40, 4), (16, 16), (1, 1),
                         ((0, 0), (0, 0)), False, 4)
    with pytest.raises(ValueError, match="vec"):
        a1.pool_bwd_plan((1, 9, 9, 6), (3, 3), (2, 2), ((0, 0), (0, 0)),
                         False, 4)
    with pytest.raises(ValueError, match="2\\*\\*31"):
        a1.pool_bwd_plan((1, 2 ** 12, 2 ** 12, 128), (3, 3), (2, 2),
                         ((0, 1), (0, 1)), False, 4)


def _model(x, y, dy, plan):
    """The kernel's two phases in numpy, tile by tile (channels are
    independent, so the slabs need no loop). x, y, dy: float32 arrays that
    hold the storage dtype's values exactly."""
    kh, kw, sh, sw = plan.kh, plan.kw, plan.sh, plan.sw
    N, H, W, C = x.shape
    dx = np.full(x.shape, np.nan, np.float32)
    rows, cols = a1.plan_tiles(plan)
    for (r0, r1, oy0, oy1), (c0, c1, ox0, ox1) in itertools.product(rows,
                                                                    cols):
        nwy, nwx = max(oy1 - oy0 + 1, 0), max(ox1 - ox0 + 1, 0)
        xr, xc = oy0 * sh - plan.pad_top, ox0 * sw - plan.pad_left
        # phase 1: first-match offset per (window, channel); padding cells
        # are skipped by index
        fm = np.full((N, nwy, nwx, C), a1.NO_MATCH, np.int32)
        for a, b in itertools.product(range(nwy), range(nwx)):
            m = y[:, oy0 + a, ox0 + b]
            for ky, kx in reversed(list(itertools.product(range(kh),
                                                          range(kw)))):
                iy, ix = xr + a * sh + ky, xc + b * sw + kx
                if 0 <= iy < H and 0 <= ix < W:
                    fm[:, a, b] = np.where(x[:, iy, ix] == m, ky * kw + kx,
                                           fm[:, a, b])
        # phase 2: each owned cell gathers in (oy, ox) order, f32 from 0
        for iy, ix in itertools.product(range(r0, r1), range(c0, c1)):
            acc = np.zeros((N, C), np.float32)
            for a, b in itertools.product(range(nwy), range(nwx)):
                ky, kx = iy - (xr + a * sh), ix - (xc + b * sw)
                if 0 <= ky < kh and 0 <= kx < kw:
                    hit = fm[:, a, b] == ky * kw + kx
                    acc = acc + np.where(hit, dy[:, oy0 + a, ox0 + b],
                                         np.float32(0))
            assert np.isnan(dx[:, iy, ix]).all(), "cell owned twice"
            dx[:, iy, ix] = acc
    assert not np.isnan(dx).any(), "cell owned by no tile"
    return dx


def _f32(a):
    return np.array(a.astype(jnp.float32))


def _case_inputs(case, kind, seed):
    kernel, stride, pad, H, W = case
    x_np, jdt = _pool_input(H, W, kind, seed=seed)
    k2, s2 = (kernel, kernel), (stride, stride)
    x = jnp.asarray(x_np, jdt)
    y = fnn.max_pool(x, k2, strides=s2, padding=list(pad))
    return x, y, k2, s2, pad, jdt == jnp.bfloat16


def _model_dx(x, y, dy, k2, s2, pad, bf16, tile_windows):
    """The model's dx in the storage dtype, on a plan with several tiles
    per axis (the last one ragged)."""
    plan = a1.pool_bwd_plan(tuple(x.shape), k2, s2, pad, bf16, 1,
                            tile_windows=tile_windows)
    rows, cols = a1.plan_tiles(plan)
    assert len(rows) >= 2 and len(cols) >= 2
    acc = _model(_f32(x), _f32(y), _f32(dy), plan)
    return torch.from_numpy(acc).to(torch.bfloat16 if bf16
                                    else torch.float32)


@pytest.mark.parametrize("tile_windows", [2, 3])
@pytest.mark.parametrize("kind", ["distinct", "tied", "bf16"])
@pytest.mark.parametrize("case", POOL_CASES)
def test_model_of_the_two_phases_is_bit_exact(case, kind, tile_windows):
    """The numpy model on small tiles equals A1's plain version, the JAX
    SelectAndScatter VJP and, for strided pools, the Pallas kernel in
    interpret mode: first-match routing with ties, padding never routed.
    dy is integer-valued, so every sum is exact in any order and dtype."""
    x, y, k2, s2, pad, bf16 = _case_inputs(case, kind,
                                           seed=sum(case[3:]) + tile_windows)
    dy = ((jnp.arange(y.size) % 7 + 1).reshape(y.shape)).astype(x.dtype)
    got = _model_dx(x, y, dy, k2, s2, pad, bf16, tile_windows)
    plain = a1.max_pool_bwd_plain(torch.from_numpy(_f32(x)).to(got.dtype),
                                  torch.from_numpy(_f32(dy)).to(got.dtype),
                                  k2, s2, pad)
    assert torch.equal(got, plain)
    _, vjp = jax.vjp(lambda v: fnn.max_pool(v, k2, strides=s2,
                                            padding=list(pad)), x)
    np.testing.assert_array_equal(got.float().numpy(), _f32(vjp(dy)[0]))
    if s2[0] > 1:
        np.testing.assert_array_equal(
            got.float().numpy(),
            _f32(max_pool_bwd_pallas(x, y, dy, k2, s2, pad)))


@pytest.mark.parametrize("kind", ["tied", "bf16"])
@pytest.mark.parametrize("case", POOL_CASES)
def test_model_sums_in_window_order(case, kind):
    """Random non-integer dy: the model's float32 sums, in ascending
    (oy, ox) order from 0.0 and rounded once, equal the plain version's
    bit for bit (the kernel's contract with it on the card)."""
    x, y, k2, s2, pad, bf16 = _case_inputs(case, kind, seed=7 * sum(case[3:]))
    rng = np.random.RandomState(sum(case[3:]))
    dy = jnp.asarray(rng.randn(*y.shape).astype(np.float32), x.dtype)
    got = _model_dx(x, y, dy, k2, s2, pad, bf16, 2)
    plain = a1.max_pool_bwd_plain(torch.from_numpy(_f32(x)).to(got.dtype),
                                  torch.from_numpy(_f32(dy)).to(got.dtype),
                                  k2, s2, pad)
    assert torch.equal(got, plain)
