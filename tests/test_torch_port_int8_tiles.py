"""K1's, K2's and K3's tile plans (``kernels/int8.py``) on the CPU.

The CUDA kernels have no CPU mode (their cases are in
tests/test_torch_port_kernels_cuda.py), so their tiling is held here:

* **K1** (``csrc/int8_conv.cu``): a numpy model of the kernel's plan — each
  16-byte chunk of a 128-row A tile is 16 channels of one tap of one pixel
  (zero-filled in the padding, past the rows and past the depth), stored
  under the 128-byte swizzle; the B tile likewise from the weights; the
  wgmma operands read back through the descriptors' address map; columns
  and rows past the output masked — bit-exact against ``int8_conv_plain``.
* **K2** (``csrc/int8_pool.cu``): a numpy model of the shared pool plan
  at stride 1 and 2 — the staged cells (-128 outside the image), each
  window inside them, the tiles covering the output once, row maxima slid
  down a column — bit-exact against ``int8_max_pool_plain`` on signed
  inputs with -128 and all-negative windows at the padded edges.
* **K3** (``csrc/int8_pool.cu``): a numpy model of the tile + halo plan,
  the biased 16-bit-lane sums, the position-derived divisor and the exact
  integer form of the division by 9, bit-exact against
  ``int8_avg_pool_plain`` in both modes; the divisor against the JAX
  package's ``_same_pool_counts``; the integer form against the f32
  division at every window sum.
* **Alignment**: every conv and pool of the full-width BNInception and
  InceptionV3 int8 trunks meets the kernels' 16-byte rule, so the
  CUDA-only refusals exclude no main-path call.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from action_detection_tpu.models.backbones.inception_v3_int8 import (
    _same_pool_counts)

from action_detection_torch.kernels import int8 as k
from action_detection_torch.models.backbones import bn_inception_int8 as bq
from action_detection_torch.models.backbones.bn_inception import pool_pads
from action_detection_torch.models.backbones import get_backbone
from action_detection_torch.models.backbones import inception_v3_int8 as iq
from action_detection_torch.models.convert import seeded_init

SMEM_LIMIT = 232448      # dynamic shared memory one block may use, bytes


# --- K1 ---------------------------------------------------------------------


def _swizzle(addr: np.ndarray) -> np.ndarray:
    """The 128-byte swizzle on a ring offset (the ring is 1024-aligned):
    the 16-byte chunk index (bits 4-6) XOR the row in its 8-row group
    (bits 7-9)."""
    return addr ^ (((addr >> 7) & 7) << 4)


def _operand(smem: np.ndarray, start: int, rows: int) -> np.ndarray:
    """A K-major wgmma operand of ``rows`` x 32 bytes read through a
    128-byte-swizzle descriptor at ``start``: row i at (i // 8) * 1024 (the
    stride byte offset) + (i % 8) * 128, bytes consecutive along k."""
    i = np.arange(rows)[:, None]
    b = np.arange(32)[None, :]
    addr = start + (i // 8) * 1024 + (i % 8) * 128 + b
    return smem[_swizzle(addr)].view(np.int8).astype(np.int64)


def k1_model(x: torch.Tensor, w: torch.Tensor, scale: torch.Tensor,
             bias: torch.Tensor, stride: int, pad, out_dtype) -> torch.Tensor:
    """K1 as the kernel tiles it, on the bytes it addresses: ``x`` through
    its storage (a channel slice is read in place), rows from the plan."""
    N, H, W, C = x.shape
    O, KH, KW, _ = w.shape
    pad_h, pad_w = k.conv_pads(pad)
    Ho = (H + 2 * pad_h - KH) // stride + 1
    Wo = (W + 2 * pad_w - KW) // stride + 1
    plan = k.int8_conv_plan(N, Ho, Wo, O, KH, KW, C)
    BM, BK, bn = k.CONV_BM, k.CONV_BK, plan.bn
    assert k.int8_conv_refusal(x, w) is None
    ps = x.stride(2)
    flat = torch.as_strided(x, (x.untyped_storage().nbytes(),), (1,), 0)
    flat = flat.numpy().view(np.uint8)
    wflat = w.numpy().reshape(-1).view(np.uint8)
    C16, K16 = C // 16, plan.K // 16
    lane16 = np.arange(16)
    out = np.zeros((plan.M, O), np.int64)

    for mt in range(plan.m_tiles):
        r = np.arange(BM)
        m = mt * BM + r
        ok_row = m < plan.M
        mm = np.where(ok_row, m, 0)
        ox, oy, n = mm % Wo, (mm // Wo) % Ho, mm // (Wo * Ho)
        iy0 = np.where(ok_row, oy * stride - pad_h, -2 ** 30)
        ix0 = ox * stride - pad_w
        img = x.storage_offset() + n * H * W * ps
        for nt in range(plan.n_tiles):
            acc = np.zeros((BM, bn), np.int64)
            o = nt * bn + np.arange(bn)
            for kt in range(plan.k_stages):
                a_smem = np.full(BM * BK, 0xAB, np.uint8)   # stale bytes
                b_smem = np.full(bn * BK, 0xAB, np.uint8)
                for j in range(BK // 16):
                    q = kt * (BK // 16) + j
                    tap, cg = divmod(q, C16)
                    ky, kx = divmod(tap, KW)
                    iy, ix = iy0 + ky, ix0 + kx
                    ok = ((q < K16) & (iy >= 0) & (iy < H) & (ix >= 0)
                          & (ix < W))
                    src = img + (iy * W + ix) * ps + cg * 16
                    chunk = np.where(ok[:, None],
                                     flat[np.where(ok, src, 0)[:, None]
                                          + lane16], 0)
                    dst = r * BK + ((j ^ (r & 7)) << 4)
                    a_smem[dst[:, None] + lane16] = chunk
                    rb = np.arange(bn)
                    okb = (q < K16) & (o < O)
                    wsrc = np.where(okb, o * plan.K + q * 16, 0)
                    b_smem[(rb * BK + ((j ^ (rb & 7)) << 4))[:, None]
                           + lane16] = np.where(okb[:, None],
                                                wflat[wsrc[:, None] + lane16],
                                                0)
                for wg in range(BM // 64):
                    for kk in range(BK // 32):
                        a = _operand(a_smem, wg * 64 * BK + 32 * kk, 64)
                        b = _operand(b_smem, 32 * kk, bn)
                        acc[wg * 64:(wg + 1) * 64] += a @ b.T
            rows = m[ok_row]
            cols = o[o < O]
            out[rows[:, None], cols[None, :]] = acc[:len(rows), :len(cols)]

    y = out.astype(np.int32).astype(np.float32)
    v = np.maximum(y * scale.numpy() + bias.numpy(), np.float32(0))
    if out_dtype == torch.int8:
        res = torch.from_numpy(np.clip(np.rint(v), 0, 127).astype(np.int8))
    else:
        res = torch.from_numpy(v).to(torch.bfloat16)
    return res.reshape(N, Ho, Wo, O)


K1_CASES = [  # name, (N, H, W, C_total, c0, C), (O, KH, KW), stride, pad
    ("1x1", (2, 9, 9, 32, 0, 32), (24, 1, 1), 1, 0),
    ("3x3_p1", (2, 9, 9, 48, 0, 48), (64, 3, 3), 1, 1),
    ("3x3_s2_valid", (2, 11, 11, 32, 0, 32), (40, 3, 3), 2, (0, 0)),
    ("1x7", (2, 9, 8, 32, 0, 32), (24, 1, 7), 1, (0, 3)),
    ("7x1", (2, 9, 8, 32, 0, 32), (40, 7, 1), 1, (3, 0)),
    ("slice_at_16", (2, 9, 9, 80, 16, 48), (64, 5, 5), 1, (2, 2)),
    ("tails", (3, 13, 13, 80, 0, 80), (176, 3, 3), 1, 1),
    ("wide_o", (1, 5, 7, 16, 0, 16), (136, 3, 3), 1, 1),
]


@pytest.mark.parametrize("out_dtype", [torch.int8, torch.bfloat16])
@pytest.mark.parametrize("case", K1_CASES, ids=[c[0] for c in K1_CASES])
def test_k1_plan_model_bit_exact(case, out_dtype):
    """The plan's chunk mapping, zero-fill, swizzle, descriptor reads and
    masks give ``int8_conv_plain``'s bits; signed inputs for the bf16
    (calibration) epilogue."""
    _, (N, H, W, Ct, c0, C), (O, KH, KW), stride, pad = case
    rng = np.random.RandomState(H * W + C + O)
    lo = -127 if out_dtype == torch.bfloat16 else 0
    base = torch.from_numpy(rng.randint(lo, 128, (N, H, W, Ct))
                            .astype(np.int8))
    x = base[..., c0:c0 + C]
    w = torch.from_numpy(rng.randint(-127, 128, (O, KH, KW, C))
                         .astype(np.int8))
    m = torch.from_numpy((rng.rand(O) * 4.0 / (KH * KW * C * 64))
                         .astype(np.float32))
    b = torch.from_numpy((rng.randn(O) * 20).astype(np.float32))
    ref = k.int8_conv_plain(x, w, m, b, stride, pad, out_dtype)
    got = k1_model(x, w, m, b, stride, pad, out_dtype)
    assert (ref.float() > 0).float().mean() > 0.1      # not trivial
    assert torch.equal(got, ref)


@pytest.mark.parametrize("case", [
    ((1, 20, 22), 3, 64, 7, 2, 3),          # BNInception conv1, RGB
    ((1, 20, 22), 10, 64, 7, 2, 3),         # conv1, Flow
    ((1, 21, 23), 3, 32, 3, 2, (0, 0))])    # InceptionV3 Conv2d_1a
def test_k1_plan_model_all_int8_stem(case):
    """The all-int8 stems' first conv: signed input (normalized pixels
    quantized into 16 channels, the extra ones zero, as are the weights')
    and the requantizing int8 epilogue."""
    (N, H, W), real, O, kk, stride, pad = case
    rng = np.random.RandomState(H * W + real)
    x = torch.from_numpy(rng.randint(-127, 128, (N, H, W, 16))
                         .astype(np.int8))
    x[..., real:] = 0
    w = torch.from_numpy(rng.randint(-127, 128, (O, kk, kk, 16))
                         .astype(np.int8))
    w[..., real:] = 0
    m = torch.from_numpy((rng.rand(O) * 8.0 / (kk * kk * real * 64))
                         .astype(np.float32))
    b = torch.from_numpy((rng.randn(O) * 20).astype(np.float32))
    ref = k.int8_conv_plain(x, w, m, b, stride, pad)
    assert (ref > 0).float().mean() > 0.1               # not trivial
    assert torch.equal(k1_model(x, w, m, b, stride, pad, torch.int8), ref)


@pytest.mark.parametrize("O,bn", [(24, 32), (32, 32), (40, 64), (64, 64),
                                  (96, 128), (176, 64), (192, 64),
                                  (384, 128), (736, 128), (768, 128)])
def test_k1_plan_column_tile(O, bn):
    """The column tile: 32 up to O = 32, then whichever of 64 and 128 pads
    O to fewer columns (64 on a tie up to O = 64, else 128)."""
    plan = k.int8_conv_plan(640, 28, 28, O, 3, 3, 192)
    assert plan.bn == bn
    assert plan.n_tiles * bn >= O > (plan.n_tiles - 1) * bn
    assert plan.k_stages * k.CONV_BK >= plan.K > (plan.k_stages - 1) * k.CONV_BK
    assert plan.m_tiles * k.CONV_BM >= plan.M
    assert plan.smem <= SMEM_LIMIT


def test_k1_refusal_names_the_rule():
    """The CUDA-only rule, device-independent: C % 16, the pixel stride, a
    slice's start."""
    x = torch.zeros((1, 4, 4, 64), dtype=torch.int8)
    w = torch.zeros((8, 1, 1, 16), dtype=torch.int8)
    assert k.int8_conv_refusal(x[..., 16:32], w) is None
    assert "16-byte aligned" in k.int8_conv_refusal(x[..., 8:24], w)
    assert "C % 16" in k.int8_conv_refusal(x[..., :8], w[..., :8])
    odd = torch.zeros((1, 4, 4, 24), dtype=torch.int8)[..., :16]
    assert "pixel stride" in k.int8_conv_refusal(odd, w)
    # the CPU path keeps the looser C % 4 rule of the plain version
    m, b = torch.ones(8), torch.zeros(8)
    assert k.int8_conv(x[..., :8], w[..., :8].contiguous(), m, b).shape == (
        1, 4, 4, 8)


# --- K2 ---------------------------------------------------------------------


def k2_model(x: torch.Tensor, stride: int, pads, **tiles) -> torch.Tensor:
    """K2 as the kernel tiles it: per block (image, tile, slab) the staged
    cells under the tile's windows, copied where they lie in the image and
    -128 elsewhere; each staged row's three-cell maxima under a window
    column, then the maxima of three such rows down the column. Checks
    on the way that the staged cells are the -128-padded input, that every
    window of the tile lies inside them, and that the tiles cover the
    output exactly once."""
    N, H, W, C = x.shape
    (t, b), (l, r) = pads
    assert t == l
    S = stride
    Ho, Wo = (H + t + b - 3) // S + 1, (W + l + r - 3) // S + 1
    plan = k.int8_pool_plan(Ho, Wo, C, S, **tiles)
    th, tw, sb = plan.tile_h, plan.tile_w, plan.slab
    xb = x.numpy()
    big = 3 * S + 3           # padding past any staged cell
    padded = np.pad(xb, ((0, 0), (big, big), (big, big), (0, 0)),
                    constant_values=-128)
    out = np.zeros((N, Ho, Wo, C), np.int8)
    cover = np.zeros((N, Ho, Wo, C), np.int64)
    for n in range(N):
        for tile in range(plan.tiles_h * plan.tiles_w):
            oy0 = (tile // plan.tiles_w) * th
            ox0 = (tile % plan.tiles_w) * tw
            hh, ww = min(th, Ho - oy0), min(tw, Wo - ox0)
            rows, cols = (hh - 1) * S + 3, (ww - 1) * S + 3
            assert rows <= plan.rows and cols <= plan.cols
            assert rows * cols * sb * 16 <= plan.smem
            iy = oy0 * S - t + np.arange(rows)
            ix = ox0 * S - t + np.arange(cols)
            # every window of the tile inside the staged rows and columns
            wy = (oy0 + np.arange(hh))[:, None] * S - t + np.arange(3)
            wx = (ox0 + np.arange(ww))[:, None] * S - t + np.arange(3)
            assert wy.min() >= iy[0] and wy.max() <= iy[-1]
            assert wx.min() >= ix[0] and wx.max() <= ix[-1]
            for s in range(plan.slabs):
                c0, c1 = s * sb * 16, (s + 1) * sb * 16
                staged = np.full((rows, cols, c1 - c0), 0x80, np.uint8)
                for rr in range(rows):         # the kernel's staging loop
                    for cc in range(cols):
                        if 0 <= iy[rr] < H and 0 <= ix[cc] < W:
                            staged[rr, cc] = xb[n, iy[rr], ix[cc],
                                                c0:c1].view(np.uint8)
                staged = staged.view(np.int8)
                np.testing.assert_array_equal(
                    staged, padded[n, big + iy[0]:big + iy[-1] + 1,
                                   big + ix[0]:big + ix[-1] + 1, c0:c1])
                cx = S * np.arange(ww)
                row = np.maximum(np.maximum(staged[:, cx], staged[:, cx + 1]),
                                 staged[:, cx + 2])       # (rows, ww, ch)
                ry = S * np.arange(hh)
                v = np.maximum(np.maximum(row[ry], row[ry + 1]), row[ry + 2])
                out[n, oy0:oy0 + hh, ox0:ox0 + ww, c0:c1] = v
                cover[n, oy0:oy0 + hh, ox0:ox0 + ww, c0:c1] += 1
    assert (cover == 1).all()
    return torch.from_numpy(out)


def k2_input(shape, seed: int) -> torch.Tensor:
    """Signed int8 with -128 in it; the last rows and columns negative, and
    windows of -128 alone at the bottom-right (padded) corner."""
    rng = np.random.RandomState(seed)
    x = rng.randint(-128, 128, shape).astype(np.int8)
    x[:, -3:] = rng.randint(-128, 0, x[:, -3:].shape)
    x[:, :, -3:] = rng.randint(-128, 0, x[:, :, -3:].shape)
    x[:, -3:, -3:, ::2] = -128
    return torch.from_numpy(x)


# (N, H, W, C), stride, pool_pads keywords: the trunks' five K2 pools at
# their full grids and widths, and edge shapes with ragged tiles
K2_CASES = [
    ("3c_ceil_s2", (1, 28, 28, 320), 2, dict(ceil=True)),
    ("4e_ceil_s2", (1, 14, 14, 608), 2, dict(ceil=True)),
    ("5b_s1_p1", (1, 7, 7, 1024), 1, dict(pad=1)),
    ("6a_valid_s2", (1, 35, 35, 288), 2, dict()),
    ("7a_valid_s2", (1, 17, 17, 768), 2, dict()),
    ("edge_27x29_ceil_s2", (2, 27, 29, 336), 2, dict(ceil=True)),
    ("edge_9x11_s1_p1", (2, 9, 11, 96), 1, dict(pad=1)),
    ("edge_1x1_s1_p1", (2, 1, 1, 16), 1, dict(pad=1)),
    ("edge_4x3_ceil_s2", (2, 4, 3, 48), 2, dict(ceil=True)),
    # the all-int8 stems' pools: BNInception's Caffe-ceil s2 at a 224^2
    # crop and at the shared stem's 340x256 frame (bottom/right pad 1),
    # InceptionV3's VALID s2 at 299^2
    ("stem_pool1_ceil_s2", (1, 112, 112, 64), 2, dict(ceil=True)),
    ("stem_pool1_frame_ceil_s2", (1, 128, 170, 64), 2, dict(ceil=True)),
    ("stem_pool2_frame_ceil_s2", (1, 64, 85, 192), 2, dict(ceil=True)),
    ("iv3_stem_pool1_valid_s2", (1, 147, 147, 64), 2, dict()),
    ("iv3_stem_pool2_valid_s2", (1, 71, 71, 192), 2, dict()),
]


@pytest.mark.parametrize("case", K2_CASES, ids=[c[0] for c in K2_CASES])
def test_k2_plan_model_bit_exact(case):
    """Staging, windows, coverage and the sliding row maxima of the plan
    give ``int8_max_pool_plain``'s bits."""
    _, shape, stride, kw = case
    pads = pool_pads(shape[1], shape[2], 3, stride, **kw)
    x = k2_input(shape, sum(shape))
    ref = k.int8_max_pool_plain(x, 3, stride, pads)
    assert torch.equal(k2_model(x, stride, pads), ref)
    assert (ref == -128).any() and (ref > -128).any()    # not trivial


@pytest.mark.parametrize("stride,kw", [(2, dict(ceil=True)), (1, dict(pad=1)),
                                       (2, dict())])
@pytest.mark.parametrize("tiles", [dict(tile_h=2, tile_w=3),
                                   dict(tile_h=5, tile_w=1)])
def test_k2_plan_model_small_tiles(tiles, stride, kw):
    """Forced small tiles: many tiles, ragged last ones on both axes, two
    channel slabs."""
    x = k2_input((2, 13, 11, 32), 7)
    pads = pool_pads(13, 11, 3, stride, **kw)
    assert torch.equal(k2_model(x, stride, pads, **tiles),
                       k.int8_max_pool_plain(x, 3, stride, pads))


@pytest.mark.parametrize("case", K2_CASES, ids=[c[0] for c in K2_CASES])
def test_k2_plan_fits_the_block(case):
    """At every trunk pool and edge shape: tiles cover the output, the slab
    divides the chunks, the block has at most 256 threads and its staged
    cells, ((tile - 1) * stride + 3) per axis, fit."""
    _, (_, H, W, C), stride, kw = case
    (t, b), (l, r) = pool_pads(H, W, 3, stride, **kw)
    Ho, Wo = (H + t + b - 3) // stride + 1, (W + l + r - 3) // stride + 1
    p = k.int8_pool_plan(Ho, Wo, C, stride)
    assert p.tiles_h * p.tile_h >= Ho > (p.tiles_h - 1) * p.tile_h
    assert p.tiles_w * p.tile_w >= Wo > (p.tiles_w - 1) * p.tile_w
    assert p.slab * p.slabs == C // 16
    assert p.slab * p.tile_w <= k.POOL_THREADS
    assert p.rows == (p.tile_h - 1) * stride + 3
    assert p.cols == (p.tile_w - 1) * stride + 3
    assert p.smem == p.rows * p.cols * p.slab * 16 <= k.POOL_SMEM


# --- K3 ---------------------------------------------------------------------


def k3_divisor(H: int, W: int, exclude_pad: bool) -> np.ndarray:
    """The kernel's divisor from the cell's position: 9, or (rows in
    image) x (columns in image)."""
    if not exclude_pad:
        return np.full((H, W), 9.0, np.float32)
    oy, ox = np.arange(H)[:, None], np.arange(W)[None, :]
    rows = 3 - (oy == 0) - (oy == H - 1)
    cols = 3 - (ox == 0) - (ox == W - 1)
    return (rows * cols).astype(np.float32)


def average9(lane: np.ndarray) -> np.ndarray:
    """The kernel's ``average9`` as a signed value: a 9-cell window's
    rounded average from its lane (the sum plus 9 x 128)."""
    return (((2 * lane + 9) * 3641) >> 16) - 128


def test_k3_divide_by_9_form_is_exact():
    """``average9`` equals the f32 division rounded half to even and
    clipped, the JAX package's rounding, at every sum a lane can hold."""
    lane = np.arange(9 * 255 + 1)
    ref = np.clip(np.rint((lane - 9 * 128).astype(np.float32)
                          / np.float32(9)), -128, 127)
    np.testing.assert_array_equal(average9(lane), ref)


def k3_model(x: torch.Tensor, exclude_pad: bool, **tiles) -> torch.Tensor:
    """K3 as the kernel tiles it: per block a zero-filled halo tile of one
    image and channel slab, 16-channel chunks unpacked to two 16-bit lanes
    a word with each byte offset by +128, three-cell row sums, then
    three-row column sums, the divisor from the position, the f32 division
    rounded half to even (its integer form where the divisor is 9)."""
    N, H, W, C = x.shape
    plan = k.int8_pool_plan(H, W, C, **tiles)
    th, tw, sb = plan.tile_h, plan.tile_w, plan.slab
    xb = x.numpy().view(np.uint8)
    out = np.zeros((N, H, W, C), np.int8)
    div = k3_divisor(H, W, exclude_pad)
    for n in range(N):
        for t in range(plan.tiles_h * plan.tiles_w):
            oy0, ox0 = (t // plan.tiles_w) * th, (t % plan.tiles_w) * tw
            for s in range(plan.slabs):
                c0 = s * sb * 16
                halo = np.zeros((th + 2, tw + 2, sb * 16), np.uint8)
                for hy in range(th + 2):
                    for hx in range(tw + 2):
                        iy, ix = oy0 - 1 + hy, ox0 - 1 + hx
                        if 0 <= iy < H and 0 <= ix < W:
                            halo[hy, hx] = xb[n, iy, ix, c0:c0 + sb * 16]
                u = np.ascontiguousarray(halo).view(np.uint32) ^ np.uint32(
                    0x80808080)
                lanes = np.stack([u & 0x00FF00FF, (u >> 8) & 0x00FF00FF], -1)
                row = lanes[:, :-2] + lanes[:, 1:-1] + lanes[:, 2:]
                tot = row[:-2] + row[1:-1] + row[2:]      # (th, tw, 4sb, 2)
                vals = np.stack([tot & 0xFFFF, tot >> 16], -1).astype(
                    np.int64) - 9 * 128                  # (.., word, eo, hl)
                # word k: even lo = 4k, odd lo = 4k+1, even hi = 4k+2, ...
                vals = vals.transpose(0, 1, 2, 4, 3).reshape(th, tw, -1)
                hh, ww = min(th, H - oy0), min(tw, W - ox0)
                d = div[oy0:oy0 + hh, ox0:ox0 + ww, None]
                v = vals[:hh, :ww]
                q = np.where(d == 9, average9(v + 9 * 128),
                             np.rint(v.astype(np.float32) / d))
                out[n, oy0:oy0 + hh, ox0:ox0 + ww, c0:c0 + sb * 16] = \
                    np.clip(q, -128, 127).astype(np.int8)
    return torch.from_numpy(out)


K3_CASES = [(2, 35, 35, 48), (2, 17, 17, 64), (1, 8, 8, 2048),
            (2, 7, 10, 32), (1, 1, 1, 16), (2, 9, 17, 32), (1, 28, 28, 192)]


@pytest.mark.parametrize("exclude_pad", [False, True])
@pytest.mark.parametrize("case", K3_CASES)
def test_k3_plan_model_bit_exact(case, exclude_pad):
    """Tiles, halos, slabs, lane sums and divisors of the plan give
    ``int8_avg_pool_plain``'s bits on signed inputs (.5 ties included)."""
    rng = np.random.RandomState(sum(case))
    x = torch.from_numpy(rng.randint(-128, 128, case).astype(np.int8))
    ref = k.int8_avg_pool_plain(x, 3, 1, 1,
                                count_include_pad=not exclude_pad)
    assert torch.equal(k3_model(x, exclude_pad), ref)


@pytest.mark.parametrize("tiles", [dict(tile_h=2, tile_w=3),
                                   dict(tile_h=5, tile_w=1)])
def test_k3_plan_model_small_tiles(tiles):
    """Forced small tiles: many halos, ragged last tiles on both axes."""
    rng = np.random.RandomState(4)
    x = torch.from_numpy(rng.randint(-128, 128, (2, 11, 9, 32))
                         .astype(np.int8))
    for exclude_pad in (False, True):
        ref = k.int8_avg_pool_plain(x, 3, 1, 1,
                                    count_include_pad=not exclude_pad)
        assert torch.equal(k3_model(x, exclude_pad, **tiles), ref)


@pytest.mark.parametrize("hw", [(35, 35), (17, 17), (8, 8), (7, 10)])
def test_k3_divisor_matches_jax_same_pool_counts(hw):
    """The position-derived divisor is the JAX package's
    ``_same_pool_counts`` (9 inside, 6 on edges, 4 in corners)."""
    ref = np.asarray(_same_pool_counts(*hw, jnp.float32))[0, :, :, 0]
    np.testing.assert_array_equal(k3_divisor(*hw, True), ref)


@pytest.mark.parametrize("H,W,C", [(35, 35, 288), (17, 17, 768),
                                   (8, 8, 1280), (8, 8, 2048),
                                   (28, 28, 192), (28, 28, 256),
                                   (14, 14, 576), (7, 7, 1024)])
def test_k3_plan_fits_the_block(H, W, C):
    """At every trunk pool: tiles cover the image, the slab divides the
    chunks, the block has at most 256 threads and its halo tile fits."""
    p = k.int8_pool_plan(H, W, C)
    assert p.tiles_h * p.tile_h >= H > (p.tiles_h - 1) * p.tile_h
    assert p.tiles_w * p.tile_w >= W > (p.tiles_w - 1) * p.tile_w
    assert p.slab * p.slabs == C // 16
    assert p.slab * p.tile_w <= k.POOL_THREADS
    assert (p.rows, p.cols) == (p.tile_h + 2, p.tile_w + 2)
    assert p.smem == (p.tile_h + 2) * (p.tile_w + 2) * p.slab * 16
    assert p.smem <= k.POOL_SMEM


@pytest.mark.parametrize("hwc,plan", [
    ((28, 28, 192), (7, 7, 4, 4, 12, 1, 15552)),
    ((35, 35, 288), (7, 7, 5, 5, 18, 1, 23328)),
    ((17, 17, 768), (6, 6, 3, 3, 24, 2, 24576)),
    ((8, 8, 2048), (8, 8, 1, 1, 16, 8, 25600))])
def test_k3_plan_unchanged_by_the_shared_plan(hwc, plan):
    """K3's tiles at its 28^2, 35^2, 17^2 and 8^2 pools are the ones its
    own plan gave before K2 shared it: (tile_h, tile_w, tiles_h, tiles_w,
    slab, slabs, smem)."""
    p = k.int8_pool_plan(*hwc)
    assert (p.tile_h, p.tile_w, p.tiles_h, p.tiles_w, p.slab, p.slabs,
            p.smem) == plan


# --- the 16-byte rule on the trunks -------------------------------------------


class _Recorder:
    """Patches a model module's kernel wrappers with recording ones that
    run the real (CPU) wrappers."""

    def __init__(self, monkeypatch, module, names):
        self.convs, self.pools, self.outs = [], [], []
        for name in names:
            real = getattr(module, name)
            monkeypatch.setattr(module, name, self._wrap(name, real))

    def _wrap(self, name, real):
        def call(x, *args, **kwargs):
            if kwargs.get("out") is not None:
                self.outs.append((name, k.int8_out_refusal(kwargs["out"])))
            if name == "int8_conv":
                self.convs.append((tuple(x.shape), x.stride(),
                                   x.storage_offset(),
                                   k.int8_conv_refusal(x, args[0])))
            else:
                self.pools.append((name, tuple(x.shape), args,
                                   x.is_contiguous()))
            return real(x, *args, **kwargs)
        return call


def _assert_16_byte_rule(rec):
    assert rec.convs and rec.pools
    for shape, strides, offset, refusal in rec.convs:
        assert refusal is None, (shape, strides, offset, refusal)
        assert shape[3] % 16 == 0 and strides[2] % 16 == 0
        assert offset % 16 == 0
    assert any(name == "int8_max_pool" for name, *_ in rec.pools)
    for name, refusal in rec.outs:     # the module slots written in place
        assert refusal is None, (name, refusal)
    for name, shape, args, contiguous in rec.pools:
        assert shape[3] % 16 == 0 and contiguous, (name, shape)
        if name.startswith("int8_avg_pool"):
            assert args == (3, 1, 1)
        else:   # Caffe-ceil or VALID 3x3 s2, or 3x3 s1 p1
            kernel, stride, ((t, b), (l, r)) = args
            assert (kernel, stride) in ((3, 1), (3, 2)), args
            if stride == 2:
                assert t == l == 0 and b in (0, 1) and r in (0, 1), args
            else:
                assert (t, b, l, r) == (1, 1, 1, 1), args


def test_bninception_trunk_meets_the_16_byte_rule(monkeypatch):
    """Every conv of the full-width BNInception int8 trunk (runtime with the
    fused entry convs and their in-place slices, and the calibration face)
    and every pool: C, each entry-split width and each slice offset are
    multiples of 16, the avg pools are 3x3 s1 p1 and the max pools Caffe
    ceil 3x3 s2 or 3x3 s1 p1; every module slot a branch writes meets the
    output rule."""
    model, _, _ = get_backbone("BNInception", "RGB")
    sd = seeded_init(model, seed=0).state_dict()
    folded = bq.fold_bn(sd)
    maxes = dict({n: 1.0 for n in folded}, input=1.0)
    qe = bq.quantize_backbone_e2e(sd, maxes, folded=folded)
    for n, f in qe["__entry__"].items():
        widths = [int(qe[c]["wq"].shape[0]) for c in bq._entry_names(
            n, next(c1 for (m, c1, *_r) in bq._INCEPTION_CFG if m == n))]
        assert all(v % 16 == 0 for v in widths), (n, widths)
        assert sum(widths) == f["wq"].shape[0]
    rec = _Recorder(monkeypatch, bq, ("int8_conv", "int8_avg_pool",
                                      "int8_max_pool"))
    h = torch.randint(0, 128, (1, 8, 8, 192), dtype=torch.int8)
    out = bq._walk_trunk(bq._E2EOps(qe), h)
    assert out.shape == (1, 2, 2, 1024)
    runtime_convs = len(rec.convs)
    # each module's branch ends (8 1x1 heads, 10 3x3s, 10 double 3x3s, 8
    # pool projections, 2 passthrough pools) write its buffer in place
    assert len(rec.outs) == 38
    q0 = bq.quantize_backbone(sd, folded=folded)
    bq._walk_trunk(bq._PerLayerOps(q0), h.to(torch.bfloat16))
    assert len(rec.convs) > runtime_convs
    assert any(off > 0 for _, _, off, _ in rec.convs)   # slices were read
    _assert_16_byte_rule(rec)


def test_inceptionv3_trunk_meets_the_16_byte_rule(monkeypatch):
    """Every conv (fused entry convs and their in-place slices, 1x7/7x1/1x3/
    3x1 pads), every exclude-pad avg pool and every VALID 3x3 s2 max pool
    of the full-width InceptionV3 int8 trunk, and every module slot a
    branch writes, meets the rule."""
    model, _, _ = get_backbone("InceptionV3", "RGB")
    folded = iq.fold_bn_iv3(seeded_init(model, seed=0).state_dict())
    qe = iq.quantize_iv3_e2e(folded, dict({n: 1.0 for n in folded},
                                          input=1.0))
    for n in iq.ENTRY_MODULES:
        widths = [int(qe[c]["wq"].shape[0]) for c in iq._entry_names(n)]
        assert all(v % 16 == 0 for v in widths), (n, widths)
    rec = _Recorder(monkeypatch, iq, ("int8_conv",
                                      "int8_avg_pool_exclude_pad",
                                      "int8_max_pool"))
    h = torch.randint(0, 128, (1, 17, 17, 192), dtype=torch.int8)
    out = iq._walk_trunk(iq._ForwardOps(qe), h)
    assert out.shape == (1, 2048)
    assert any(off > 0 for _, _, off, _ in rec.convs)
    # each Mixed module's branch ends (4 a module in 5b-5d and 6b-6e, 3 in
    # 6a and 7a, 6 in 7b and 7c) write its buffer in place
    assert len(rec.outs) == 46
    _assert_16_byte_rule(rec)


@pytest.mark.parametrize("arch,modality,hw", [
    ("BNInception", "RGB", (64, 80)), ("BNInception", "Flow", (64, 80)),
    ("BNInception", "RGBDiff", (64, 64)), ("InceptionV3", "RGB", (75, 91))])
def test_all_int8_stems_meet_the_16_byte_rule(monkeypatch, arch, modality,
                                              hw):
    """The all-int8 stems (``hybrid_stem=False``): the input quantized into
    16 channels (3, 10 or 15 real), the stem convs on K1 and their pools
    on K2 (Caffe ceil 3x3 s2 or VALID 3x3 s2) all meet the rule."""
    model, _, _ = get_backbone(arch, modality)
    sd = seeded_init(model, seed=0).state_dict()
    C = {"RGB": 3, "Flow": 10, "RGBDiff": 15}[modality]
    if arch == "InceptionV3":
        mod, stem, names = iq, iq._iv3_stem_quantized, (
            "int8_conv", "int8_max_pool")
        folded = iq.fold_bn_iv3(sd)
        qe = iq.quantize_iv3_e2e(folded, dict({n: 1.0 for n in folded},
                                              input=1.0), hybrid_stem=False)
        first, convs = "Conv2d_1a_3x3", 5
    else:
        mod, stem, names = bq, bq._e2e_stem_quantized, (
            "int8_conv", "int8_max_pool")
        folded = bq.fold_bn(sd)
        qe = bq.quantize_backbone_e2e(sd, dict({n: 1.0 for n in folded},
                                               input=1.0), hybrid_stem=False,
                                      folded=folded)
        first, convs = "conv1_7x7_s2", 3
    assert "__stem__" not in qe and qe[first]["wq"].shape[-1] == 16
    assert not qe[first]["wq"][..., C:].any()
    rec = _Recorder(monkeypatch, mod, names)
    x = torch.randn(2, *hw, C) * 50
    h = stem(qe, x)
    assert h.dtype == torch.int8 and h.shape[-1] == 192
    assert len(rec.convs) == convs and len(rec.pools) == 2
    _assert_16_byte_rule(rec)
