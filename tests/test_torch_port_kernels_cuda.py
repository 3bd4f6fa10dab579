"""The port's CUDA kernels K1-K3 (K1 with per-axis pads, K3 in both
modes) and A1 (at the test geometries and at the training pools of
InceptionV3 and bf16 BNInception) against their plain torch versions.

K1-K3 take channel counts, pixel strides and addresses that are
multiples of 16 on the card, so every case here has C % 16 == 0 (and the
``*_refuses_what_it_does_not_take`` cases hold the refusals).

These need a card (a CUDA kernel has no CPU mode): each case carries the
``cuda`` marker and skips where torch sees no CUDA device. The file imports
torch and the port only, so it runs on a machine without jax:

    python -m pytest tests/test_torch_port_kernels_cuda.py -m cuda
"""

import pytest
import torch

from action_detection_torch.kernels import int8 as k
from action_detection_torch.kernels import pool_bwd as a1
from action_detection_torch.models.backbones.bn_inception import pool_pads

CONV_CASES = [  # (N, H, W, C, O, k, stride, pad)
    (2, 9, 9, 32, 24, 1, 1, 0),
    (2, 9, 9, 16, 40, 3, 1, 1),
    (2, 10, 11, 16, 12, 3, 2, 1),
    (1, 7, 7, 64, 20, 3, 2, 1),
    (3, 28, 28, 192, 192, 1, 1, 0),
]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: K1-K3 and A1 are CUDA kernels "
                    "with no CPU mode (chip_smoke.py checks them on the card)")
    return torch.device("cuda")


def _conv_inputs(case):
    N, H, W, C, O, kk, stride, pad = case
    g = torch.Generator().manual_seed(sum(case))
    x = torch.randint(0, 128, (N, H, W, C), generator=g, dtype=torch.int8)
    w = torch.randint(-127, 128, (O, kk, kk, C), generator=g,
                      dtype=torch.int8)
    m = torch.rand(O, generator=g) * 4.0 / (kk * kk * C * 64)
    b = torch.randn(O, generator=g) * 20
    return x, w, m, b


@pytest.mark.cuda
@pytest.mark.parametrize("case", CONV_CASES)
@pytest.mark.parametrize("out_dtype", [torch.int8, torch.bfloat16])
def test_cuda_conv_matches_plain(cuda_device, case, out_dtype):
    x, w, m, b = _conv_inputs(case)
    stride, pad = case[6], case[7]
    ref = k.int8_conv_plain(x, w, m, b, stride, pad, out_dtype)
    before = k.int8_conv.launches
    got = k.int8_conv(*(t.to(cuda_device) for t in (x, w, m, b)), stride,
                      pad, out_dtype)
    torch.cuda.synchronize()
    assert k.int8_conv.launches == before + 1
    assert torch.equal(got.cpu(), ref)


# InceptionV3 convs: (N, H, W, C, O, (KH, KW), stride, (pad_h, pad_w))
IV3_CONV_CASES = [
    (2, 9, 9, 48, 64, (5, 5), 1, (2, 2)),      # Mixed_5b branch5x5_2
    (2, 9, 8, 32, 24, (1, 7), 1, (0, 3)),      # Mixed_6b branch7x7_2
    (2, 9, 8, 32, 40, (7, 1), 1, (3, 0)),      # branch7x7_3
    (2, 11, 11, 16, 36, (3, 3), 2, (0, 0)),    # Mixed_6a branch3x3 VALID s2
    (3, 4, 5, 64, 20, (1, 3), 1, (0, 1)),      # Mixed_7b branch3x3_2a
    (3, 4, 5, 64, 20, (3, 1), 1, (1, 0)),      # branch3x3_2b
]


@pytest.mark.cuda
@pytest.mark.parametrize("case", IV3_CONV_CASES)
@pytest.mark.parametrize("out_dtype", [torch.int8, torch.bfloat16])
def test_cuda_conv_per_axis_pad_matches_plain(cuda_device, case, out_dtype):
    N, H, W, C, O, (kh, kw), stride, pad = case
    g = torch.Generator().manual_seed(N * H * W + C + O)
    x = torch.randint(0, 128, (N, H, W, C), generator=g, dtype=torch.int8)
    w = torch.randint(-127, 128, (O, kh, kw, C), generator=g,
                      dtype=torch.int8)
    m = torch.rand(O, generator=g) * 4.0 / (kh * kw * C * 64)
    b = torch.randn(O, generator=g) * 20
    ref = k.int8_conv_plain(x, w, m, b, stride, pad, out_dtype)
    before = k.int8_conv.launches
    got = k.int8_conv(*(t.to(cuda_device) for t in (x, w, m, b)), stride,
                      pad, out_dtype)
    torch.cuda.synchronize()
    assert k.int8_conv.launches == before + 1
    assert got.shape == ref.shape and torch.equal(got.cpu(), ref)


@pytest.mark.cuda
def test_cuda_conv_reads_channel_slice(cuda_device):
    x, w, m, b = _conv_inputs((2, 9, 9, 32, 24, 3, 1, 1))
    xs = x.to(cuda_device)[..., 16:32]
    got = k.int8_conv(xs, w[..., :16].contiguous().to(cuda_device),
                      m.to(cuda_device), b.to(cuda_device), 1, 1)
    ref = k.int8_conv_plain(x[..., 16:32], w[..., :16], m, b, 1, 1)
    assert torch.equal(got.cpu(), ref)


# K1's tile tails: (N, H, W, C, O, (KH, KW), stride, pad). Rows N*Ho*Wo not
# a multiple of the 128-row tile, O past the last column tile, depth
# KH*KW*C not a multiple of the 128-byte stage.
TAIL_CASES = [
    (3, 13, 13, 80, 176, (3, 3), 1, 1),     # K 720, M 507, O 176 (bn 64)
    (2, 9, 9, 48, 24, (1, 1), 1, 0),        # K 48 < one stage, bn 32
    (2, 11, 11, 32, 40, (3, 3), 2, 1),      # K 288, M 72 < one row tile
    (1, 7, 7, 1040, 736, (1, 1), 1, 0),     # K 1040, O 736 (bn 128)
    (5, 17, 17, 16, 136, (1, 7), 1, (0, 3)),  # K 112, O 136 (bn 64)
]


@pytest.mark.cuda
@pytest.mark.parametrize("case", TAIL_CASES)
@pytest.mark.parametrize("out_dtype", [torch.int8, torch.bfloat16])
def test_cuda_conv_tile_tails(cuda_device, case, out_dtype):
    """Masked rows and columns, zero-filled depth; signed inputs, as the
    calibration conv (the bf16 epilogue) feeds."""
    N, H, W, C, O, (kh, kw), stride, pad = case
    g = torch.Generator().manual_seed(H * W * C + O)
    x = torch.randint(-127, 128, (N, H, W, C), generator=g, dtype=torch.int8)
    w = torch.randint(-127, 128, (O, kh, kw, C), generator=g,
                      dtype=torch.int8)
    m = torch.rand(O, generator=g) * 4.0 / (kh * kw * C * 64)
    b = torch.randn(O, generator=g) * 20
    ref = k.int8_conv_plain(x, w, m, b, stride, pad, out_dtype)
    got = k.int8_conv(*(t.to(cuda_device) for t in (x, w, m, b)), stride,
                      pad, out_dtype)
    torch.cuda.synchronize()
    assert got.shape == ref.shape and torch.equal(got.cpu(), ref)


@pytest.mark.cuda
def test_cuda_conv_refuses_what_it_does_not_take(cuda_device):
    """On the card K1 raises on C % 16 != 0 and on a channel slice that
    does not start at a multiple of 16 channels; it never falls back."""
    x, w, m, b = (t.to(cuda_device) for t in _conv_inputs(
        (2, 9, 9, 32, 24, 3, 1, 1)))
    before = k.int8_conv.launches
    with pytest.raises(ValueError, match="C % 16"):
        k.int8_conv(x[..., :8].contiguous(), w[..., :8].contiguous(), m, b,
                    1, 1)
    with pytest.raises(ValueError, match="16-byte aligned"):
        k.int8_conv(x[..., 8:24], w[..., :16].contiguous(), m, b, 1, 1)
    assert k.int8_conv.launches == before


def _signed_pool_input(shape, seed):
    """Signed int8 with -128 in it; the last rows and columns negative and
    windows of -128 alone at the bottom-right (padded) corner."""
    g = torch.Generator().manual_seed(seed)
    x = torch.randint(-128, 128, shape, generator=g, dtype=torch.int8)
    x[:, -3:] = torch.randint(-128, 0, x[:, -3:].shape, generator=g,
                              dtype=torch.int8)
    x[:, :, -3:] = torch.randint(-128, 0, x[:, :, -3:].shape, generator=g,
                                 dtype=torch.int8)
    x[:, -3:, -3:, ::2] = -128
    return x


# K2's padded pools and tile edges: (N, H, W, C), pool_pads keywords
K2_CASES = [
    ((2, 9, 11, 32), dict(kernel=3, stride=2, ceil=True)),
    ((2, 9, 11, 32), dict(kernel=3, stride=1, pad=1)),
    ((3, 27, 29, 336), dict(kernel=3, stride=2, ceil=True)),  # ragged tiles
    ((3, 9, 11, 96), dict(kernel=3, stride=1, pad=1)),
    ((2, 14, 14, 608), dict(kernel=3, stride=2, ceil=True)),  # 4e, 38 chunks
    ((2, 1, 1, 16), dict(kernel=3, stride=1, pad=1)),
]


@pytest.mark.cuda
@pytest.mark.parametrize("case", K2_CASES)
def test_cuda_max_pool_matches_plain(cuda_device, case):
    """Caffe-ceil s2 and s1 p1 pools across K2's tile edges: padding is
    -128 and never wins, also over windows that are all negative."""
    shape, kw = case
    x = _signed_pool_input(shape, sum(shape))
    args = (kw["kernel"], kw["stride"], pool_pads(*shape[1:3], **kw))
    before = k.int8_max_pool.launches
    got = k.int8_max_pool(x.to(cuda_device), *args)
    torch.cuda.synchronize()
    assert k.int8_max_pool.launches == before + 1
    assert torch.equal(got.cpu(), k.int8_max_pool_plain(x, *args))


@pytest.mark.cuda
def test_cuda_max_pool_refuses_what_it_does_not_take(cuda_device):
    """On the card K2 takes 3x3 pools at stride 1 or 2 of C % 16 == 0,
    contiguous; it never falls back."""
    x = torch.zeros((1, 9, 9, 32), dtype=torch.int8, device=cuda_device)
    before = k.int8_max_pool.launches
    with pytest.raises(ValueError, match="C % 16"):
        k.int8_max_pool(x[..., :24].contiguous(), 3, 2, ((0, 0), (0, 0)))
    with pytest.raises(ValueError, match="contiguous"):
        k.int8_max_pool(x[..., 16:], 3, 2, ((0, 0), (0, 0)))
    with pytest.raises(ValueError, match="3x3 pools"):
        k.int8_max_pool(x, 2, 2, ((0, 0), (0, 0)))
    with pytest.raises(ValueError, match="3x3 pools"):
        k.int8_max_pool(x, 3, 3, ((0, 0), (0, 0)))
    assert k.int8_max_pool.launches == before


@pytest.mark.cuda
def test_cuda_avg_pool_matches_plain(cuda_device):
    g = torch.Generator().manual_seed(2)
    x = torch.randint(-128, 128, (2, 10, 13, 32), generator=g,
                      dtype=torch.int8)
    before = k.int8_avg_pool.launches
    got = k.int8_avg_pool(x.to(cuda_device), 3, 1, 1)
    torch.cuda.synchronize()
    assert k.int8_avg_pool.launches == before + 1
    assert torch.equal(got.cpu(), k.int8_avg_pool_plain(x, 3, 1, 1))


@pytest.mark.cuda
@pytest.mark.parametrize("hw", [(35, 35), (17, 17), (8, 8), (7, 10), (1, 1)])
def test_cuda_avg_pool_exclude_pad_matches_plain(cuda_device, hw):
    """K3's exclude-pad mode (InceptionV3's 3x3 s1 SAME pools, divisors 9,
    6 and 4) on signed inputs, .5 ties included."""
    g = torch.Generator().manual_seed(hw[0] * 31 + hw[1])
    x = torch.randint(-128, 128, (3,) + hw + (48,), generator=g,
                      dtype=torch.int8)
    before = k.int8_avg_pool_exclude_pad.launches
    got = k.int8_avg_pool_exclude_pad(x.to(cuda_device), 3, 1, 1)
    torch.cuda.synchronize()
    assert k.int8_avg_pool_exclude_pad.launches == before + 1
    assert torch.equal(got.cpu(), k.int8_avg_pool_plain(
        x, 3, 1, 1, count_include_pad=False))


# K3's tile edges: (N, H, W, C) with ragged last tiles on both axes, several
# channel slabs, one-row and one-column images
K3_TILE_CASES = [
    (2, 9, 17, 32),       # tiles of 5 rows and 9 columns, ragged
    (3, 16, 33, 48),      # 8 x 11 tiles
    (2, 17, 17, 768),     # two slabs of 24 chunks
    (4, 8, 8, 2048),      # eight slabs
    (2, 1, 20, 16),       # one row: divisor 1 x columns
    (2, 20, 1, 16),       # one column
]


@pytest.mark.cuda
@pytest.mark.parametrize("case", K3_TILE_CASES)
@pytest.mark.parametrize("exclude_pad", [False, True])
def test_cuda_avg_pool_tile_edges(cuda_device, case, exclude_pad):
    """Every tile edge, halo and slab of K3's plan, both divisor modes,
    signed inputs with .5 ties."""
    g = torch.Generator().manual_seed(sum(case))
    x = torch.randint(-128, 128, case, generator=g, dtype=torch.int8)
    fn = k.int8_avg_pool_exclude_pad if exclude_pad else k.int8_avg_pool
    got = fn(x.to(cuda_device), 3, 1, 1)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), k.int8_avg_pool_plain(
        x, 3, 1, 1, count_include_pad=not exclude_pad))


@pytest.mark.cuda
def test_cuda_avg_pool_refuses_what_it_does_not_take(cuda_device):
    """On the card K3 takes the trunks' 3x3 s1 p1 pool of C % 16 == 0."""
    x = torch.zeros((1, 5, 5, 32), dtype=torch.int8, device=cuda_device)
    with pytest.raises(ValueError, match="3x3 s1 p1"):
        k.int8_avg_pool(x, 3, 2, 1)
    with pytest.raises(ValueError, match="C % 16"):
        k.int8_avg_pool_exclude_pad(x[..., :24].contiguous(), 3, 1, 1)


@pytest.mark.cuda
@pytest.mark.parametrize("hw", [(35, 35), (17, 17), (16, 17), (3, 3)])
def test_cuda_max_pool_valid_matches_plain(cuda_device, hw):
    """K2 at zero pads: InceptionV3's VALID 3x3 s2 pools, and grids whose
    last window ends before the last row or column."""
    x = _signed_pool_input((2,) + hw + (48,), hw[0] * 31 + hw[1])
    args = (3, 2, ((0, 0), (0, 0)))
    got = k.int8_max_pool(x.to(cuda_device), *args)
    torch.cuda.synchronize()
    assert got.shape[1:3] == ((hw[0] - 3) // 2 + 1, (hw[1] - 3) // 2 + 1)
    assert torch.equal(got.cpu(), k.int8_max_pool_plain(x, *args))


A1_CASES = [  # kernel, stride, padding, H, W
    ((3, 3), (2, 2), ((0, 1), (0, 1)), 15, 15),
    ((3, 3), (2, 2), ((0, 2), (0, 1)), 11, 17),
    ((3, 3), (1, 1), ((1, 1), (1, 1)), 9, 9),
    ((2, 2), (3, 3), ((0, 0), (0, 0)), 13, 13),
]


@pytest.mark.cuda
@pytest.mark.parametrize("channels", [40, 6])   # 4-channel and scalar path
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", A1_CASES)
def test_cuda_max_pool_bwd_matches_plain(cuda_device, case, dtype, channels):
    """First-match routing on tied inputs, float32 sums rounded once."""
    from action_detection_torch.ops.pooling import _reduce_max

    kernel, stride, pad, H, W = case
    g = torch.Generator().manual_seed(H * W)
    x = (torch.randint(0, 8, (3, H, W, channels), generator=g) / 4.0
         ).to(dtype)
    y = _reduce_max(x, kernel, stride, pad).contiguous()
    dy = torch.randn(y.shape, generator=g).to(dtype)
    ref = a1.max_pool_bwd_plain(x, dy, kernel, stride, pad)
    before = a1.max_pool_bwd.launches
    got = a1.max_pool_bwd(x.to(cuda_device), y.to(cuda_device),
                          dy.to(cuda_device), kernel, stride, pad)
    torch.cuda.synchronize()
    assert a1.max_pool_bwd.launches == before + 1
    assert got.dtype == dtype and torch.equal(got.cpu(), ref)


CEIL_S2 = ((3, 3), (2, 2))
A1_TILE_CASES = [  # N, H, W, C, kernel, stride, padding
    (2, 57, 57, 6) + CEIL_S2 + (pool_pads(57, 57, 3, 2, ceil=True),),
    (2, 57, 57, 40) + CEIL_S2 + (pool_pads(57, 57, 3, 2, ceil=True),),
    (2, 57, 57, 200) + CEIL_S2 + (pool_pads(57, 57, 3, 2, ceil=True),),
    (1, 112, 112, 40) + CEIL_S2 + (pool_pads(112, 112, 3, 2, ceil=True),),
    (2, 20, 19, 40, (3, 3), (1, 1), ((1, 1), (1, 1))),
    (2, 30, 29, 40, (2, 2), (3, 3), ((0, 0), (0, 0))),
    # more blocks than one wave of the card (4x4 tiles x 2 slabs x 300)
    (300, 57, 57, 40) + CEIL_S2 + (pool_pads(57, 57, 3, 2, ceil=True),),
]


@pytest.mark.cuda
@pytest.mark.parametrize("inputs", ["relu", "all_equal"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", A1_TILE_CASES)
def test_cuda_max_pool_bwd_across_tiles(cuda_device, case, dtype, inputs):
    """Several tiles per axis with a ragged last one, partial channel slabs
    and a scalar-channel C, all-tied windows, random non-integer dy (the
    order of the float32 sums counts): equal to the plain version on the
    card, and two launches give the same bits."""
    from action_detection_torch.ops.pooling import _reduce_max

    N, H, W, C, kernel, stride, pad = case
    g = torch.Generator(device=cuda_device).manual_seed(H * W + C)
    if inputs == "all_equal":
        x = torch.full((N, H, W, C), 0.5, device=cuda_device, dtype=dtype)
    else:
        x = torch.relu(torch.randn(N, H, W, C, generator=g,
                                   device=cuda_device)).to(dtype)
    y = _reduce_max(x, kernel, stride, pad).contiguous()
    dy = torch.randn(y.shape, generator=g, device=cuda_device).to(dtype)
    before = a1.max_pool_bwd.launches
    got = a1.max_pool_bwd(x, y, dy, kernel, stride, pad)
    again = a1.max_pool_bwd(x, y, dy, kernel, stride, pad)
    ref = a1.max_pool_bwd_plain(x, dy, kernel, stride, pad)
    torch.cuda.synchronize()
    assert a1.max_pool_bwd.launches == before + 2
    assert torch.equal(got, ref)
    assert torch.equal(got.view(torch.int16 if dtype == torch.bfloat16
                                else torch.int32),
                       again.view(torch.int16 if dtype == torch.bfloat16
                                  else torch.int32))


# A1 at the training CLIs' new geometry: InceptionV3's four VALID 3x3 s2
# pools (f32, and the first in bf16) and the five BNInception pools in bf16
# (--bf16), at 4 images: (N, H, W, C), stride, padding, dtype
VALID = ((0, 0), (0, 0))
A1_TRAIN_CASES = [
    ((4, 147, 147, 64), 2, VALID, torch.float32),
    ((4, 71, 71, 192), 2, VALID, torch.float32),
    ((4, 35, 35, 288), 2, VALID, torch.float32),
    ((4, 17, 17, 768), 2, VALID, torch.float32),
    ((4, 147, 147, 64), 2, VALID, torch.bfloat16),
    ((4, 112, 112, 64), 2, pool_pads(112, 112, 3, 2, ceil=True),
     torch.bfloat16),
    ((4, 56, 56, 192), 2, pool_pads(56, 56, 3, 2, ceil=True), torch.bfloat16),
    ((4, 28, 28, 320), 2, pool_pads(28, 28, 3, 2, ceil=True), torch.bfloat16),
    ((4, 14, 14, 576), 2, pool_pads(14, 14, 3, 2, ceil=True), torch.bfloat16),
    ((4, 7, 7, 1024), 1, ((1, 1), (1, 1)), torch.bfloat16),
]


@pytest.mark.cuda
@pytest.mark.parametrize("case", A1_TRAIN_CASES)
def test_cuda_max_pool_bwd_training_pools(cuda_device, case):
    """Bit-exact against the plain version at the pools of InceptionV3 and
    bf16 BNInception training (post-ReLU inputs, so zero windows tie); a
    bf16 launch also counts in ``max_pool_bwd.bf16_launches``."""
    from action_detection_torch.ops.pooling import _reduce_max

    shape, s, pad, dtype = case
    g = torch.Generator(device=cuda_device).manual_seed(sum(shape))
    x = torch.relu(torch.randn(shape, generator=g, device=cuda_device)
                   ).to(dtype)
    geo = ((3, 3), (s, s), pad)
    y = _reduce_max(x, *geo).contiguous()
    dy = torch.randn(y.shape, generator=g, device=cuda_device).to(dtype)
    before = (a1.max_pool_bwd.launches, a1.max_pool_bwd.bf16_launches)
    got = a1.max_pool_bwd(x, y, dy, *geo)
    torch.cuda.synchronize()
    assert torch.equal(got, a1.max_pool_bwd_plain(x, dy, *geo))
    bf16 = int(dtype == torch.bfloat16)
    assert (a1.max_pool_bwd.launches, a1.max_pool_bwd.bf16_launches) == \
        (before[0] + 1, before[1] + bf16)
