"""The max-pool backward kernel of the training path: wrapper, plan, plain
version.

A1 :func:`max_pool_bwd` (``csrc/pool_bwd.cu``) is the port of the JAX
package's Pallas kernel ``max_pool_bwd_pallas``: dx of an NHWC max pool,
each window's dy routed to the window's FIRST position (row-major) that
holds the window max, contributions summed in float32 and rounded once to
the storage dtype (float32 or bfloat16).

The kernel is tiled: a block owns a tile of input cells of one image and a
slab of channels, stages the x, y and dy its windows need in shared memory,
finds each window's first match once, and gathers dx from there.
:func:`pool_bwd_plan` is all of its tile arithmetic (tile sizes, each
tile's owned cells and windows, the halo, the shared-memory layout); the
wrapper passes the plan's integers to the kernel.

On a CUDA tensor the wrapper launches the kernel on the current stream,
raises if the launch reports an error, and adds one to
``max_pool_bwd.launches``; on a CPU tensor it runs the plain version
(:func:`max_pool_bwd_plain`), which is also what the kernel is compared
with. There is no fallback from CUDA to the plain version.
"""

from __future__ import annotations

import collections
import ctypes
import functools

import torch
import torch.nn.functional as F

from .int8 import (_check_launch, _cuda_or_cpu, _require, _stream_ptr,
                   count_launch)

_FLOAT_DTYPES = (torch.float32, torch.bfloat16)

#: the plan's integers, in the order of ``struct Plan`` in csrc/pool_bwd.cu
PLAN_FIELDS = (
    "N", "H", "W", "C", "Ho", "Wo", "kh", "kw", "sh", "sw", "pad_top",
    "pad_left", "is_bf16", "vec", "slab", "slabs", "tile_h", "tile_w",
    "tiles_h", "tiles_w", "win_h", "win_w", "xs_h", "xs_w", "block_x",
    "block_y", "smem", "y_off", "dy_off", "fm_off", "cov_off")
PoolBwdPlan = collections.namedtuple("PoolBwdPlan", PLAN_FIELDS)

SMEM_LIMIT = 232448   # shared memory one block may use on the H100, bytes
THREADS = 256         # threads per block (the kernel's launch bound)
NO_MATCH = 255        # a window's first-match offset is one byte
TILE_WINDOWS = 8      # windows per tile and axis, before the halo
SLAB_BYTES = 128      # channel bytes of one cell per block


def pool_out_hw(H: int, W: int, kernel, stride, padding) -> tuple:
    """(Ho, Wo) of a pool over ``padding = ((top, bottom), (left, right))``."""
    (kh, kw), (sh, sw) = kernel, stride
    (t, b), (l, r) = padding
    return (H + t + b - kh) // sh + 1, (W + l + r - kw) // sw + 1


def axis_tiles(size: int, size_out: int, k: int, s: int, pad: int,
               tile: int) -> list:
    """The tiles along one axis: ``(lo, hi, w0, w1)`` for each, where the
    tile owns input cells ``[lo, hi)`` and resolves windows ``[w0, w1]``
    (none when ``w1 < w0``: cells no window covers). Window ``w`` reads
    input cells ``w*s - pad ... w*s - pad + k - 1``; the kernel computes the
    same ranges per block (``first_window``)."""
    out = []
    for lo in range(0, size, tile):
        hi = min(lo + tile, size)
        w0 = max(0, -(-(lo + pad - k + 1) // s))
        out.append((lo, hi, w0, min(size_out - 1, (hi - 1 + pad) // s)))
    return out


def _align16(n: int) -> int:
    return -(-n // 16) * 16


def _layout(H, W, C, Ho, Wo, kernel, stride, pads, itemsize, vec,
            tile_windows, slab):
    (kh, kw), (sh, sw) = kernel, stride
    tile_h, tile_w = tile_windows * sh, tile_windows * sw
    rows = axis_tiles(H, Ho, kh, sh, pads[0], tile_h)
    cols = axis_tiles(W, Wo, kw, sw, pads[1], tile_w)

    def extent(tiles, k, s):   # most windows, most staged cells
        nw = max(max(w1 - w0 + 1, 0) for _, _, w0, w1 in tiles)
        return max(nw, 1), max((nw - 1) * s + k, 1)

    win_h, xs_h = extent(rows, kh, sh)
    win_w, xs_w = extent(cols, kw, sw)
    y_off = _align16(xs_h * xs_w * slab * itemsize)
    win_bytes = _align16(win_h * win_w * slab * itemsize)
    dy_off = y_off + win_bytes
    fm_off = dy_off + win_bytes
    cov_off = fm_off + _align16(win_h * win_w * slab)
    smem = cov_off + 8 * (tile_h + tile_w)
    block_x = slab // vec
    return dict(slab=slab, slabs=-(-C // slab), tile_h=tile_h,
                tile_w=tile_w, tiles_h=len(rows), tiles_w=len(cols),
                win_h=win_h, win_w=win_w, xs_h=xs_h, xs_w=xs_w,
                block_x=block_x, block_y=max(1, THREADS // block_x),
                smem=smem, y_off=y_off, dy_off=dy_off, fm_off=fm_off,
                cov_off=cov_off)


@functools.lru_cache(maxsize=256)
def pool_bwd_plan(shape: tuple, kernel: tuple, stride: tuple,
                  padding: tuple, bf16: bool, vec: int,
                  tile_windows: int = TILE_WINDOWS) -> PoolBwdPlan:
    """A1's launch plan for NHWC ``shape``.

    ``vec`` is the channels per access: 16 bytes' worth (4 float32, 8
    bfloat16) when ``C`` is a multiple of it and the tensors are 16-byte
    aligned, else 1. A tile owns ``tile_windows * stride`` input cells per
    axis (the last tile is ragged) and a slab of channels (128 bytes'
    worth, at most ``C``, widened on small images so that a block has two
    cells per thread to gather); the plan halves the slab, then shrinks the
    tile, until the block's shared memory fits.
    Raises ValueError on what the kernel does not take.
    """
    N, H, W, C = shape
    (kh, kw), (sh, sw) = kernel, stride
    itemsize = 2 if bf16 else 4
    Ho, Wo = pool_out_hw(H, W, kernel, stride, padding)
    _require(Ho > 0 and Wo > 0, f"empty pool output for {shape}")
    _require(kh * kw < NO_MATCH, f"max_pool_bwd takes windows of at most "
             f"{NO_MATCH - 1} cells, got {kh}x{kw}")
    _require(min(kh, kw, sh, sw) > 0, "kernel and stride must be positive")
    _require(min(padding[0] + padding[1]) >= 0, "negative padding")
    _require(H * W * C < 2 ** 31, f"max_pool_bwd takes images of fewer "
             f"than 2**31 elements, got {H}x{W}x{C}")
    _require(vec in (1, 16 // itemsize) and C % vec == 0,
             f"vec {vec} does not fit C={C} of {itemsize}-byte elements")
    slab = min(C, SLAB_BYTES // itemsize if vec > 1 else 32)
    # small images (one tile): widen the slab until a block gathers at
    # least two cells per thread
    cells = min(tile_windows * sh, H) * min(tile_windows * sw, W)
    while (cells * slab < 2 * THREADS * vec and 2 * slab <= C
           and 2 * slab <= THREADS * vec):
        slab *= 2
    pads = (padding[0][0], padding[1][0])
    while True:
        lay = _layout(H, W, C, Ho, Wo, kernel, stride, pads, itemsize, vec,
                      tile_windows, slab)
        if lay["smem"] <= SMEM_LIMIT:
            break
        if slab > vec and (slab // 2) % vec == 0:
            slab //= 2
        elif tile_windows > 1:
            tile_windows -= 1
        else:
            raise ValueError(f"max_pool_bwd: a {kh}x{kw} window tile needs "
                             f"{lay['smem']} bytes of shared memory")
    _require(lay["slabs"] <= 65535, f"too many channel slabs ({C} channels)")
    return PoolBwdPlan(N=N, H=H, W=W, C=C, Ho=Ho, Wo=Wo, kh=kh, kw=kw,
                       sh=sh, sw=sw, pad_top=pads[0], pad_left=pads[1],
                       is_bf16=int(bf16), vec=vec, **lay)


def plan_tiles(plan: PoolBwdPlan) -> tuple:
    """The plan's row tiles and column tiles, as :func:`axis_tiles`."""
    return (axis_tiles(plan.H, plan.Ho, plan.kh, plan.sh, plan.pad_top,
                       plan.tile_h),
            axis_tiles(plan.W, plan.Wo, plan.kw, plan.sw, plan.pad_left,
                       plan.tile_w))


def max_pool_bwd_plain(x: torch.Tensor, dy: torch.Tensor, kernel, stride,
                       padding) -> torch.Tensor:
    """A1's plain version: torch's own max-pool backward on float32 copies
    (its routing is the first max of each window, row-major; padding is
    -inf and never wins), rounded once to ``x``'s dtype."""
    (t, b), (l, r) = padding
    with torch.enable_grad():
        xf = x.detach().permute(0, 3, 1, 2).float().requires_grad_()
        xp = F.pad(xf, (l, r, t, b), value=float("-inf"))
        yf = F.max_pool2d(xp, tuple(kernel), tuple(stride))
        (dx,) = torch.autograd.grad(yf, xf, dy.permute(0, 3, 1, 2).float())
    return dx.permute(0, 2, 3, 1).to(x.dtype).contiguous()


def max_pool_bwd(x: torch.Tensor, y: torch.Tensor, dy: torch.Tensor,
                 kernel, stride, padding) -> torch.Tensor:
    """dx (N, H, W, C) of ``y = max_pool(x)`` for NHWC ``x``, ``y`` and
    ``dy``; ``kernel``/``stride`` are (h, w) pairs and ``padding`` is
    ``((top, bottom), (left, right))``."""
    on_cuda = _cuda_or_cpu(x, y, dy)
    _require(x.dim() == 4 and y.dim() == 4 and dy.dim() == 4,
             "x, y and dy must be NHWC")
    _require(x.dtype in _FLOAT_DTYPES and y.dtype == x.dtype
             and dy.dtype == x.dtype,
             f"max_pool_bwd takes float32 or bfloat16 of one dtype, got "
             f"{x.dtype}, {y.dtype}, {dy.dtype}")
    N, H, W, C = x.shape
    Ho, Wo = pool_out_hw(H, W, kernel, stride, padding)
    _require(Ho > 0 and Wo > 0 and tuple(y.shape) == (N, Ho, Wo, C)
             and tuple(dy.shape) == (N, Ho, Wo, C),
             f"y/dy shape {tuple(y.shape)}/{tuple(dy.shape)} does not match "
             f"the pool of {tuple(x.shape)} (expected {(N, Ho, Wo, C)})")
    if not on_cuda:
        return max_pool_bwd_plain(x, dy, kernel, stride, padding)

    _require(x.is_contiguous() and y.is_contiguous() and dy.is_contiguous(),
             "max_pool_bwd: x, y and dy must be contiguous NHWC")
    dx = torch.empty_like(x)
    if dx.numel() == 0:
        return dx
    from .build import load_library

    full = 16 // x.element_size()
    aligned = all(t.data_ptr() % 16 == 0 for t in (x, y, dy, dx))
    plan = pool_bwd_plan(
        tuple(x.shape), tuple(kernel), tuple(stride),
        (tuple(padding[0]), tuple(padding[1])), x.dtype == torch.bfloat16,
        full if C % full == 0 and aligned else 1)
    ints = (ctypes.c_int * len(plan))(*plan)
    with torch.cuda.device(x.device):
        rc = load_library().adt_max_pool_bwd(
            x.data_ptr(), y.data_ptr(), dy.data_ptr(), dx.data_ptr(), ints,
            len(plan), _stream_ptr())
    _check_launch(rc, "max_pool_bwd")
    count_launch(max_pool_bwd)
    if x.dtype == torch.bfloat16:
        max_pool_bwd.bf16_launches += 1
    return dx


max_pool_bwd.launches = 0
max_pool_bwd.bf16_launches = 0     # of ``launches``, those in bf16
