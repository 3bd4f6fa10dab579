"""The int8 kernels of the scoring path: wrappers, plans, plain versions,
counters.

Three hand-written CUDA kernels (``csrc/int8_conv.cu``,
``csrc/int8_pool.cu``) carry the int8 end-to-end BNInception and
InceptionV3 trunks:

* K1 :func:`int8_conv` — s8 x s8 -> s32 NHWC conv on the int8 tensor cores
  (``wgmma``), padded per axis (``(pad_h, pad_w)``: InceptionV3's
  1x7/7x1/1x3/3x1 convs), with the requantizing int8 epilogue (runtime) or
  the bf16 dequantizing epilogue (calibration); its tile is
  :func:`int8_conv_plan`;
* K2 :func:`int8_max_pool` — int8 3x3 max pool at stride 1 or 2 over
  explicit padding that never wins (-128), or none (InceptionV3's VALID
  pools);
* K3 — int8 3x3 s1 p1 average pool, one tiled kernel with two modes and a
  wrapper each: :func:`int8_avg_pool` counts padded cells (BNInception's
  Caffe pools), :func:`int8_avg_pool_exclude_pad` divides by the in-image
  cells only (InceptionV3's SAME pools: 9, 6 or 4).

K2 and K3 share one tile plan, :func:`int8_pool_plan`.

Each wrapper checks device, dtype, shape and contiguity and raises on what
its kernel does not take. On a CUDA tensor it launches the kernel on the
current stream, raises if the launch reports an error, and adds one to its
``launches`` count; on a CPU tensor it runs the kernel's plain version
(``*_plain``), which is also what the kernels are compared with. There is
no fallback from CUDA to the plain version. K1-K3 read and write 16
bytes at a time, so on CUDA they take only channel counts, pixel strides
and addresses that are multiples of 16 (:func:`int8_conv_refusal`,
:func:`_check_pool_input`; every conv and pool of both trunks meets it);
the CPU path keeps the looser checks of the plain versions.

K1 and K2 write into an ``out=`` channel slice where given (the pixel
stride, as K1 reads ``x``), so an Inception module's branches fill one
buffer (:func:`channel_slots`) and its concat is a view of it
(:func:`concat_channels`, which counts the concats assembled in place and
those that copied).

Every function keeps the JAX package's NHWC layout and its exact rounding:
the plain versions are bit-identical to ``_conv_i8_e2e``, ``_conv_int8``,
``_max_pool_i8`` and ``_avg_pool_i8_include_pad`` of ``bn_inception_int8``
and to ``_ForwardOps._conv_layer``, ``max_pool`` and ``avg_pool_same`` of
``inception_v3_int8``.
"""

from __future__ import annotations

import collections
import contextlib
import functools
import threading
from typing import Optional, Tuple, Union

import torch
import torch.nn.functional as F

_OUT_DTYPES = (torch.int8, torch.bfloat16)

#: ((top, bottom), (left, right)) spatial padding of a pool
Pads = Tuple[Tuple[int, int], Tuple[int, int]]
#: a conv's symmetric padding: one int for both axes, or (pad_h, pad_w)
ConvPad = Union[int, Tuple[int, int]]
#: where K1 writes (:func:`int8_conv`): a new tensor (None), a tensor, or a
#: pair (head, tail) splitting the output channels
ConvOut = Union[None, torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]


# K1's tile (csrc/int8_conv.cu: kBM, kBK, kStages); the column tile (32,
# 64 or 128) is planned per shape
CONV_BM = 128       # output pixels per block: two warpgroups of m64
CONV_BK = 128       # depth bytes per pipeline stage: four k32 steps
CONV_STAGES = 4     # ring depth: stage k+2 loads while stage k multiplies
ConvPlan = collections.namedtuple(
    "ConvPlan", "M K bn m_tiles n_tiles k_stages smem")

# K2's and K3's tile (csrc/int8_pool.cu): at most POOL_TILE_H[stride] x
# POOL_TILE_W output cells and POOL_THREADS threads a block, the staged
# input cells within POOL_SMEM. Stride-2 tiles of 2 rows stage 5 input rows
# and beat 4- and 8-row tiles on the card (PERF.md §6)
POOL_TILE_H = {1: 8, 2: 2}
POOL_TILE_W = 8
POOL_THREADS = 256
POOL_SMEM = 48 * 1024
PoolPlan = collections.namedtuple(
    "PoolPlan", "tile_h tile_w tiles_h tiles_w rows cols slab slabs smem")


def conv_pads(pad: ConvPad) -> Tuple[int, int]:
    """``(pad_h, pad_w)`` of a conv's ``pad`` argument."""
    if isinstance(pad, int):
        return pad, pad
    pad_h, pad_w = pad
    return int(pad_h), int(pad_w)


# --- plain versions (CPU path and the kernels' reference) ------------------


def int8_conv_plain(x: torch.Tensor, w: torch.Tensor, scale: torch.Tensor,
                    bias: torch.Tensor, stride: int = 1, pad: ConvPad = 0,
                    out_dtype: torch.dtype = torch.int8,
                    out: ConvOut = None) -> ConvOut:
    """K1's plain version: a float64 conv on int-valued tensors (exact: every
    partial sum is an integer far below 2**53), then the same f32 epilogue
    ops as the JAX package — y*scale and +bias round separately. Written
    into ``out`` where given (:func:`int8_conv`)."""
    y = F.conv2d(x.permute(0, 3, 1, 2).to(torch.float64),
                 w.permute(0, 3, 1, 2).to(torch.float64),
                 stride=stride, padding=conv_pads(pad))
    y = y.permute(0, 2, 3, 1).to(torch.int32).to(torch.float32)
    y = torch.clamp_min(y * scale + bias, 0.0)
    if out_dtype == torch.int8:
        y = torch.clamp(torch.round(y), 0.0, 127.0).to(torch.int8)
    else:
        y = y.to(torch.bfloat16)
    return _write(y, out)


def int8_max_pool_plain(x: torch.Tensor, kernel: int, stride: int,
                        pads: Pads, out: torch.Tensor = None
                        ) -> torch.Tensor:
    """K2's plain version: -128-padded max pool, exact through float32;
    written into ``out`` where given (:func:`int8_max_pool`)."""
    (t, b), (l, r) = pads
    xf = F.pad(x.permute(0, 3, 1, 2).to(torch.float32), (l, r, t, b),
               value=-128.0)
    y = F.max_pool2d(xf, kernel, stride)
    return _write(y.to(torch.int8).permute(0, 2, 3, 1), out)


def _write(y: torch.Tensor, out: ConvOut) -> ConvOut:
    """``y`` as a contiguous tensor, or copied into ``out``: one tensor, or
    a pair ``(head, tail)`` that takes ``y``'s first ``head.shape[-1]``
    channels and the rest."""
    if out is None:
        return y.contiguous()
    if isinstance(out, torch.Tensor):
        out.copy_(y)
        return out
    head, tail = out
    split = head.shape[-1]
    head.copy_(y[..., :split])
    tail.copy_(y[..., split:])
    return out


def int8_avg_pool_plain(x: torch.Tensor, kernel: int, stride: int,
                        pad: int, count_include_pad: bool = True
                        ) -> torch.Tensor:
    """K3's plain version: the exact window sum (float64 with
    ``divisor_override=1``), then the f32 division by ``kernel**2`` (or, with
    ``count_include_pad=False``, by the window's in-image cell count) and
    round half to even."""
    xc = x.permute(0, 3, 1, 2).to(torch.float64)
    s = F.avg_pool2d(xc, kernel, stride, pad, divisor_override=1)
    if count_include_pad:
        count = torch.tensor(float(kernel * kernel))
    else:
        ones = torch.ones((1, 1) + xc.shape[2:], dtype=torch.float64,
                          device=x.device)
        count = F.avg_pool2d(ones, kernel, stride, pad,
                             divisor_override=1).to(torch.float32)
    v = torch.round(s.to(torch.float32) / count)
    return (torch.clamp(v, -128.0, 127.0).to(torch.int8)
            .permute(0, 2, 3, 1).contiguous())


# --- tile plans -------------------------------------------------------------


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


@functools.lru_cache(maxsize=512)
def int8_conv_plan(N: int, Ho: int, Wo: int, O: int, KH: int, KW: int,
                   C: int) -> ConvPlan:
    """K1's launch plan: ``M = N*Ho*Wo`` output pixels in row tiles of
    ``CONV_BM``, ``O`` output channels in column tiles of ``bn``, the depth
    ``K = KH*KW*C`` in ``k_stages`` stages of ``CONV_BK`` bytes (the last
    zero-filled past ``K``); ``smem`` is the block's dynamic shared memory
    for the int8 epilogue: the ring slots ``k_stages`` uses (at most
    ``CONV_STAGES``) or the output tile, whichever is larger, + 1024.

    ``bn`` is 32 for ``O <= 32``; else 64 where 64-column tiles pad ``O``
    to fewer columns than 128-column ones (or ``O <= 64``); else 128.
    """
    M = N * Ho * Wo
    K = KH * KW * C
    if O <= 32:
        bn = 32
    elif O <= 64 or _cdiv(O, 64) * 64 < _cdiv(O, 128) * 128:
        bn = 64
    else:
        bn = 128
    k_stages = _cdiv(K, CONV_BK)
    ring = min(k_stages, CONV_STAGES) * (CONV_BM + bn) * CONV_BK
    return ConvPlan(M=M, K=K, bn=bn, m_tiles=_cdiv(M, CONV_BM),
                    n_tiles=_cdiv(O, bn), k_stages=k_stages,
                    smem=max(ring, CONV_BM * (bn + 16)) + 1024)


def _balanced_tile(size: int, most: int) -> int:
    """The tile that cuts ``size`` into the fewest pieces of at most
    ``most``, as even as they go (35 at most 8: 7 x 5)."""
    return _cdiv(size, _cdiv(size, most))


@functools.lru_cache(maxsize=256)
def int8_pool_plan(Ho: int, Wo: int, C: int, stride: int = 1,
                   tile_h: Optional[int] = None,
                   tile_w: int = POOL_TILE_W) -> PoolPlan:
    """K2's and K3's launch plan for a 3x3 pool at ``stride`` with an
    (N, Ho, Wo, C) output: a block owns ``tile_h x tile_w`` output cells
    (balanced cuts of at most the given sizes, ``tile_h`` by default
    ``POOL_TILE_H[stride]``) of one image and ``slab`` of
    the ``C / 16`` 16-byte channel chunks. It stages the input cells under
    the tile's windows, ``rows x cols`` = ``((tile_h - 1) * stride + 3) x
    ((tile_w - 1) * stride + 3)`` cells of the slab (a 3x3 s1 tile and its
    one-cell halo). ``slab`` is the largest divisor of ``C / 16`` that keeps
    the block within ``POOL_THREADS`` threads (one per column and chunk)
    and its staged cells within ``POOL_SMEM`` bytes."""
    _require(C % 16 == 0, f"int8_pool_plan needs C % 16 == 0, got {C}")
    tile_h = _balanced_tile(Ho, tile_h or POOL_TILE_H[stride])
    tile_w = _balanced_tile(Wo, tile_w)
    rows = (tile_h - 1) * stride + 3
    cols = (tile_w - 1) * stride + 3
    chunks = C // 16
    slab = max(d for d in range(1, chunks + 1) if chunks % d == 0
               and d * tile_w <= POOL_THREADS
               and rows * cols * d * 16 <= POOL_SMEM)
    return PoolPlan(tile_h=tile_h, tile_w=tile_w,
                    tiles_h=_cdiv(Ho, tile_h), tiles_w=_cdiv(Wo, tile_w),
                    rows=rows, cols=cols, slab=slab, slabs=chunks // slab,
                    smem=rows * cols * slab * 16)


# --- wrappers ---------------------------------------------------------------


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def _cuda_or_cpu(*ts: torch.Tensor) -> bool:
    """True for CUDA tensors (launch), False for CPU ones (plain version)."""
    dev = ts[0].device
    _require(dev.type in ("cpu", "cuda"),
             f"int8 kernels take CPU or CUDA tensors, got {dev}")
    for t in ts[1:]:
        _require(t.device == dev, f"tensors on {dev} and {t.device}")
    return dev.type == "cuda"


def _stream_ptr() -> int:
    return torch.cuda.current_stream().cuda_stream


def _check_launch(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name}: kernel launch failed with cudaError_t "
                           f"{rc}")


#: guards the counters' ``+=`` (a ``fan_out``'s scorers launch from threads
#: of their own)
COUNT_LOCK = threading.Lock()
# per thread: the tally of the CUDA graph it captures, if it captures one
_capturing = threading.local()


def count_launch(wrapper) -> None:
    """One launch more of ``wrapper``: on its ``launches``, or on the tally
    of :func:`tally_launches` while this thread captures a CUDA graph."""
    tally = getattr(_capturing, "tally", None)
    if tally is None:
        with COUNT_LOCK:
            wrapper.launches += 1
    else:
        tally[wrapper.__name__] = tally.get(wrapper.__name__, 0) + 1


@contextlib.contextmanager
def tally_launches():
    """Within it, this thread's launches are counted in the dict it yields
    (by counter name) and not on the counters: a CUDA graph's capture runs
    nothing on the card, and each of its replays adds the tally
    (``kernels.add_launch_counts``). Other threads count as before."""
    outer = getattr(_capturing, "tally", None)
    _capturing.tally = tally = {}
    try:
        yield tally
    finally:
        _capturing.tally = outer


def int8_conv_refusal(x: torch.Tensor, w: torch.Tensor) -> Optional[str]:
    """Why K1 on the card would refuse these operands, or None: it needs
    ``C % 16 == 0``, an NHWC ``x`` (or a channel slice of one) whose pixel
    stride is a multiple of 16 and whose data starts 16-byte aligned, and a
    contiguous, 16-byte aligned ``w``. Device-independent, so the CPU tests
    can walk the trunks through it."""
    N, H, W, C = x.shape
    ps = x.stride(2)
    if C % 16:
        return f"int8_conv on CUDA needs C % 16 == 0, got C={C}"
    if not (x.stride(3) == 1 and ps >= C and ps % 16 == 0
            and (H == 1 or x.stride(1) == W * ps)
            and (N == 1 or x.stride(0) == H * W * ps)):
        return (f"int8_conv on CUDA needs an NHWC x or a channel slice of "
                f"one with a pixel stride % 16 == 0 (strides {x.stride()})")
    if x.data_ptr() % 16 or w.data_ptr() % 16:
        return ("int8_conv on CUDA needs 16-byte aligned x and w (a channel "
                "slice must start at a multiple of 16 channels)")
    if not w.is_contiguous():
        return "int8_conv needs a contiguous w"
    return None


def _dests(out: ConvOut) -> tuple:
    return (out,) if isinstance(out, torch.Tensor) else tuple(out)


def _check_out(out: ConvOut, shape: tuple, dtype: torch.dtype,
               device: torch.device) -> None:
    """``out`` (one tensor, or a pair on K1) can hold an ``shape`` result of
    ``dtype``: each part (N, Ho, Wo, channels) of that dtype on that device,
    the channels adding up."""
    dests = _dests(out)
    _require(1 <= len(dests) <= 2 and all(isinstance(d, torch.Tensor)
                                          for d in dests),
             "out must be a tensor or a pair of tensors")
    for d in dests:
        _require(d.dim() == 4 and tuple(d.shape[:3]) == tuple(shape[:3])
                 and d.dtype == dtype and d.device == device,
                 f"out {tuple(d.shape)} {d.dtype} on {d.device} cannot hold "
                 f"a {tuple(shape)} {dtype} result on {device}")
    _require(sum(d.shape[3] for d in dests) == shape[3],
             f"out's channels {[d.shape[3] for d in dests]} do not add up "
             f"to {shape[3]}")


def int8_out_refusal(out: ConvOut) -> Optional[str]:
    """Why K1 or K2 on the card would refuse to write into ``out``, or
    None: each part is NHWC or a channel slice of an NHWC tensor whose pixel
    stride is a multiple of 16 bytes and whose data starts 16-byte aligned
    (:func:`int8_conv_refusal`'s rule for ``x``, so 16-byte stores never
    straddle a pixel), and a pair's head spans a multiple of 16 bytes, so
    that each 16-byte store lands wholly in one part. Device-independent, so
    the CPU tests can walk the trunks through it."""
    dests = _dests(out)
    for d in dests:
        N, H, W, C = d.shape
        ps, esize = d.stride(2), d.element_size()
        if not (d.stride(3) == 1 and ps >= C and ps * esize % 16 == 0
                and (H == 1 or d.stride(1) == W * ps)
                and (N == 1 or d.stride(0) == H * W * ps)):
            return (f"out on CUDA must be NHWC or a channel slice of one with "
                    f"a pixel stride of 16-byte multiples (strides "
                    f"{d.stride()})")
        if d.data_ptr() % 16:
            return ("out on CUDA must start 16-byte aligned (a channel slice "
                    "at a multiple of 16 bytes)")
    if len(dests) == 2 and dests[0].shape[3] * dests[0].element_size() % 16:
        return (f"a split out's head on CUDA must span a multiple of 16 "
                f"bytes, got {dests[0].shape[3]} channels")
    return None


def int8_conv(x: torch.Tensor, w: torch.Tensor, scale: torch.Tensor,
              bias: torch.Tensor, stride: int = 1, pad: ConvPad = 0,
              out_dtype: torch.dtype = torch.int8,
              out: ConvOut = None) -> ConvOut:
    """(N, H, W, C) int8 ⊛ (O, KH, KW, C) int8 -> (N, Ho, Wo, O), zero
    padding ``pad`` (both axes) or ``(pad_h, pad_w)`` on each side.

    ``out_dtype=torch.int8``: ``clip(round(max(y*scale + bias, 0)), 0, 127)``
    (``scale``/``bias`` are the e2e ``m``/``bq``); ``torch.bfloat16``:
    ``bf16(max(y*scale + bias, 0))`` (``scale = sx*sw``, the calibration
    conv). ``x`` may be a channel slice of a wider NHWC tensor; ``C`` must be
    a multiple of 4, and on CUDA of 16 (:func:`int8_conv_refusal`).

    ``out``: None (a new tensor, returned), an (N, Ho, Wo, O) tensor or a
    channel slice of a wider one (an Inception module's output buffer), or
    a pair ``(head, tail)`` of such whose channels add up to ``O``: the
    first ``head.shape[-1]`` output channels go to ``head``, the rest to
    ``tail`` (the fused branch-entry conv: its 1x1 branch into the module's
    buffer, the reduce heads apart). ``out`` is returned. On CUDA each part
    meets :func:`int8_out_refusal`.
    """
    on_cuda = _cuda_or_cpu(x, w, scale, bias)
    _require(x.dim() == 4 and w.dim() == 4, "x must be NHWC, w (O,KH,KW,C)")
    _require(x.dtype == torch.int8 and w.dtype == torch.int8,
             f"int8 operands required, got {x.dtype} and {w.dtype}")
    _require(out_dtype in _OUT_DTYPES, f"out_dtype {out_dtype} unsupported")
    N, H, W, C = x.shape
    O, KH, KW, Cw = w.shape
    _require(Cw == C, f"weight depth {Cw} != input channels {C}")
    _require(scale.dtype == torch.float32 and bias.dtype == torch.float32
             and tuple(scale.shape) == (O,) and tuple(bias.shape) == (O,),
             "scale and bias must be float32 of shape (O,)")
    pad_h, pad_w = conv_pads(pad)
    _require(pad_h >= 0 and pad_w >= 0, f"negative padding {pad}")
    Ho = (H + 2 * pad_h - KH) // stride + 1
    Wo = (W + 2 * pad_w - KW) // stride + 1
    _require(Ho > 0 and Wo > 0, f"empty output for {tuple(x.shape)} "
             f"k{KH}x{KW} s{stride} p{pad}")
    _require(C % 4 == 0, f"int8_conv needs C % 4 == 0, got C={C}")
    if out is not None:
        _check_out(out, (N, Ho, Wo, O), out_dtype, x.device)
    if not on_cuda:
        return int8_conv_plain(x, w, scale, bias, stride, pad, out_dtype,
                               out)

    refusal = int8_conv_refusal(x, w)
    _require(refusal is None, refusal)
    _require(scale.is_contiguous() and bias.is_contiguous(),
             "scale and bias must be contiguous")
    ps = x.stride(2)
    plan = int8_conv_plan(N, Ho, Wo, O, KH, KW, C)
    _require(plan.M < 2 ** 31 and plan.m_tiles <= 65535
             and H * W * ps < 2 ** 31 and O * plan.K < 2 ** 31,
             f"int8_conv: {tuple(x.shape)} -> {O} exceeds the kernel's "
             "32-bit offsets")
    if out is None:
        out = torch.empty((N, Ho, Wo, O), dtype=out_dtype, device=x.device)
    else:
        refusal = int8_out_refusal(out)
        _require(refusal is None, refusal)
    head, tail = (out, out) if isinstance(out, torch.Tensor) else out
    if N * Ho * Wo * O == 0:
        return out
    from .build import load_library

    lib = load_library()
    with torch.cuda.device(x.device):
        rc = lib.adt_int8_conv(
            x.data_ptr(), w.data_ptr(), scale.data_ptr(), bias.data_ptr(),
            head.data_ptr(), tail.data_ptr(), N, H, W, C, ps, O, KH, KW,
            stride, pad_h, pad_w, Ho, Wo, head.stride(2), tail.stride(2),
            O if head is tail else head.shape[3], plan.bn,
            int(out_dtype == torch.bfloat16), _stream_ptr())
    _check_launch(rc, "int8_conv")
    count_launch(int8_conv)
    return out


def _check_pool_input(name: str, x: torch.Tensor) -> None:
    """K2's and K3's 16-byte rule on the card: ``C % 16 == 0`` and a
    contiguous NHWC ``x`` starting 16-byte aligned, with 32-bit offsets
    inside an image."""
    N, H, W, C = x.shape
    _require(C % 16 == 0, f"{name} on CUDA needs C % 16 == 0, got C={C}")
    _require(x.is_contiguous() and x.data_ptr() % 16 == 0,
             f"{name}: x must be contiguous NHWC, 16-byte aligned")
    _require(H * W * C < 2 ** 31 and N <= 65535,
             f"{name}: images of 2**31 bytes or more, or over 65535 images")


def int8_max_pool(x: torch.Tensor, kernel: int, stride: int,
                  pads: Pads, out: torch.Tensor = None) -> torch.Tensor:
    """int8 NHWC max pool over ``pads = ((top, bottom), (left, right))``;
    padding never wins (-128, the reduce init). On CUDA: 3x3 at stride 1
    or 2, ``top == left``, pads below 3, ``C % 16 == 0``. ``out``: None (a
    new tensor), or an (N, Ho, Wo, C) int8 tensor or channel slice of a
    wider one to write into (a stride-2 module's passthrough branch), on
    CUDA under :func:`int8_out_refusal`'s rule; returned."""
    on_cuda = _cuda_or_cpu(x)
    _require(x.dim() == 4 and x.dtype == torch.int8, "x must be int8 NHWC")
    N, H, W, C = x.shape
    (t, b), (l, r) = pads
    Ho = (H + t + b - kernel) // stride + 1
    Wo = (W + l + r - kernel) // stride + 1
    if out is not None:
        _require(isinstance(out, torch.Tensor), "out must be a tensor")
        _check_out(out, (N, Ho, Wo, C), torch.int8, x.device)
    if not on_cuda:
        return int8_max_pool_plain(x, kernel, stride, pads, out)

    _require(kernel == 3 and stride in (1, 2) and t == l
             and all(0 <= p < 3 for p in (t, b, l, r)),
             "int8_max_pool on CUDA takes 3x3 pools at stride 1 or 2 with "
             f"top == left padding, got k{kernel} s{stride} pads {pads}")
    _require(Ho > 0 and Wo > 0, f"int8_max_pool: empty output for "
             f"{tuple(x.shape)} s{stride} pads {pads}")
    _check_pool_input("int8_max_pool", x)
    if out is None:
        out = torch.empty((N, Ho, Wo, C), dtype=torch.int8, device=x.device)
    else:
        refusal = int8_out_refusal(out)
        _require(refusal is None, refusal)
    ops = out.stride(2)
    _require(Ho * Wo * ops < 2 ** 31,
             "int8_max_pool: output images of 2**31 bytes or more")
    if out.numel() == 0:
        return out
    plan = int8_pool_plan(Ho, Wo, C, stride)
    from .build import load_library

    with torch.cuda.device(x.device):
        rc = load_library().adt_int8_max_pool(
            x.data_ptr(), out.data_ptr(), N, H, W, C, Ho, Wo, ops, stride,
            t, plan.tile_h, plan.tile_w, plan.slab, _stream_ptr())
    _check_launch(rc, "int8_max_pool")
    count_launch(int8_max_pool)
    return out


def _avg_pool(wrapper, x: torch.Tensor, kernel: int, stride: int, pad: int,
              count_include_pad: bool) -> torch.Tensor:
    name = wrapper.__name__
    on_cuda = _cuda_or_cpu(x)
    _require(x.dim() == 4 and x.dtype == torch.int8, "x must be int8 NHWC")
    _require(0 <= 2 * pad <= kernel, f"{name}: pad {pad} exceeds half the "
             f"window {kernel}")
    if not on_cuda:
        return int8_avg_pool_plain(x, kernel, stride, pad, count_include_pad)

    N, H, W, C = x.shape
    _require((kernel, stride, pad) == (3, 1, 1), f"{name} on CUDA takes the "
             f"trunks' 3x3 s1 p1 pool, got k{kernel} s{stride} p{pad}")
    _check_pool_input(name, x)
    out = torch.empty_like(x)
    if out.numel() == 0:
        return out
    plan = int8_pool_plan(H, W, C)
    from .build import load_library

    with torch.cuda.device(x.device):
        rc = load_library().adt_int8_avg_pool(
            x.data_ptr(), out.data_ptr(), N, H, W, C, plan.tile_h,
            plan.tile_w, plan.slab, int(not count_include_pad),
            _stream_ptr())
    _check_launch(rc, name)
    count_launch(wrapper)
    return out


def int8_avg_pool(x: torch.Tensor, kernel: int, stride: int,
                  pad: int) -> torch.Tensor:
    """int8 NHWC count-include-pad average pool (divisor ``kernel**2``),
    rounded half to even back to the input's scale (on CUDA: 3x3 s1 p1,
    ``C % 16 == 0``)."""
    return _avg_pool(int8_avg_pool, x, kernel, stride, pad, True)


def int8_avg_pool_exclude_pad(x: torch.Tensor, kernel: int, stride: int,
                              pad: int) -> torch.Tensor:
    """int8 NHWC average pool that divides each window's sum by its
    in-image cell count (``count_include_pad=False``), rounded half to
    even: K3's second mode."""
    return _avg_pool(int8_avg_pool_exclude_pad, x, kernel, stride, pad,
                     False)


# --- in-place module assembly ----------------------------------------------


class NamedCount:
    """A counter of something other than a kernel's launches, which
    :func:`count_launch` and :func:`tally_launches` take as they take a
    wrapper: its count on ``launches``, under ``name``."""

    def __init__(self, name: str):
        self.__name__ = name
        self.launches = 0


#: the walks' concats that cost nothing, their parts already adjacent
#: channel slices of one buffer, and those that copied (``torch.cat``)
CONCAT_IN_PLACE = NamedCount("concat_in_place")
CONCAT_COPIED = NamedCount("concat_copied")


def channel_slots(shape: Tuple[int, int, int], widths, device
                  ) -> Optional[list]:
    """An Inception module's output assembled in place: one new (N, Ho, Wo,
    sum(widths)) int8 buffer (``shape`` = (N, Ho, Wo)), cut into adjacent
    channel slices of ``widths``, which each branch's last K1 or K2 launch
    writes through ``out=``; :func:`concat_channels` then joins them at no
    cost. None where a width is not a multiple of 16, since a slice must
    start 16-byte aligned on the card (:func:`int8_out_refusal`): the
    branches then write tensors of their own, and the concat copies."""
    widths = [int(c) for c in widths]
    if any(c % 16 for c in widths):
        return None
    buf = torch.empty(tuple(shape) + (sum(widths),), dtype=torch.int8,
                      device=device)
    return list(torch.split(buf, widths, dim=-1))


def concat_channels(parts, slots=None) -> torch.Tensor:
    """NHWC concat along the channels of ``parts``, which the walk wrote
    into ``slots``: adjacent channel slices of one module buffer
    (:func:`channel_slots`; a nested concat's, a run of them), or Nones
    where the module has no buffer. With slots it is the slice they span,
    a view, counted on ``concat_in_place``; else ``torch.cat``, counted on
    ``concat_copied``. Counted on either device (the walk, not a kernel,
    decides), through :func:`count_launch`, so a captured step's concats
    count on each replay."""
    if slots is None or slots[0] is None:
        count_launch(CONCAT_COPIED)
        return torch.cat(parts, dim=-1)
    count_launch(CONCAT_IN_PLACE)
    first = slots[0]
    return first.as_strided(tuple(first.shape[:3])
                            + (sum(s.shape[3] for s in slots),),
                            first.stride())


for _k in (int8_conv, int8_max_pool, int8_avg_pool,
           int8_avg_pool_exclude_pad):
    _k.launches = 0
