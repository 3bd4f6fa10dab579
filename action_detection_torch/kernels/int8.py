"""The int8 kernels of the scoring path: wrappers, plain versions, counters.

Three hand-written CUDA kernels (``csrc/int8_conv.cu``,
``csrc/int8_pool.cu``) carry the int8 end-to-end BNInception and
InceptionV3 trunks:

* K1 :func:`int8_conv` — s8 x s8 -> s32 NHWC conv, padded per axis
  (``(pad_h, pad_w)``: InceptionV3's 1x7/7x1/1x3/3x1 convs), with the
  requantizing int8 epilogue (runtime) or the bf16 dequantizing epilogue
  (calibration);
* K2 :func:`int8_max_pool` — int8 max pool over explicit padding that
  never wins (-128), or none (InceptionV3's VALID pools);
* K3 — int8 average pool, one kernel with two modes and a wrapper each:
  :func:`int8_avg_pool` counts padded cells (BNInception's Caffe pools),
  :func:`int8_avg_pool_exclude_pad` divides by the in-image cells only
  (InceptionV3's SAME pools: 9, 6 or 4).

Each wrapper checks device, dtype, shape and contiguity and raises on what
its kernel does not take. On a CUDA tensor it launches the kernel on the
current stream, raises if the launch reports an error, and adds one to its
``launches`` count; on a CPU tensor it runs the kernel's plain version
(``*_plain``), which is also what the kernels are compared with. There is
no fallback from CUDA to the plain version.

Every function keeps the JAX package's NHWC layout and its exact rounding:
the plain versions are bit-identical to ``_conv_i8_e2e``, ``_conv_int8``,
``_max_pool_i8`` and ``_avg_pool_i8_include_pad`` of ``bn_inception_int8``
and to ``_ForwardOps._conv_layer``, ``max_pool`` and ``avg_pool_same`` of
``inception_v3_int8``.
"""

from __future__ import annotations

from typing import Tuple, Union

import torch
import torch.nn.functional as F

_OUT_DTYPES = (torch.int8, torch.bfloat16)

#: ((top, bottom), (left, right)) spatial padding of a pool
Pads = Tuple[Tuple[int, int], Tuple[int, int]]
#: a conv's symmetric padding: one int for both axes, or (pad_h, pad_w)
ConvPad = Union[int, Tuple[int, int]]


def conv_pads(pad: ConvPad) -> Tuple[int, int]:
    """``(pad_h, pad_w)`` of a conv's ``pad`` argument."""
    if isinstance(pad, int):
        return pad, pad
    pad_h, pad_w = pad
    return int(pad_h), int(pad_w)


# --- plain versions (CPU path and the kernels' reference) ------------------


def int8_conv_plain(x: torch.Tensor, w: torch.Tensor, scale: torch.Tensor,
                    bias: torch.Tensor, stride: int = 1, pad: ConvPad = 0,
                    out_dtype: torch.dtype = torch.int8) -> torch.Tensor:
    """K1's plain version: a float64 conv on int-valued tensors (exact: every
    partial sum is an integer far below 2**53), then the same f32 epilogue
    ops as the JAX package — y*scale and +bias round separately."""
    y = F.conv2d(x.permute(0, 3, 1, 2).to(torch.float64),
                 w.permute(0, 3, 1, 2).to(torch.float64),
                 stride=stride, padding=conv_pads(pad))
    y = y.permute(0, 2, 3, 1).to(torch.int32).to(torch.float32)
    out = torch.clamp_min(y * scale + bias, 0.0)
    if out_dtype == torch.int8:
        out = torch.clamp(torch.round(out), 0.0, 127.0).to(torch.int8)
    else:
        out = out.to(torch.bfloat16)
    return out.contiguous()


def int8_max_pool_plain(x: torch.Tensor, kernel: int, stride: int,
                        pads: Pads) -> torch.Tensor:
    """K2's plain version: -128-padded max pool, exact through float32."""
    (t, b), (l, r) = pads
    xf = F.pad(x.permute(0, 3, 1, 2).to(torch.float32), (l, r, t, b),
               value=-128.0)
    y = F.max_pool2d(xf, kernel, stride)
    return y.to(torch.int8).permute(0, 2, 3, 1).contiguous()


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


def int8_conv(x: torch.Tensor, w: torch.Tensor, scale: torch.Tensor,
              bias: torch.Tensor, stride: int = 1, pad: ConvPad = 0,
              out_dtype: torch.dtype = torch.int8) -> torch.Tensor:
    """(N, H, W, C) int8 ⊛ (O, KH, KW, C) int8 -> (N, Ho, Wo, O), zero
    padding ``pad`` (both axes) or ``(pad_h, pad_w)`` on each side.

    ``out_dtype=torch.int8``: ``clip(round(max(y*scale + bias, 0)), 0, 127)``
    (``scale``/``bias`` are the e2e ``m``/``bq``); ``torch.bfloat16``:
    ``bf16(max(y*scale + bias, 0))`` (``scale = sx*sw``, the calibration
    conv). ``x`` may be a channel slice of a wider NHWC tensor; ``C`` must be
    a multiple of 4.
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
    if not on_cuda:
        return int8_conv_plain(x, w, scale, bias, stride, pad, out_dtype)

    ps = x.stride(2)
    _require(x.stride(3) == 1 and ps >= C and ps % 4 == 0
             and (H == 1 or x.stride(1) == W * ps)
             and (N == 1 or x.stride(0) == H * W * ps)
             and x.data_ptr() % 4 == 0,
             f"x must be an NHWC tensor or a 4-aligned channel slice of one "
             f"(strides {x.stride()})")
    _require(w.is_contiguous() and scale.is_contiguous()
             and bias.is_contiguous(), "w, scale and bias must be contiguous")
    out = torch.empty((N, Ho, Wo, O), dtype=out_dtype, device=x.device)
    if out.numel() == 0:
        return out
    from .build import load_library

    lib = load_library()
    with torch.cuda.device(x.device):
        rc = lib.adt_int8_conv(
            x.data_ptr(), w.data_ptr(), scale.data_ptr(), bias.data_ptr(),
            out.data_ptr(), N, H, W, C, ps, O, KH, KW, stride, pad_h, pad_w,
            Ho, Wo, int(out_dtype == torch.bfloat16), _stream_ptr())
    _check_launch(rc, "int8_conv")
    int8_conv.launches += 1
    return out


def _pool(wrapper, entry: str, x: torch.Tensor, kernel: int, stride: int,
          pads: Pads, *mode: int) -> torch.Tensor:
    """Launch a pool kernel (``mode``: the entry point's extra int
    arguments); counts the launch on ``wrapper``."""
    name = wrapper.__name__
    N, H, W, C = x.shape
    (t, b), (l, r) = pads
    Ho = (H + t + b - kernel) // stride + 1
    Wo = (W + l + r - kernel) // stride + 1
    _require(Ho > 0 and Wo > 0 and t == l, f"{name}: unsupported geometry")
    _require(x.is_contiguous(), f"{name}: x must be contiguous NHWC")
    out = torch.empty((N, Ho, Wo, C), dtype=torch.int8, device=x.device)
    if out.numel() == 0:
        return out
    from .build import load_library

    fn = getattr(load_library(), entry)
    with torch.cuda.device(x.device):
        rc = fn(x.data_ptr(), out.data_ptr(), N, H, W, C, Ho, Wo, kernel,
                stride, t, *mode, _stream_ptr())
    _check_launch(rc, name)
    wrapper.launches += 1
    return out


def int8_max_pool(x: torch.Tensor, kernel: int, stride: int,
                  pads: Pads) -> torch.Tensor:
    """int8 NHWC max pool over ``pads = ((top, bottom), (left, right))``
    (the kernel takes ``top == left``); padding never wins (-128, the reduce
    init)."""
    on_cuda = _cuda_or_cpu(x)
    _require(x.dim() == 4 and x.dtype == torch.int8, "x must be int8 NHWC")
    if not on_cuda:
        return int8_max_pool_plain(x, kernel, stride, pads)
    return _pool(int8_max_pool, "adt_int8_max_pool", x, kernel, stride, pads)


def _avg_pool(wrapper, x: torch.Tensor, kernel: int, stride: int, pad: int,
              count_include_pad: bool) -> torch.Tensor:
    on_cuda = _cuda_or_cpu(x)
    _require(x.dim() == 4 and x.dtype == torch.int8, "x must be int8 NHWC")
    _require(0 <= 2 * pad <= kernel, f"{wrapper.__name__}: pad {pad} "
             f"exceeds half the window {kernel}")
    if not on_cuda:
        return int8_avg_pool_plain(x, kernel, stride, pad, count_include_pad)
    return _pool(wrapper, "adt_int8_avg_pool", x, kernel, stride,
                 ((pad, pad), (pad, pad)), int(not count_include_pad))


def int8_avg_pool(x: torch.Tensor, kernel: int, stride: int,
                  pad: int) -> torch.Tensor:
    """int8 NHWC count-include-pad average pool (divisor ``kernel**2``),
    rounded half to even back to the input's scale."""
    return _avg_pool(int8_avg_pool, x, kernel, stride, pad, True)


def int8_avg_pool_exclude_pad(x: torch.Tensor, kernel: int, stride: int,
                              pad: int) -> torch.Tensor:
    """int8 NHWC average pool that divides each window's sum by its
    in-image cell count (``count_include_pad=False``), rounded half to
    even: K3's second mode."""
    return _avg_pool(int8_avg_pool_exclude_pad, x, kernel, stride, pad,
                     False)


for _k in (int8_conv, int8_max_pool, int8_avg_pool,
           int8_avg_pool_exclude_pad):
    _k.launches = 0
