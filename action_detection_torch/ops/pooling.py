"""NHWC max pooling with the JAX package's three backward modes.

Port of ``action_detection_tpu/ops/pooling.py``. The forward is the plain
max pool (torch's own) in every mode; the backward is chosen process-wide
by :func:`set_pool_backward`, with the JAX package's names:

* ``"pallas"`` (the port's default) and ``"sas"`` (the JAX package's
  default): first-match routing, each window's gradient to the window's
  FIRST maximal position, row-major, summed in float32 — XLA
  SelectAndScatter's semantics. In the JAX package the two modes are two
  implementations of this one function (its Pallas kernel and XLA's
  SelectAndScatter); in the port both run the hand-written kernel A1
  (:func:`~action_detection_torch.kernels.pool_bwd.max_pool_bwd`, the port
  of ``max_pool_bwd_pallas``), whose plain version (torch's own max-pool
  backward) runs on CPU tensors;
* ``"eq_mask"``: the residue-class eq-mask backward (:class:`_EqMaskMaxPool`,
  torch ops), which routes a window's gradient to EVERY position equal to
  its max, so it differs from first-match wherever a window ties (every
  all-zero post-ReLU window). As in the JAX package it applies to float
  pools whose strides are both above 1; stride-1 pools keep first-match
  (A1, as JAX keeps plain AD there).

Integer tensors pool forward only (``iinfo.min`` padding), as in the JAX
package; no gradient flows through them. int8 pools on the card run on the
hand-written kernel K2 (:func:`~action_detection_torch.kernels.int8.
int8_max_pool`), which refuses the geometries it cannot take. Every float
max pool of the port's float backbones goes through :func:`max_pool_2d`,
so a training step's pool backward runs on the selected mode.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F

from ..kernels.int8 import int8_max_pool
from ..kernels.pool_bwd import max_pool_bwd, pool_out_hw

Pad2 = Tuple[Tuple[int, int], Tuple[int, int]]

_POOL_BWD_MODES = ("sas", "eq_mask", "pallas")
_POOL_BWD_MODE = "pallas"


def set_pool_backward(mode: str) -> str:
    """Select the max-pool backward for pools run after the call (returns
    the previous mode)."""
    global _POOL_BWD_MODE
    if mode not in _POOL_BWD_MODES:
        raise ValueError(f"unknown pool backward mode {mode!r}; choose from "
                         f"{_POOL_BWD_MODES}")
    prev = _POOL_BWD_MODE
    _POOL_BWD_MODE = mode
    return prev


def pool_backward() -> str:
    return _POOL_BWD_MODE


def set_eq_mask(enabled: bool) -> bool:
    """``True`` selects the eq-mask backward, ``False`` first-match as
    ``"sas"`` (overriding ``"pallas"`` too, as in the JAX package).
    Returns whether eq-mask WAS selected."""
    return set_pool_backward("eq_mask" if enabled else "sas") == "eq_mask"


def eq_mask_enabled() -> bool:
    return _POOL_BWD_MODE == "eq_mask"


def _reduce_max(x: torch.Tensor, kernel, stride, padding: Pad2
                ) -> torch.Tensor:
    """Forward max pool of NHWC float ``x`` over -inf padding (NHWC out),
    differentiable by torch's own backward."""
    (t, b), (l, r) = padding
    xc = x.permute(0, 3, 1, 2)
    expect = pool_out_hw(x.shape[1], x.shape[2], kernel, stride, padding)
    if (t, l) == (b, r) and 2 * max(t, l) <= min(kernel):
        y = F.max_pool2d(xc, kernel, stride, (t, l))
    elif (t, l) == (0, 0):
        # right/bottom-only padding is Caffe's ceil mode when the last
        # window still starts inside the input (checked below)
        y = F.max_pool2d(xc, kernel, stride, ceil_mode=True)
    else:
        y = None
    if y is None or tuple(y.shape[2:]) != expect:
        y = F.max_pool2d(F.pad(xc, (l, r, t, b), value=float("-inf")),
                         kernel, stride)
    return y.permute(0, 2, 3, 1)


def _reduce_max_int(x: torch.Tensor, kernel, stride, padding: Pad2
                    ) -> torch.Tensor:
    """Forward max pool of NHWC integer ``x`` over ``iinfo.min`` padding:
    the elementwise max of the window's strided slices (exact for every
    integer dtype; int8 on the card runs on K2 instead)."""
    (kh, kw), (sh, sw) = kernel, stride
    (t, b), (l, r) = padding
    Ho, Wo = pool_out_hw(x.shape[1], x.shape[2], kernel, stride, padding)
    xp = F.pad(x, (0, 0, l, r, t, b), value=torch.iinfo(x.dtype).min)
    y = None
    for ky in range(kh):
        for kx in range(kw):
            s = xp[:, ky:ky + sh * (Ho - 1) + 1:sh,
                   kx:kx + sw * (Wo - 1) + 1:sw]
            y = s if y is None else torch.maximum(y, s)
    return y.contiguous()


class _MaxPool2d(torch.autograd.Function):
    """Max pool whose backward is A1."""

    @staticmethod
    def forward(ctx, x, kernel, stride, padding):
        y = _reduce_max(x, kernel, stride, padding)
        ctx.save_for_backward(x, y)
        ctx.geometry = (kernel, stride, padding)
        return y

    @staticmethod
    def backward(ctx, dy):
        x, y = ctx.saved_tensors
        kernel, stride, padding = ctx.geometry
        dx = max_pool_bwd(x.contiguous(), y.contiguous(), dy.contiguous(),
                          kernel, stride, padding)
        return dx, None, None, None


class _EqMaskMaxPool(_MaxPool2d):
    """Max pool whose backward is the eq-mask VJP of the JAX package's
    ``max_pool`` (``_bwd``), op for op.

    ``dx[p] = sum over windows i covering p of [x[p] == y[i]] * dy[i]``.
    Input positions are grouped by their stride residue ``r = p mod s``:
    each residue class is covered by the same ``T_r = ceil((k - r) / s)``
    window shifts, so its gradient is ``T_r`` shifted compare-select-adds
    at output resolution, summed in ``dy``'s dtype in the JAX order; the
    residue grids are then interleaved back and cropped. Padding and
    alignment cells are NaN and never match."""

    @staticmethod
    def backward(ctx, dy):
        x, y = ctx.saved_tensors
        (kh, kw), (sh, sw), ((plh, phh), (plw, phw)) = ctx.geometry
        N, H, W, C = x.shape
        Ho, Wo = y.shape[1], y.shape[2]
        Hh = -(-(H + plh + phh) // sh)          # residue-grid lengths
        Ww = -(-(W + plw + phw) // sw)
        nan = float("nan")
        xp = F.pad(x, (0, 0, plw, Ww * sw - W - plw, plh, Hh * sh - H - plh),
                   value=nan)
        xr = xp.reshape(N, Hh, sh, Ww, sw, C)
        zero = torch.zeros((), dtype=dy.dtype, device=dy.device)
        outs = []
        for rh in range(sh):
            th_n = max(-(-(kh - rh) // sh), 0)    # shifts hitting residue rh
            for rw in range(sw):
                tw_n = max(-(-(kw - rw) // sw), 0)
                if th_n == 0 or tw_n == 0:        # stride > kernel gap cells
                    outs.append(torch.zeros((N, Hh, Ww, C), dtype=dy.dtype,
                                            device=dy.device))
                    continue
                xs = xr[:, :, rh, :, rw, :]
                # the window of residue cell m at shift t is m - t: low
                # guard cells cover m - t < 0, high ones m - t >= Ho
                pads = (0, 0, tw_n - 1, Ww - Wo, th_n - 1, Hh - Ho)
                yp = F.pad(y, pads, value=nan)
                dp = F.pad(dy, pads, value=0.0)
                acc = torch.zeros((N, Hh, Ww, C), dtype=dy.dtype,
                                  device=dy.device)
                for th in range(th_n):
                    for tw in range(tw_n):
                        h0, w0 = th_n - 1 - th, tw_n - 1 - tw
                        ys = yp[:, h0:h0 + Hh, w0:w0 + Ww]
                        ds = dp[:, h0:h0 + Hh, w0:w0 + Ww]
                        acc = acc + torch.where(xs == ys, ds, zero)
                outs.append(acc)
        dxp = (torch.stack(outs, 0).reshape(sh, sw, N, Hh, Ww, C)
               .permute(2, 3, 0, 4, 1, 5).reshape(N, Hh * sh, Ww * sw, C))
        return (dxp[:, plh:plh + H, plw:plw + W].contiguous(), None, None,
                None)


def max_pool_2d(x: torch.Tensor, kernel: int | Tuple[int, int],
                stride: int | Tuple[int, int],
                padding: Sequence[Tuple[int, int]]) -> torch.Tensor:
    """NHWC max pool; ``padding`` is ((top, bottom), (left, right)) and
    never wins. Float pools are differentiable through the selected
    backward mode (module docstring); integer pools are forward only."""
    if x.dim() != 4:
        raise ValueError(
            f"max_pool_2d expects NHWC rank-4 input, got shape "
            f"{tuple(x.shape)}")
    k = (kernel, kernel) if isinstance(kernel, int) else tuple(kernel)
    s = (stride, stride) if isinstance(stride, int) else tuple(stride)
    p = (tuple(padding[0]), tuple(padding[1]))
    if not x.is_floating_point():          # AD never flows through ints
        if x.dtype == torch.int8 and x.is_cuda:
            if k[0] != k[1] or s[0] != s[1]:
                raise ValueError(
                    f"int8 max pools on CUDA run on K2, which takes square "
                    f"pools, got kernel {k} stride {s}")
            return int8_max_pool(x, k[0], s[0], p)
        return _reduce_max_int(x, k, s, p)
    if _POOL_BWD_MODE == "eq_mask" and min(s) > 1:
        return _EqMaskMaxPool.apply(x, k, s, p)
    return _MaxPool2d.apply(x, k, s, p)       # first-match: A1
