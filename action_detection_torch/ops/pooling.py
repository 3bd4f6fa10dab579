"""NHWC max pooling whose backward is the hand-written kernel A1.

Port of ``action_detection_tpu/ops/pooling.py`` in its ``"pallas"`` mode:
the forward is the plain max pool (torch's own), and the backward routes
each window's gradient to the window's FIRST maximal position, row-major,
summing in float32 — XLA SelectAndScatter's semantics, which the JAX
package's Pallas kernel ``max_pool_bwd_pallas`` reproduces and which
:func:`~action_detection_torch.kernels.pool_bwd.max_pool_bwd` launches on
the card. Every float max pool of the port's float backbones goes through
:func:`max_pool_2d`, so a training step's pool backward runs on A1.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F

from ..kernels.pool_bwd import max_pool_bwd, pool_out_hw

Pad2 = Tuple[Tuple[int, int], Tuple[int, int]]


def _reduce_max(x: torch.Tensor, kernel, stride, padding: Pad2
                ) -> torch.Tensor:
    """Forward max pool of NHWC ``x`` over -inf padding (NHWC out)."""
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


class _MaxPool2d(torch.autograd.Function):
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


def max_pool_2d(x: torch.Tensor, kernel: int | Tuple[int, int],
                stride: int | Tuple[int, int],
                padding: Sequence[Tuple[int, int]]) -> torch.Tensor:
    """NHWC float max pool; ``padding`` is ((top, bottom), (left, right))
    and never wins. Differentiable, with A1 as the backward."""
    if x.dim() != 4:
        raise ValueError(
            f"max_pool_2d expects NHWC rank-4 input, got shape "
            f"{tuple(x.shape)}")
    if not x.is_floating_point():
        raise ValueError(f"max_pool_2d takes float tensors, got {x.dtype} "
                         "(int8 pools are kernels.int8.int8_max_pool)")
    k = (kernel, kernel) if isinstance(kernel, int) else tuple(kernel)
    s = (stride, stride) if isinstance(stride, int) else tuple(stride)
    p = (tuple(padding[0]), tuple(padding[1]))
    return _MaxPool2d.apply(x, k, s, p)
