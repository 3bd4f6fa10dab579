"""The max-pool backward kernel of the training path: wrapper, plain version.

A1 :func:`max_pool_bwd` (``csrc/pool_bwd.cu``) is the port of the JAX
package's Pallas kernel ``max_pool_bwd_pallas``: dx of an NHWC max pool,
each window's dy routed to the window's FIRST position (row-major) that
holds the window max, contributions summed in float32 and rounded once to
the storage dtype (float32 or bfloat16).

On a CUDA tensor the wrapper launches the kernel on the current stream,
raises if the launch reports an error, and adds one to
``max_pool_bwd.launches``; on a CPU tensor it runs the plain version
(:func:`max_pool_bwd_plain`), which is also what the kernel is compared
with. There is no fallback from CUDA to the plain version.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .int8 import _check_launch, _cuda_or_cpu, _require, _stream_ptr

_FLOAT_DTYPES = (torch.float32, torch.bfloat16)


def pool_out_hw(H: int, W: int, kernel, stride, padding) -> tuple:
    """(Ho, Wo) of a pool over ``padding = ((top, bottom), (left, right))``."""
    (kh, kw), (sh, sw) = kernel, stride
    (t, b), (l, r) = padding
    return (H + t + b - kh) // sh + 1, (W + l + r - kw) // sw + 1


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

    (kh, kw), (sh, sw) = kernel, stride
    with torch.cuda.device(x.device):
        rc = load_library().adt_max_pool_bwd(
            x.data_ptr(), y.data_ptr(), dy.data_ptr(), dx.data_ptr(),
            N, H, W, C, Ho, Wo, kh, kw, sh, sw, padding[0][0], padding[1][0],
            int(x.dtype == torch.bfloat16), _stream_ptr())
    _check_launch(rc, "max_pool_bwd")
    max_pool_bwd.launches += 1
    return dx


max_pool_bwd.launches = 0
