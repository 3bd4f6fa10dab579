"""Pillow's bilinear resize of 8-bit images, in NumPy: the ``GroupScale``
step of TSN's test transform (the shorter side to the scale size).

Pillow resizes by a two-pass convolution with the triangle filter, whose
support widens by ``max(1, in/out)``; each window ``[int(c - s + 0.5),
int(c + s + 0.5))`` around ``c = (i + 0.5) * in/out`` is clamped to the
image, its weights normalized to sum 1 and rounded to 22 fractional bits;
the horizontal pass runs first into an 8-bit image, then the vertical one.
"""

from __future__ import annotations

import numpy as np

_BITS = 22


def _coeffs(in_size: int, out_size: int):
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = filterscale
    ss = 1.0 / filterscale      # Pillow multiplies by the inverse
    ksize = int(np.ceil(support)) * 2 + 1
    xmins = np.zeros(out_size, np.int64)
    kk = np.zeros((out_size, ksize), np.float64)
    for i in range(out_size):
        center = (i + 0.5) * scale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), in_size) - xmin
        w = [max(1.0 - abs((x + xmin - center + 0.5) * ss), 0.0)
             for x in range(xmax)]
        total = 0.0
        for v in w:
            total += v
        kk[i, :xmax] = [v / total for v in w] if total != 0.0 else w
        xmins[i] = xmin
    fixed = np.trunc(kk * (1 << _BITS) + np.where(kk < 0, -0.5, 0.5))
    return xmins, fixed.astype(np.int64)


def _pass(img: np.ndarray, out_size: int, axis: int) -> np.ndarray:
    in_size = img.shape[axis]
    xmins, k = _coeffs(in_size, out_size)
    shape = [1] * img.ndim
    shape[axis] = out_size
    acc = np.full(img.shape[:axis] + (out_size,) + img.shape[axis + 1:],
                  1 << (_BITS - 1), np.int64)
    for j in range(k.shape[1]):
        idx = np.minimum(xmins + j, in_size - 1)
        acc += np.take(img, idx, axis=axis).astype(np.int64) \
            * k[:, j].reshape(shape)
    return np.clip(acc >> _BITS, 0, 255).astype(np.uint8)


def scale_shorter_side(img: np.ndarray, size: int) -> np.ndarray:
    """``(H, W, C)`` uint8 with its shorter side scaled to ``size`` (the
    longer one to ``int(size * long / short)``); unchanged where it is
    ``size`` already."""
    h, w = img.shape[:2]
    if min(h, w) == size:
        return img
    if w < h:
        out_w, out_h = size, int(size * h / w)
    else:
        out_w, out_h = int(size * w / h), size
    if out_w != w:
        img = _pass(img, out_w, axis=1)
    if out_h != h:
        img = _pass(img, out_h, axis=0)
    return img
