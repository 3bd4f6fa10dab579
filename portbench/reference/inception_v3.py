"""Plain float32 Inception-v3 (Szegedy et al., arXiv:1512.00567), in the
tf-model-zoo layout that the TSN/SSN checkpoints use: bias-free convs, each
followed by a BatchNorm (eps 1e-3) in inference mode and a ReLU; VALID
3x3 s2 max pools; SAME 3x3 s1 average pools that do not count the padding.

Parameters are a flat dict under the checkpoint's names
(``Conv2d_1a_3x3.conv.weight``, ``Mixed_5b.branch1x1.bn.running_var``, ...);
``q`` is the quantizer of ``reference/quant.py``. Split as in shared-stem
scoring: :func:`stem` (frame -> stride-8 grid), :func:`trunk` (crop window
-> 2048 features).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .quant import IDENTITY

FEATURE_DIM = 2048
BN_EPS = 1e-3


def stem_hw(size: int) -> int:
    """Stem output size of one input dimension (299 -> 35)."""
    n = (size - 3) // 2 + 1 - 2
    n = (n - 3) // 2 + 1 - 2
    return (n - 3) // 2 + 1


def _cbr(p, name, x, stride=1, pad=(0, 0), q=IDENTITY):
    w = q.weight(name, p[name + ".conv.weight"])
    y = F.conv2d(q.act(name, x), w, None, stride, pad)
    bn = name + ".bn"
    if bn + ".running_mean" not in p:       # fit: the batch's statistics
        p[bn + ".running_mean"] = y.mean(dim=(0, 2, 3))
        p[bn + ".running_var"] = y.var(dim=(0, 2, 3), unbiased=False)
    y = F.batch_norm(y, p[bn + ".running_mean"], p[bn + ".running_var"],
                     p[bn + ".weight"], p[bn + ".bias"], False, 0.0, BN_EPS)
    return F.relu(y)


def _avg(x):
    return F.avg_pool2d(x, 3, 1, 1, count_include_pad=False)


def stem(p, x: torch.Tensor, q=IDENTITY) -> torch.Tensor:
    """NCHW normalized frames -> the trunk's input (NCHW, 192 channels)."""
    x = _cbr(p, "Conv2d_1a_3x3", x, 2, q=q)
    x = _cbr(p, "Conv2d_2a_3x3", x, q=q)
    x = _cbr(p, "Conv2d_2b_3x3", x, pad=(1, 1), q=q)
    x = F.max_pool2d(x, 3, 2)
    x = _cbr(p, "Conv2d_3b_1x1", x, q=q)
    x = _cbr(p, "Conv2d_4a_3x3", x, q=q)
    return F.max_pool2d(x, 3, 2)


def _mixed_a(p, m, x, q):
    b0 = _cbr(p, f"{m}.branch1x1", x, q=q)
    b1 = _cbr(p, f"{m}.branch5x5_2", _cbr(p, f"{m}.branch5x5_1", x, q=q),
              pad=(2, 2), q=q)
    b2 = _cbr(p, f"{m}.branch3x3dbl_1", x, q=q)
    b2 = _cbr(p, f"{m}.branch3x3dbl_2", b2, pad=(1, 1), q=q)
    b2 = _cbr(p, f"{m}.branch3x3dbl_3", b2, pad=(1, 1), q=q)
    b3 = _cbr(p, f"{m}.branch_pool", _avg(x), q=q)
    return torch.cat([b0, b1, b2, b3], dim=1)


def _mixed_b(p, m, x, q):
    b0 = _cbr(p, f"{m}.branch3x3", x, 2, q=q)
    b1 = _cbr(p, f"{m}.branch3x3dbl_1", x, q=q)
    b1 = _cbr(p, f"{m}.branch3x3dbl_2", b1, pad=(1, 1), q=q)
    b1 = _cbr(p, f"{m}.branch3x3dbl_3", b1, 2, q=q)
    return torch.cat([b0, b1, F.max_pool2d(x, 3, 2)], dim=1)


def _mixed_c(p, m, x, q):
    b0 = _cbr(p, f"{m}.branch1x1", x, q=q)
    b1 = _cbr(p, f"{m}.branch7x7_1", x, q=q)
    b1 = _cbr(p, f"{m}.branch7x7_2", b1, pad=(0, 3), q=q)
    b1 = _cbr(p, f"{m}.branch7x7_3", b1, pad=(3, 0), q=q)
    b2 = _cbr(p, f"{m}.branch7x7dbl_1", x, q=q)
    for i, pad in ((2, (3, 0)), (3, (0, 3)), (4, (3, 0)), (5, (0, 3))):
        b2 = _cbr(p, f"{m}.branch7x7dbl_{i}", b2, pad=pad, q=q)
    b3 = _cbr(p, f"{m}.branch_pool", _avg(x), q=q)
    return torch.cat([b0, b1, b2, b3], dim=1)


def _mixed_d(p, m, x, q):
    b0 = _cbr(p, f"{m}.branch3x3_1", x, q=q)
    b0 = _cbr(p, f"{m}.branch3x3_2", b0, 2, q=q)
    b1 = _cbr(p, f"{m}.branch7x7x3_1", x, q=q)
    b1 = _cbr(p, f"{m}.branch7x7x3_2", b1, pad=(0, 3), q=q)
    b1 = _cbr(p, f"{m}.branch7x7x3_3", b1, pad=(3, 0), q=q)
    b1 = _cbr(p, f"{m}.branch7x7x3_4", b1, 2, q=q)
    return torch.cat([b0, b1, F.max_pool2d(x, 3, 2)], dim=1)


def _mixed_e(p, m, x, q):
    b0 = _cbr(p, f"{m}.branch1x1", x, q=q)
    b1 = _cbr(p, f"{m}.branch3x3_1", x, q=q)
    b1 = torch.cat([_cbr(p, f"{m}.branch3x3_2a", b1, pad=(0, 1), q=q),
                    _cbr(p, f"{m}.branch3x3_2b", b1, pad=(1, 0), q=q)], 1)
    b2 = _cbr(p, f"{m}.branch3x3dbl_1", x, q=q)
    b2 = _cbr(p, f"{m}.branch3x3dbl_2", b2, pad=(1, 1), q=q)
    b2 = torch.cat([_cbr(p, f"{m}.branch3x3dbl_3a", b2, pad=(0, 1), q=q),
                    _cbr(p, f"{m}.branch3x3dbl_3b", b2, pad=(1, 0), q=q)], 1)
    b3 = _cbr(p, f"{m}.branch_pool", _avg(x), q=q)
    return torch.cat([b0, b1, b2, b3], dim=1)


MODULES = (("Mixed_5b", _mixed_a), ("Mixed_5c", _mixed_a),
           ("Mixed_5d", _mixed_a), ("Mixed_6a", _mixed_b),
           ("Mixed_6b", _mixed_c), ("Mixed_6c", _mixed_c),
           ("Mixed_6d", _mixed_c), ("Mixed_6e", _mixed_c),
           ("Mixed_7a", _mixed_d), ("Mixed_7b", _mixed_e),
           ("Mixed_7c", _mixed_e))


def trunk(p, x: torch.Tensor, q=IDENTITY) -> torch.Tensor:
    """NCHW trunk input -> (N, 2048) globally average-pooled features."""
    for name, module in MODULES:
        x = module(p, name, x, q)
    return x.mean(dim=(2, 3))
