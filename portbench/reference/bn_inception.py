"""Plain float32 BN-Inception (Ioffe and Szegedy, arXiv:1502.03167), in the
Caffe port's layout that the TSN/SSN checkpoints use: every conv has a bias
and is followed by a BatchNorm (eps 1e-5) in inference mode and a ReLU;
max pools round their output size up (Caffe's ceil mode); the branch
average pools count the padding.

Parameters are a flat dict under the Caffe blob names (``conv1_7x7_s2.weight``,
``inception_3a_1x1_bn.running_mean``, ...). ``q`` is a quantizer
(``reference/quant.py``) that each conv's input and weight pass through:
the identity for the reference itself, int4 for the control.

The forward is split where shared-stem scoring splits it: :func:`stem`
(frame -> stride-8 grid), :func:`trunk` (crop window -> 1024 features).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .quant import IDENTITY

FEATURE_DIM = 1024
BN_EPS = 1e-5

# name, 1x1, 3x3 reduce, 3x3, double reduce, double 1, double 2, pool proj,
# pool kind, stride (stride-2 modules have no 1x1 and an unprojected pool)
MODULES = (
    ("inception_3a", 64, 64, 64, 64, 96, 96, 32, "avg", 1),
    ("inception_3b", 64, 64, 96, 64, 96, 96, 64, "avg", 1),
    ("inception_3c", None, 128, 160, 64, 96, 96, None, "max", 2),
    ("inception_4a", 224, 64, 96, 96, 128, 128, 128, "avg", 1),
    ("inception_4b", 192, 96, 128, 96, 128, 128, 128, "avg", 1),
    ("inception_4c", 160, 128, 160, 128, 160, 160, 128, "avg", 1),
    ("inception_4d", 96, 128, 192, 160, 192, 192, 128, "avg", 1),
    ("inception_4e", None, 128, 192, 192, 256, 256, None, "max", 2),
    ("inception_5a", 352, 192, 320, 160, 224, 224, 128, "avg", 1),
    ("inception_5b", 352, 192, 320, 192, 224, 224, 128, "max", 1),
)


def stem_hw(size: int) -> int:
    """Stem output size of one input dimension: 7x7 s2 p3, ceil 3x3 s2
    pool, ceil 3x3 s2 pool."""
    n = (size + 6 - 7) // 2 + 1
    n = -(-(n - 3) // 2) + 1
    return -(-(n - 3) // 2) + 1


def _cbr(p, name, x, stride=1, pad=0, q=IDENTITY):
    w = q.weight(name, p[name + ".weight"])
    y = F.conv2d(q.act(name, x), w, p[name + ".bias"], stride, pad)
    bn = name + "_bn"
    if bn + ".running_mean" not in p:       # fit: the batch's statistics
        p[bn + ".running_mean"] = y.mean(dim=(0, 2, 3))
        p[bn + ".running_var"] = y.var(dim=(0, 2, 3), unbiased=False)
    y = F.batch_norm(y, p[bn + ".running_mean"], p[bn + ".running_var"],
                     p[bn + ".weight"], p[bn + ".bias"], False, 0.0, BN_EPS)
    return F.relu(y)


def stem(p, x: torch.Tensor, q=IDENTITY) -> torch.Tensor:
    """NCHW normalized frames -> the trunk's input (NCHW, 192 channels)."""
    x = _cbr(p, "conv1_7x7_s2", x, 2, 3, q)
    x = F.max_pool2d(x, 3, 2, ceil_mode=True)
    x = _cbr(p, "conv2_3x3_reduce", x, q=q)
    x = _cbr(p, "conv2_3x3", x, 1, 1, q)
    return F.max_pool2d(x, 3, 2, ceil_mode=True)


def trunk(p, x: torch.Tensor, q=IDENTITY) -> torch.Tensor:
    """NCHW trunk input -> (N, 1024) globally average-pooled features."""
    for name, c1, _c3r, _c3, _d3r, _d31, _d32, _proj, pool, stride in MODULES:
        out = []
        if c1 is not None:
            out.append(_cbr(p, f"{name}_1x1", x, q=q))
        b = _cbr(p, f"{name}_3x3_reduce", x, q=q)
        out.append(_cbr(p, f"{name}_3x3", b, stride, 1, q))
        b = _cbr(p, f"{name}_double_3x3_reduce", x, q=q)
        b = _cbr(p, f"{name}_double_3x3_1", b, 1, 1, q)
        out.append(_cbr(p, f"{name}_double_3x3_2", b, stride, 1, q))
        if stride == 1:
            b = (F.avg_pool2d(x, 3, 1, 1, count_include_pad=True)
                 if pool == "avg" else F.max_pool2d(x, 3, 1, 1))
            out.append(_cbr(p, f"{name}_pool_proj", b, q=q))
        else:
            out.append(F.max_pool2d(x, 3, 2, ceil_mode=True))
        x = torch.cat(out, dim=1)
    return x.mean(dim=(2, 3))
