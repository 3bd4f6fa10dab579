"""BN-Inception (GoogLeNet with Batch Normalization) in torch.

Port of ``action_detection_tpu/models/backbones/bn_inception.py``. Layer
names are the Caffe port's blob names (``conv1_7x7_s2``,
``inception_3a_1x1``, ...) as flat attributes, so a reference checkpoint's
``base_model.*`` keys load 1:1. The public forward takes NHWC frames like the
JAX package; inside, convs run NCHW-logical on channels_last memory.

Caffe-style ceil-mode max pooling is explicit right/bottom padding with
-inf (:func:`_ceil_pool_padding`), exactly as the JAX package pads. Every max
pool goes through :func:`~action_detection_torch.ops.pooling.max_pool_2d`,
whose backward is the hand-written kernel A1.

Training: ``bn_mode`` (``common.set_bn_mode``; ``partial`` trains
``conv1_7x7_s2_bn`` alone) and ``remat``, which checkpoints each stem layer
and each inception module as one stage (``common.run_stage``).
"""

from __future__ import annotations

import functools
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ...ops.pooling import max_pool_2d
from .common import BatchNorm2d, run_stage, set_bn_mode

# (name, out_channels per branch, pool kind, stride)
# branches: 1x1 | 3x3_reduce->3x3 | double_3x3_reduce->double_3x3_1->double_3x3_2 | pool_proj
# stride-2 modules drop the 1x1 branch and use an unprojected max pool.
_INCEPTION_CFG: Sequence[Tuple[str, Optional[int], int, int, int, int, int,
                               Optional[int], str, int]] = (
    # name,      1x1, 3r,  3x3, d3r, d31, d32, proj, pool,  stride
    ("inception_3a", 64,  64,  64,  64,  96,  96, 32,  "avg", 1),
    ("inception_3b", 64,  64,  96,  64,  96,  96, 64,  "avg", 1),
    ("inception_3c", None, 128, 160, 64,  96,  96, None, "max", 2),
    ("inception_4a", 224, 64,  96,  96, 128, 128, 128, "avg", 1),
    ("inception_4b", 192, 96, 128,  96, 128, 128, 128, "avg", 1),
    ("inception_4c", 160, 128, 160, 128, 160, 160, 128, "avg", 1),
    ("inception_4d", 96, 128, 192, 160, 192, 192, 128, "avg", 1),
    ("inception_4e", None, 128, 192, 192, 256, 256, None, "max", 2),
    ("inception_5a", 352, 192, 320, 160, 224, 224, 128, "avg", 1),
    ("inception_5b", 352, 192, 320, 192, 224, 224, 128, "max", 1),
)

FEATURE_DIM = 1024


def _ceil_pool_padding(size: int, kernel: int, stride: int) -> Tuple[int, int]:
    """Right/bottom padding reproducing Caffe ceil-mode pooling statically."""
    out = -(-(size - kernel) // stride) + 1  # ceil division
    pad = max((out - 1) * stride + kernel - size, 0)
    return (0, pad)


def stem_feature_hw(size: int) -> int:
    """Spatial size of the stem output (the trunk input) for one input dim.

    conv1 7x7 s2 pad3 -> ceil 3x3 s2 max pool -> conv2 (size-preserving)
    -> ceil 3x3 s2 max pool; overall stride 8 (224 -> 28, 256 -> 32,
    340 -> 42)."""
    n = (size + 2 * 3 - 7) // 2 + 1
    n = -(-(n - 3) // 2) + 1
    n = -(-(n - 3) // 2) + 1
    return n


def pool_pads(H: int, W: int, kernel: int, stride: int, ceil: bool = False,
              pad: int = 0) -> Tuple[Tuple[int, int], Tuple[int, int]]:
    """((top, bottom), (left, right)) padding of a pool: Caffe ceil mode's
    right/bottom padding when ``ceil``, else ``pad`` on every side."""
    if ceil:
        return (_ceil_pool_padding(H, kernel, stride),
                _ceil_pool_padding(W, kernel, stride))
    return (pad, pad), (pad, pad)


def max_pool(x: torch.Tensor, kernel: int, stride: int, ceil: bool = False,
             pad: int = 0) -> torch.Tensor:
    """Max pool of an NCHW-logical float tensor over -inf padding
    (:func:`pool_pads`); differentiable, with A1 as its backward."""
    pads = pool_pads(x.shape[2], x.shape[3], kernel, stride, ceil, pad)
    return max_pool_2d(x.permute(0, 2, 3, 1), kernel, stride,
                       pads).permute(0, 3, 1, 2)


def avg_pool_include_pad(x: torch.Tensor, kernel: int, stride: int,
                         pad: int) -> torch.Tensor:
    """Average pooling with count_include_pad=True (Caffe behavior)."""
    return F.avg_pool2d(x, kernel, stride, pad, count_include_pad=True)


def conv_layer_specs(in_channels: int = 3):
    """Every conv of the network as ``(name, cin, cout, kernel, stride, pad)``
    in topology order — one table for the float module and the int8 faces."""
    specs = [("conv1_7x7_s2", in_channels, 64, 7, 2, 3),
             ("conv2_3x3_reduce", 64, 64, 1, 1, 0),
             ("conv2_3x3", 64, 192, 3, 1, 1)]
    cin = 192
    for (name, c1, c3r, c3, cd3r, cd31, cd32, cproj, _pool, stride) \
            in _INCEPTION_CFG:
        if c1 is not None:
            specs.append((f"{name}_1x1", cin, c1, 1, 1, 0))
        specs += [(f"{name}_3x3_reduce", cin, c3r, 1, 1, 0),
                  (f"{name}_3x3", c3r, c3, 3, stride, 1),
                  (f"{name}_double_3x3_reduce", cin, cd3r, 1, 1, 0),
                  (f"{name}_double_3x3_1", cd3r, cd31, 3, 1, 1),
                  (f"{name}_double_3x3_2", cd31, cd32, 3, stride, 1)]
        if stride == 1:
            specs.append((f"{name}_pool_proj", cin, cproj, 1, 1, 0))
            cin = c1 + c3 + cd32 + cproj
        else:
            cin = c3 + cd32 + cin
    return specs


class BNInception(nn.Module):
    """BN-Inception feature extractor: (N, 224, 224, C) NHWC -> (N, 1024)."""

    def __init__(self, in_channels: int = 3, bn_mode: str = "frozen",
                 remat: bool = False):
        super().__init__()
        for name, cin, cout, k, stride, pad in conv_layer_specs(in_channels):
            setattr(self, name, nn.Conv2d(cin, cout, k, stride, pad,
                                          bias=True))
            setattr(self, name + "_bn", BatchNorm2d(cout, eps=1e-5))
        set_bn_mode(self, bn_mode)
        self.remat = remat

    def _cb(self, name: str, x: torch.Tensor) -> torch.Tensor:
        return F.relu(getattr(self, name + "_bn")(getattr(self, name)(x)))

    def _stages(self):
        """The network as checkpoint stages: the stem layer by layer (its
        activations are the largest), then each inception module."""
        return ([lambda x: max_pool(self._cb("conv1_7x7_s2", x), 3, 2,
                                    ceil=True),
                 lambda x: self._cb("conv2_3x3_reduce", x),
                 lambda x: max_pool(self._cb("conv2_3x3", x), 3, 2,
                                    ceil=True)]
                + [functools.partial(self._inception, cfg)
                   for cfg in _INCEPTION_CFG])

    def _inception(self, cfg, x: torch.Tensor) -> torch.Tensor:
        name, c1, *_rest, pool, stride = cfg
        branches = []
        if c1 is not None:
            branches.append(self._cb(f"{name}_1x1", x))
        branches.append(self._cb(f"{name}_3x3",
                                 self._cb(f"{name}_3x3_reduce", x)))
        bd = self._cb(f"{name}_double_3x3_reduce", x)
        branches.append(self._cb(f"{name}_double_3x3_2",
                                 self._cb(f"{name}_double_3x3_1", bd)))
        if stride == 1:
            bp = (avg_pool_include_pad(x, 3, 1, 1) if pool == "avg"
                  else max_pool(x, 3, 1, pad=1))
            branches.append(self._cb(f"{name}_pool_proj", bp))
        else:
            branches.append(max_pool(x, 3, 2, ceil=True))
        return torch.cat(branches, dim=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.permute(0, 3, 1, 2)
        for stage in self._stages():
            x = run_stage(stage, x, self.remat)
        return x.mean(dim=(2, 3)).float()
