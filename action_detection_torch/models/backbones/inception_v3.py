"""Inception V3 in torch (299x299 -> 2048 features).

Port of ``action_detection_tpu/models/backbones/inception_v3.py``: the
standard Inception V3 topology with bias-free convs and BN eps 1e-3. Module
names are the tf-model-zoo checkpoint's (``Conv2d_1a_3x3.conv``,
``Mixed_5b.branch1x1.bn``, ...), so a reference ``base_model.*`` state dict
maps onto it key for key. The public forward takes NHWC frames like the JAX
package; inside, convs run NCHW-logical on channels_last memory.

Max pools are VALID 3x3 s2 through
:func:`~action_detection_torch.ops.pooling.max_pool_2d` (A1 is their
backward); the branch avg pools are 3x3 s1 SAME with
``count_include_pad=False`` (edges divide by 6, corners by 4).

Training: ``bn_mode`` (``partial`` trains ``Conv2d_1a_3x3.bn`` alone) and
``remat``, which checkpoints each stem layer and each Mixed module as one
stage.
"""

from __future__ import annotations

from typing import Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from ...ops.pooling import max_pool_2d
from .common import BatchNorm2d, run_stage, set_bn_mode

FEATURE_DIM = 2048

_Pair = Union[int, Tuple[int, int]]


class BasicConv2d(nn.Module):
    """Bias-free conv + BN (eps 1e-3) + ReLU."""

    def __init__(self, cin: int, cout: int, kernel: _Pair, stride: int = 1,
                 pad: _Pair = 0):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, kernel, stride, pad, bias=False)
        self.bn = BatchNorm2d(cout, eps=1e-3)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(self.bn(self.conv(x)))


def _max_pool(x: torch.Tensor) -> torch.Tensor:
    """VALID 3x3 s2 max pool of an NCHW-logical tensor."""
    return max_pool_2d(x.permute(0, 2, 3, 1), 3, 2,
                       ((0, 0), (0, 0))).permute(0, 3, 1, 2)


def _avg_pool_same(x: torch.Tensor) -> torch.Tensor:
    return F.avg_pool2d(x, 3, 1, 1, count_include_pad=False)


class MixedA(nn.Module):
    """35x35 module: 1x1 | 5x5 | double 3x3 | avg-pool proj."""

    def __init__(self, cin: int, pool_features: int):
        super().__init__()
        self.branch1x1 = BasicConv2d(cin, 64, 1)
        self.branch5x5_1 = BasicConv2d(cin, 48, 1)
        self.branch5x5_2 = BasicConv2d(48, 64, 5, pad=2)
        self.branch3x3dbl_1 = BasicConv2d(cin, 64, 1)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, 3, pad=1)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, 3, pad=1)
        self.branch_pool = BasicConv2d(cin, pool_features, 1)

    def forward(self, x):
        b1 = self.branch5x5_2(self.branch5x5_1(x))
        b2 = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([self.branch1x1(x), b1, b2,
                          self.branch_pool(_avg_pool_same(x))], dim=1)


class MixedB(nn.Module):
    """17x17 downsample: 3x3/2 | double 3x3/2 | max-pool."""

    def __init__(self, cin: int):
        super().__init__()
        self.branch3x3 = BasicConv2d(cin, 384, 3, stride=2)
        self.branch3x3dbl_1 = BasicConv2d(cin, 64, 1)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, 3, pad=1)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, 3, stride=2)

    def forward(self, x):
        b1 = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([self.branch3x3(x), b1, _max_pool(x)], dim=1)


class MixedC(nn.Module):
    """17x17 module with factorized 7x7 convolutions."""

    def __init__(self, cin: int, c7: int):
        super().__init__()
        self.branch1x1 = BasicConv2d(cin, 192, 1)
        self.branch7x7_1 = BasicConv2d(cin, c7, 1)
        self.branch7x7_2 = BasicConv2d(c7, c7, (1, 7), pad=(0, 3))
        self.branch7x7_3 = BasicConv2d(c7, 192, (7, 1), pad=(3, 0))
        self.branch7x7dbl_1 = BasicConv2d(cin, c7, 1)
        self.branch7x7dbl_2 = BasicConv2d(c7, c7, (7, 1), pad=(3, 0))
        self.branch7x7dbl_3 = BasicConv2d(c7, c7, (1, 7), pad=(0, 3))
        self.branch7x7dbl_4 = BasicConv2d(c7, c7, (7, 1), pad=(3, 0))
        self.branch7x7dbl_5 = BasicConv2d(c7, 192, (1, 7), pad=(0, 3))
        self.branch_pool = BasicConv2d(cin, 192, 1)

    def forward(self, x):
        b1 = self.branch7x7_3(self.branch7x7_2(self.branch7x7_1(x)))
        b2 = self.branch7x7dbl_1(x)
        for conv in (self.branch7x7dbl_2, self.branch7x7dbl_3,
                     self.branch7x7dbl_4, self.branch7x7dbl_5):
            b2 = conv(b2)
        return torch.cat([self.branch1x1(x), b1, b2,
                          self.branch_pool(_avg_pool_same(x))], dim=1)


class MixedD(nn.Module):
    """8x8 downsample: 1x1->3x3/2 | 1x1->1x7->7x1->3x3/2 | max-pool."""

    def __init__(self, cin: int):
        super().__init__()
        self.branch3x3_1 = BasicConv2d(cin, 192, 1)
        self.branch3x3_2 = BasicConv2d(192, 320, 3, stride=2)
        self.branch7x7x3_1 = BasicConv2d(cin, 192, 1)
        self.branch7x7x3_2 = BasicConv2d(192, 192, (1, 7), pad=(0, 3))
        self.branch7x7x3_3 = BasicConv2d(192, 192, (7, 1), pad=(3, 0))
        self.branch7x7x3_4 = BasicConv2d(192, 192, 3, stride=2)

    def forward(self, x):
        b0 = self.branch3x3_2(self.branch3x3_1(x))
        b1 = self.branch7x7x3_1(x)
        for conv in (self.branch7x7x3_2, self.branch7x7x3_3,
                     self.branch7x7x3_4):
            b1 = conv(b1)
        return torch.cat([b0, b1, _max_pool(x)], dim=1)


class MixedE(nn.Module):
    """8x8 module with expanded filter-bank outputs."""

    def __init__(self, cin: int):
        super().__init__()
        self.branch1x1 = BasicConv2d(cin, 320, 1)
        self.branch3x3_1 = BasicConv2d(cin, 384, 1)
        self.branch3x3_2a = BasicConv2d(384, 384, (1, 3), pad=(0, 1))
        self.branch3x3_2b = BasicConv2d(384, 384, (3, 1), pad=(1, 0))
        self.branch3x3dbl_1 = BasicConv2d(cin, 448, 1)
        self.branch3x3dbl_2 = BasicConv2d(448, 384, 3, pad=1)
        self.branch3x3dbl_3a = BasicConv2d(384, 384, (1, 3), pad=(0, 1))
        self.branch3x3dbl_3b = BasicConv2d(384, 384, (3, 1), pad=(1, 0))
        self.branch_pool = BasicConv2d(cin, 192, 1)

    def forward(self, x):
        b1 = self.branch3x3_1(x)
        b1 = torch.cat([self.branch3x3_2a(b1), self.branch3x3_2b(b1)], dim=1)
        b2 = self.branch3x3dbl_2(self.branch3x3dbl_1(x))
        b2 = torch.cat([self.branch3x3dbl_3a(b2), self.branch3x3dbl_3b(b2)],
                       dim=1)
        return torch.cat([self.branch1x1(x), b1, b2,
                          self.branch_pool(_avg_pool_same(x))], dim=1)


class InceptionV3(nn.Module):
    """Inception V3 feature extractor: (N, 299, 299, C) NHWC -> (N, 2048)."""

    MIXED = ("Mixed_5b", "Mixed_5c", "Mixed_5d", "Mixed_6a", "Mixed_6b",
             "Mixed_6c", "Mixed_6d", "Mixed_6e", "Mixed_7a", "Mixed_7b",
             "Mixed_7c")

    def __init__(self, in_channels: int = 3, bn_mode: str = "frozen",
                 remat: bool = False):
        super().__init__()
        self.Conv2d_1a_3x3 = BasicConv2d(in_channels, 32, 3, stride=2)
        self.Conv2d_2a_3x3 = BasicConv2d(32, 32, 3)
        self.Conv2d_2b_3x3 = BasicConv2d(32, 64, 3, pad=1)
        self.Conv2d_3b_1x1 = BasicConv2d(64, 80, 1)
        self.Conv2d_4a_3x3 = BasicConv2d(80, 192, 3)
        self.Mixed_5b = MixedA(192, 32)
        self.Mixed_5c = MixedA(256, 64)
        self.Mixed_5d = MixedA(288, 64)
        self.Mixed_6a = MixedB(288)
        self.Mixed_6b = MixedC(768, 128)
        self.Mixed_6c = MixedC(768, 160)
        self.Mixed_6d = MixedC(768, 160)
        self.Mixed_6e = MixedC(768, 192)
        self.Mixed_7a = MixedD(768)
        self.Mixed_7b = MixedE(1280)
        self.Mixed_7c = MixedE(2048)
        set_bn_mode(self, bn_mode)
        self.remat = remat

    def _stages(self):
        """The network as checkpoint stages: the stem layer by layer (its
        activations are the largest), then each Mixed module."""
        return [self.Conv2d_1a_3x3, self.Conv2d_2a_3x3,
                lambda x: _max_pool(self.Conv2d_2b_3x3(x)),
                self.Conv2d_3b_1x1,
                lambda x: _max_pool(self.Conv2d_4a_3x3(x))] + [
                    getattr(self, name) for name in self.MIXED]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.permute(0, 3, 1, 2)
        for stage in self._stages():
            x = run_stage(stage, x, self.remat)
        return x.mean(dim=(2, 3)).float()
