"""ResNet v1 (18/34/50/101/152) in torch, the reference's torchvision
backbones.

Port of ``action_detection_tpu/models/backbones/resnet.py``. Module names
are torchvision's (``conv1``, ``bn1``, ``layer1.0.conv1``,
``layer1.0.downsample.0`` and ``.1``), so a torchvision or reference
``base_model.*`` state dict loads after a prefix strip alone. The public
forward takes NHWC frames like the JAX package; inside, convs run
NCHW-logical on channels_last memory. Input spec: 224^2, RGB in [0, 1]
normalized by the ImageNet mean and std (``div255``).

The stem's 3x3 s2 max pool (padding 1 on every side) goes through
:func:`~action_detection_torch.ops.pooling.max_pool_2d`, so its backward is
the hand-written kernel A1. Features are the spatial mean of the last
stage: 512-d (basic blocks) or 2048-d (bottlenecks).

Training: ``bn_mode`` (``partial`` trains the stem's ``bn1`` alone, as the
JAX module's ``_bn_train(train, 0)``) and ``remat``, which checkpoints the
stem and each residual block as one stage (``common.run_stage``).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ...ops.pooling import max_pool_2d
from .common import BatchNorm2d, run_stage, set_bn_mode

_STAGES = {
    "resnet18": ("basic", (2, 2, 2, 2)),
    "resnet34": ("basic", (3, 4, 6, 3)),
    "resnet50": ("bottleneck", (3, 4, 6, 3)),
    "resnet101": ("bottleneck", (3, 4, 23, 3)),
    "resnet152": ("bottleneck", (3, 8, 36, 3)),
}

ARCHS = tuple(_STAGES)


def feature_dim(arch: str) -> int:
    block, _ = _STAGES[arch]
    return 512 if block == "basic" else 2048


def _conv(cin: int, cout: int, kernel: int, stride: int = 1) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, kernel, stride, kernel // 2, bias=False)


def _downsample(cin: int, cout: int, stride: int,
                needed: bool) -> Optional[nn.Sequential]:
    """torchvision's ``downsample``: a 1x1 conv (``.0``) and its BN
    (``.1``) on the identity path."""
    if not needed:
        return None
    return nn.Sequential(_conv(cin, cout, 1, stride), BatchNorm2d(cout))


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, cin: int, features: int, stride: int = 1,
                 downsample: bool = False):
        super().__init__()
        self.conv1 = _conv(cin, features, 3, stride)
        self.bn1 = BatchNorm2d(features)
        self.conv2 = _conv(features, features, 3)
        self.bn2 = BatchNorm2d(features)
        self.downsample = _downsample(cin, features, stride, downsample)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = F.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        identity = x if self.downsample is None else self.downsample(x)
        return F.relu(out + identity)


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, cin: int, features: int, stride: int = 1,
                 downsample: bool = False):
        super().__init__()
        self.conv1 = _conv(cin, features, 1)
        self.bn1 = BatchNorm2d(features)
        self.conv2 = _conv(features, features, 3, stride)
        self.bn2 = BatchNorm2d(features)
        self.conv3 = _conv(features, features * 4, 1)
        self.bn3 = BatchNorm2d(features * 4)
        self.downsample = _downsample(cin, features * 4, stride, downsample)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        identity = x if self.downsample is None else self.downsample(x)
        return F.relu(out + identity)


class ResNet(nn.Module):
    """ResNet feature extractor: (N, 224, 224, C) NHWC -> (N, 512 | 2048)."""

    def __init__(self, arch: str = "resnet101", in_channels: int = 3,
                 bn_mode: str = "frozen", remat: bool = False):
        super().__init__()
        if arch not in _STAGES:
            raise ValueError(f"Unknown base model: {arch}")
        kind, stage_sizes = _STAGES[arch]
        block = BasicBlock if kind == "basic" else Bottleneck
        self.conv1 = _conv(in_channels, 64, 7, 2)
        self.bn1 = BatchNorm2d(64)
        cin = 64
        for stage, n_blocks in enumerate(stage_sizes):
            features = 64 * 2 ** stage
            blocks = []
            for b in range(n_blocks):
                stride = 2 if stage > 0 and b == 0 else 1
                # the JAX module's rule (torchvision's inplanes test)
                down = b == 0 and (stride != 1 or stage == 0
                                   and kind == "bottleneck")
                blocks.append(block(cin, features, stride, down))
                cin = features * block.expansion
            setattr(self, f"layer{stage + 1}", nn.Sequential(*blocks))
        self.n_stages = len(stage_sizes)
        set_bn_mode(self, bn_mode)
        self.remat = remat

    def _stem(self, x: torch.Tensor) -> torch.Tensor:
        x = F.relu(self.bn1(self.conv1(x)))
        return max_pool_2d(x.permute(0, 2, 3, 1), 3, 2,
                           ((1, 1), (1, 1))).permute(0, 3, 1, 2)

    def _stages(self):
        """The network as checkpoint stages: the stem, then each residual
        block."""
        return [self._stem] + [blk for i in range(self.n_stages)
                               for blk in getattr(self, f"layer{i + 1}")]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.permute(0, 3, 1, 2)
        for stage in self._stages():
            x = run_stage(stage, x, self.remat)
        return x.mean(dim=(2, 3)).float()
