"""TinyConv: a minimal conv backbone for tests (torch port of
``action_detection_tpu/models/backbones/tiny.py``).

Two stride-2 3x3 convs with TF "SAME" padding, each followed by frozen BN
and ReLU, then global average pooling. NHWC in, ``(N, 32)`` out.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

FEATURE_DIM = 32


def _same_pad(size: int, kernel: int, stride: int):
    """TF/flax "SAME" padding (low, high) for one spatial dim."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


class TinyConv(nn.Module):
    def __init__(self, in_channels: int = 3):
        super().__init__()
        self.conv1_7x7_s2 = nn.Conv2d(in_channels, 16, 3, stride=2)
        self.conv1_7x7_s2_bn = nn.BatchNorm2d(16, eps=1e-5)
        self.conv2_3x3 = nn.Conv2d(16, FEATURE_DIM, 3, stride=2)
        self.conv2_3x3_bn = nn.BatchNorm2d(FEATURE_DIM, eps=1e-5)

    def _conv_bn(self, name: str, x: torch.Tensor) -> torch.Tensor:
        ph = _same_pad(x.shape[2], 3, 2)
        pw = _same_pad(x.shape[3], 3, 2)
        x = F.pad(x, (pw[0], pw[1], ph[0], ph[1]))
        return F.relu(getattr(self, name + "_bn")(getattr(self, name)(x)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(N, H, W, C) normalized frames -> (N, 32) f32 features."""
        x = x.permute(0, 3, 1, 2)
        x = self._conv_bn("conv1_7x7_s2", x)
        x = self._conv_bn("conv2_3x3", x)
        return x.mean(dim=(2, 3))
