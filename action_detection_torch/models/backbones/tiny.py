"""TinyConv: a minimal conv backbone for tests (torch port of
``action_detection_tpu/models/backbones/tiny.py``).

Two stride-2 3x3 convs with TF "SAME" padding, each followed by BN and
ReLU, then global average pooling. NHWC in, ``(N, 32)`` out. As in the JAX
TinyConv, BN trains with batch statistics only in ``bn_mode="full"``, and
the convs compute in float32 whatever the model's dtype (flax promotes the
bf16 input to the f32 kernel's type); ``remat`` checkpoints the whole
network as one stage.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .common import BatchNorm2d, run_stage, set_bn_mode

FEATURE_DIM = 32


def _same_pad(size: int, kernel: int, stride: int):
    """TF/flax "SAME" padding (low, high) for one spatial dim."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


class TinyConv(nn.Module):
    def __init__(self, in_channels: int = 3, bn_mode: str = "frozen",
                 remat: bool = False):
        super().__init__()
        self.conv1_7x7_s2 = nn.Conv2d(in_channels, 16, 3, stride=2)
        self.conv1_7x7_s2_bn = BatchNorm2d(16, eps=1e-5)
        self.conv2_3x3 = nn.Conv2d(16, FEATURE_DIM, 3, stride=2)
        self.conv2_3x3_bn = BatchNorm2d(FEATURE_DIM, eps=1e-5)
        set_bn_mode(self, bn_mode, partial=0)
        self.remat = remat

    def _conv_bn(self, name: str, x: torch.Tensor) -> torch.Tensor:
        ph = _same_pad(x.shape[2], 3, 2)
        pw = _same_pad(x.shape[3], 3, 2)
        x = F.pad(x, (pw[0], pw[1], ph[0], ph[1]))
        with torch.autocast(x.device.type, enabled=False):
            y = getattr(self, name)(x.float())
        return F.relu(getattr(self, name + "_bn")(y).to(x.dtype))

    def _net(self, x: torch.Tensor) -> torch.Tensor:
        x = self._conv_bn("conv1_7x7_s2", x.permute(0, 3, 1, 2))
        return self._conv_bn("conv2_3x3", x)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(N, H, W, C) normalized frames -> (N, 32) f32 features."""
        return run_stage(self._net, x, self.remat).mean(dim=(2, 3)).float()
