"""VGG 11/13/16/19, plain and ``_bn``, in torch, ending at fc7 (4096-d).

Port of ``action_detection_tpu/models/backbones/vgg.py``. Module names are
torchvision's: ``features.<idx>`` (a ReLU or a pool holds each index it
has in torchvision, so conv and BN indices match), ``classifier.0`` (fc6)
and ``classifier.3`` (fc7); the 1000-way ``classifier.6`` is not built. A
torchvision or reference state dict loads after a prefix strip alone. The
public forward takes NHWC frames; inside, convs run NCHW-logical on
channels_last memory.

* The 2x2 s2 max pools go through
  :func:`~action_detection_torch.ops.pooling.max_pool_2d`, so their
  backward is the hand-written kernel A1.
* Before the classifier the grid is average-pooled down to 7x7, as
  torchvision's adaptive pool does when 7 divides it; other grids raise.
* fc6 takes the grid flattened in CHW order, torch's ``(N, C*7*7)``.
* fc6 and fc7 run in float32 (the JAX module's Dense layers do, whatever
  its dtype), each followed by ReLU and ``Dropout(classifier_dropout)``,
  active in train mode, its mask drawn from the generator the forward is
  given.

Training: ``bn_mode`` (``partial`` trains the first BN of a ``_bn`` net) and
``remat``, which checkpoints each block of convs up to and including its
pool as one stage (the classifier, with its dropout, is never recomputed).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ...ops.pooling import max_pool_2d
from .common import BatchNorm2d, dropout, run_stage, set_bn_mode

FEATURE_DIM = 4096

# torchvision's configs: A=vgg11, B=vgg13, D=vgg16, E=vgg19
_CFGS = {
    "vgg11": (64, "M", 128, "M", 256, 256, "M", 512, 512, "M", 512, 512, "M"),
    "vgg13": (64, 64, "M", 128, 128, "M", 256, 256, "M", 512, 512, "M",
              512, 512, "M"),
    "vgg16": (64, 64, "M", 128, 128, "M", 256, 256, 256, "M", 512, 512, 512,
              "M", 512, 512, 512, "M"),
    "vgg19": (64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M",
              512, 512, 512, 512, "M", 512, 512, 512, 512, "M"),
}

ARCHS = tuple(_CFGS) + tuple(f"{a}_bn" for a in _CFGS)


def arch_cfg(arch: str) -> Tuple[Tuple, bool]:
    """``(torchvision config, with BN)`` of a VGG name; unknown names raise
    ``ValueError``."""
    base = arch[:-3] if arch.endswith("_bn") else arch
    if base not in _CFGS:
        raise ValueError(f"Unknown base model: {arch}")
    return _CFGS[base], arch.endswith("_bn")


class MaxPool2x2(nn.Module):
    """The 2x2 s2 unpadded max pool of an NCHW-logical tensor (A1 as its
    backward)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return max_pool_2d(x.permute(0, 2, 3, 1), 2, 2,
                           ((0, 0), (0, 0))).permute(0, 3, 1, 2)


class VGG(nn.Module):
    """VGG feature extractor: (N, 224, 224, C) NHWC -> (N, 4096) fc7."""

    def __init__(self, arch: str = "vgg16", in_channels: int = 3,
                 bn_mode: str = "frozen", remat: bool = False,
                 classifier_dropout: float = 0.5):
        super().__init__()
        cfg, with_bn = arch_cfg(arch)
        layers: List[nn.Module] = []
        cin = in_channels
        for v in cfg:
            if v == "M":
                layers.append(MaxPool2x2())
                continue
            layers.append(nn.Conv2d(cin, v, 3, padding=1))
            if with_bn:
                layers.append(BatchNorm2d(v))
            layers.append(nn.ReLU())
            cin = v
        self.features = nn.Sequential(*layers)
        self.classifier = nn.Sequential(
            nn.Linear(512 * 7 * 7, 4096), nn.ReLU(), nn.Identity(),
            nn.Linear(4096, 4096), nn.ReLU(), nn.Identity())
        self.classifier_dropout = classifier_dropout
        set_bn_mode(self, bn_mode)
        self.remat = remat

    def _blocks(self):
        """``features`` cut after each pool: the checkpoint stages."""
        blocks, start = [], 0
        for i, m in enumerate(self.features):
            if isinstance(m, MaxPool2x2):
                blocks.append(self.features[start:i + 1])
                start = i + 1
        return blocks

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        x = x.permute(0, 3, 1, 2)
        for block in self._blocks():
            x = run_stage(block, x, self.remat)
        h, w = x.shape[2], x.shape[3]
        if (h, w) != (7, 7):
            if h % 7 or w % 7:
                raise ValueError(f"VGG input must give a 7-divisible "
                                 f"feature grid, got {h}x{w}")
            x = F.avg_pool2d(x, (h // 7, w // 7))
        # CHW order, torch's fc6 layout
        x = x.reshape(x.shape[0], -1).float()
        rate = self.classifier_dropout if self.training else 0.0
        with torch.autocast(x.device.type, enabled=False):
            for fc in (self.classifier[0], self.classifier[3]):
                x = dropout(F.relu(fc(x)), rate, generator)
        return x
