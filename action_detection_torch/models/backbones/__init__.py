"""Backbone registry: torch feature extractors selectable by name.

Port of ``action_detection_tpu/models/backbones/__init__.py``: every name
its registry builds (BNInception, InceptionV3, TinyConv, ResNet-18/34/50/
101/152, VGG-11/13/16/19 plain and ``_bn``); any other name raises
``ValueError``, as the JAX registry's does.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from .bn_inception import BNInception, FEATURE_DIM as BNINCEPTION_DIM


@dataclasses.dataclass(frozen=True)
class InputSpec:
    """Per-backbone input pipeline facts (crop size, normalization, channel order)."""
    input_size: int
    mean: tuple
    std: tuple
    bgr: bool          # Caffe-ported nets take BGR channel order
    div255: bool       # torchvision-style nets take [0,1] inputs

    @property
    def scale_size(self) -> int:
        return self.input_size * 256 // 224


def get_backbone(name: str, modality: str = "RGB",
                 new_length: Optional[int] = None, bn_mode: str = "frozen",
                 remat: bool = False):
    """Build a backbone module + its feature dim + input spec.

    ``bn_mode`` and ``remat`` are the training options of
    :mod:`.common` (the JAX package's ``bn_mode``; ``--remat``)."""
    if new_length is None:
        new_length = 1 if modality == "RGB" else 5
    if modality in ("RGB", "RGBDiff"):
        in_channels = 3 * new_length
    elif modality == "Flow":
        in_channels = 2 * new_length
    else:
        raise ValueError(f"unknown modality {modality}")

    if name == "BNInception":
        if modality == "Flow":
            spec = InputSpec(224, (128.0,), (1.0,), bgr=False, div255=False)
        else:
            spec = InputSpec(224, (104.0, 117.0, 128.0), (1.0,), bgr=True,
                             div255=False)
        return (BNInception(in_channels, bn_mode, remat), BNINCEPTION_DIM,
                spec)
    if name == "InceptionV3":
        from .inception_v3 import InceptionV3, FEATURE_DIM as IV3_DIM

        if modality == "Flow":
            spec = InputSpec(299, (128.0,), (1.0,), bgr=False, div255=False)
        else:
            spec = InputSpec(299, (104.0, 117.0, 128.0), (1.0,), bgr=True,
                             div255=False)
        return InceptionV3(in_channels, bn_mode, remat), IV3_DIM, spec
    if name == "TinyConv":
        from .tiny import TinyConv, FEATURE_DIM as TINY_DIM

        spec = InputSpec(32, (104.0, 117.0, 128.0) if modality != "Flow"
                         else (128.0,), (1.0,), bgr=(modality != "Flow"),
                         div255=False)
        return TinyConv(in_channels, bn_mode, remat), TINY_DIM, spec
    if name.startswith(("resnet", "vgg")):
        # torchvision's input statistics, shared by both families
        if modality == "Flow":
            spec = InputSpec(224, (0.5,), (0.226,), bgr=False, div255=True)
        else:
            spec = InputSpec(224, (0.485, 0.456, 0.406),
                             (0.229, 0.224, 0.225), bgr=False, div255=True)
        if name.startswith("vgg"):
            from .vgg import VGG, FEATURE_DIM as VGG_DIM

            return VGG(name, in_channels, bn_mode, remat), VGG_DIM, spec
        from .resnet import ResNet, feature_dim

        return (ResNet(name, in_channels, bn_mode, remat), feature_dim(name),
                spec)
    raise ValueError(f"Unknown base model: {name}")
